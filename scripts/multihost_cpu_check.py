"""Real 2-process multi-host check on CPU (no cluster needed).

Launches N worker processes that form a jax.distributed cluster (CPU
backend, 4 virtual devices each), build the global data mesh, assemble a
sharded global batch from DISJOINT per-host ray slices via
``shard_batch`` -> ``host_local_batch_to_global``
(jax.make_array_from_process_local_data), and run one sharded NeRF train
step.  Process 0 additionally runs the same step single-host over the full
batch and asserts the multi-host loss and updated params match — proving
the per-host placement path end-to-end, which the in-suite tests can only
exercise in the 1-process degenerate case.

This is the correctness half of BASELINE's ">85% scaling 1 chip -> N>=2
hosts" that CAN be checked without hardware (the perf half needs real
devices).  Run: ``python scripts/multihost_cpu_check.py`` (launcher mode);
process 0 prints its result as JSON after ``MULTIHOST_OK``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROC = 2
LOCAL_DEVICES = 4
N_RAYS_PER_HOST = 64


def worker(proc_id: int, nproc: int, coord: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp
    import optax

    sys.path.insert(0, REPO)
    from lomanerf_tpu.core import init_mlp, sample_along_rays
    from lomanerf_tpu.models import NeRFConfig
    from lomanerf_tpu.parallel import (
        RayBatch, initialize_multihost, is_primary, make_train_step,
        shard_batch,
    )
    from lomanerf_tpu.parallel.mesh import data_mesh
    from lomanerf_tpu.train.steps import make_single_chip_train_step

    initialize_multihost(coordinator=coord, num_processes=nproc,
                         process_id=proc_id)
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == nproc * LOCAL_DEVICES
    assert len(jax.local_devices()) == LOCAL_DEVICES

    cfg = NeRFConfig(num_samples=8)
    params = init_mlp(jax.random.PRNGKey(5), cfg.in_channels, 4,
                      cfg.num_layers, cfg.filter_size)
    opt = optax.sgd(1e-2)
    opt_state = opt.init(params)

    # the GLOBAL batch is seeded; each host takes its DISJOINT row slice
    # (the driver's per-host RNG partition, train_nerf.py)
    rng = np.random.default_rng(215)
    n_global = nproc * N_RAYS_PER_HOST
    o_g = rng.standard_normal((n_global, 3)).astype(np.float32)
    d_g = rng.standard_normal((n_global, 3)).astype(np.float32)
    tgt_g = rng.random((n_global, 3)).astype(np.float32)
    lo = proc_id * N_RAYS_PER_HOST
    o, d, tgt = (x[lo:lo + N_RAYS_PER_HOST] for x in (o_g, d_g, tgt_g))
    _, t_vals, dists = sample_along_rays(
        jnp.asarray(o), jnp.asarray(d), cfg.near, cfg.far, cfg.num_samples)

    mesh = data_mesh()
    step = make_train_step(cfg, opt, mesh, params, opt_state, donate=False)
    local = RayBatch(jnp.asarray(o), jnp.asarray(d), t_vals, dists,
                     jnp.asarray(tgt))
    batch = shard_batch(mesh, local)
    assert batch.origins.shape[0] == n_global  # global leading dim
    new_params, new_opt_state, loss = step(params, opt_state, batch)
    loss = float(loss)
    assert np.isfinite(loss)

    # mesh-sharded RENDER across the 2-process mesh (BASELINE config 5:
    # "800x800 renders, rays sharded across N>=2 hosts"): ray chunks
    # sharded over all global devices, frame reassembled by all_gather —
    # every process then holds the replicated pixels
    # (parallel/render_step.py)
    from lomanerf_tpu.parallel import make_render_step, shard_ray_chunks

    render = make_render_step(cfg, mesh)
    oc, dc, n_r = shard_ray_chunks(mesh, o_g, d_g, chunk=4)
    cols = render(params, oc, dc)
    cols_np = np.asarray(jax.device_get(cols))[:n_r]

    if is_primary():
        # single-host oracle over the FULL global batch
        sstep = make_single_chip_train_step(cfg, opt, donate=False)
        _, gt, gdists = sample_along_rays(
            jnp.asarray(o_g), jnp.asarray(d_g), cfg.near, cfg.far,
            cfg.num_samples)
        ref_params, _, ref_loss = sstep(params, opt_state, jnp.asarray(o_g),
                                        jnp.asarray(d_g), gt, gdists,
                                        jnp.asarray(tgt_g))
        np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
        for a, b in zip(jax.tree.leaves(new_params),
                        jax.tree.leaves(ref_params)):
            np.testing.assert_allclose(
                np.asarray(jax.device_get(a)), np.asarray(b),
                rtol=1e-5, atol=1e-6)
        # single-host render oracle over the full ray set
        from lomanerf_tpu.models.nerf import render_chunk

        ref_cols = render_chunk(cfg, params, jnp.asarray(o_g),
                                jnp.asarray(d_g))
        np.testing.assert_allclose(cols_np, np.asarray(ref_cols),
                                   rtol=1e-5, atol=1e-6)
        out = {
            "processes": nproc,
            "devices_global": jax.device_count(),
            "devices_local": LOCAL_DEVICES,
            "rays_global": n_global,
            "loss_multihost": loss,
            "loss_singlehost": float(ref_loss),
            "params_allclose": True,
            "render_allclose": True,
        }
        print("MULTIHOST_OK", json.dumps(out))


def main() -> None:
    if len(sys.argv) > 1:  # worker mode: <proc_id> <nproc> <coordinator>
        worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
        return
    port = 13000 + os.getpid() % 2000
    coord = f"localhost:{port}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "").replace(
            "--xla_force_host_platform_device_count=8", "").strip()
        + f" --xla_force_host_platform_device_count={LOCAL_DEVICES}"
    ).strip()
    env.pop("JAX_COORDINATOR_ADDRESS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(i),
             str(N_PROC), coord],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(N_PROC)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    ok = all(p.returncode == 0 for p in procs) and "MULTIHOST_OK" in outs[0]
    for i, o in enumerate(outs):
        print(f"--- process {i} (rc={procs[i].returncode}) ---")
        print(o)
    if not ok:
        sys.exit(1)
    print("2-process multi-host check PASSED")


if __name__ == "__main__":
    main()
