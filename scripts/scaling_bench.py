"""Weak-scaling efficiency of the sharded NeRF train step (BASELINE's
">85% rays/s scaling 1 chip -> N" target, BASELINE.md:28).

Runs the SAME shard_map train step on a 1-device mesh and an N-device mesh
with rays scaled proportionally (weak scaling: fixed rays/device), and
reports rays/s and efficiency = (rays_N / rays_1) / N.

On several GPUs this is the BASELINE measurement; on one it degenerates
to N=1.  On CPU it exercises the harness over the virtual device mesh
(xla_force_host_platform_device_count) — a correctness check of the
measurement path, not a hardware number (host cores are shared, so CPU
"efficiency" is meaningless and the report says so).

Usage:
    python scripts/scaling_bench.py --rays-per-dev 8192          # GPUs
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/scaling_bench.py --rays-per-dev 4096
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from bench import median_call_s


def measure(n_dev, rays_per_dev, cfg, outer):
    import jax
    import jax.numpy as jnp
    import optax

    from lomanerf_tpu.core import init_mlp, sample_along_rays
    from lomanerf_tpu.parallel import RayBatch, make_mesh, make_train_step, \
        shard_batch

    mesh = make_mesh(dp=n_dev, tp=1, devices=jax.devices()[:n_dev])
    params = init_mlp(jax.random.PRNGKey(0), cfg.in_channels,
                      cfg.out_channels, cfg.num_layers, cfg.filter_size)
    opt = optax.adam(5e-4)
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt, mesh, params, opt_state, tp=False,
                           donate=False, uniform_depths=True)
    n = rays_per_dev * n_dev
    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.standard_normal((n, 3)), jnp.float32)
    d = jnp.asarray(rng.standard_normal((n, 3)), jnp.float32)
    _, t, dists = sample_along_rays(o, d, cfg.near, cfg.far, cfg.num_samples)
    tg = jnp.asarray(rng.random((n, 3)), jnp.float32)
    batch = shard_batch(mesh, RayBatch(o, d, t, dists, tg))
    return n / median_call_s(lambda: step(params, opt_state, batch), outer)


def measure_render(n_dev, rays_per_dev, cfg, outer, chunk=None):
    """Weak-scaling of the mesh-sharded RENDER step (BASELINE config 5:
    rays sharded across the mesh, frame reassembled by all_gather —
    parallel/render_step.py)."""
    import jax

    from lomanerf_tpu.core import init_mlp
    from lomanerf_tpu.parallel import data_mesh, make_render_step, \
        shard_ray_chunks

    mesh = data_mesh(jax.devices()[:n_dev])
    params = init_mlp(jax.random.PRNGKey(0), cfg.in_channels,
                      cfg.out_channels, cfg.num_layers, cfg.filter_size,
                      init=cfg.init)
    n = rays_per_dev * n_dev
    chunk = chunk or max(rays_per_dev // 2, 128)
    rng = np.random.default_rng(0)
    oc, dc, _ = shard_ray_chunks(
        mesh, rng.standard_normal((n, 3)), rng.standard_normal((n, 3)),
        chunk)
    n_pad = oc.shape[0] * chunk
    render = make_render_step(cfg, mesh)
    return n_pad / median_call_s(lambda: render(params, oc, dc), outer)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays-per-dev", type=int, default=8192)
    ap.add_argument("--outer", type=int, default=10,
                    help="timed calls per mesh size (median reported)")
    ap.add_argument("--rung", default="train", choices=["train", "render"],
                    help="train step weak-scaling, or the mesh-sharded "
                         "render (BASELINE config 5)")
    args = ap.parse_args()

    import jax

    from lomanerf_tpu.models import NeRFConfig
    from lomanerf_tpu.utils import enable_compile_cache

    enable_compile_cache()

    cfg = NeRFConfig.small() if args.rung == "train" else NeRFConfig.full()
    fn = measure if args.rung == "train" else measure_render
    n_dev = jax.device_count()
    platform = jax.devices()[0].platform
    r1 = fn(1, args.rays_per_dev, cfg, args.outer)
    if n_dev == 1:
        print(json.dumps({"rung": args.rung, "devices": 1,
                          "rays_per_s": round(r1, 1),
                          "note": "single device; scaling needs N>1"}))
        return
    rN = fn(n_dev, args.rays_per_dev, cfg, args.outer)
    eff = (rN / r1) / n_dev
    print(json.dumps({
        "rung": args.rung,
        "devices": n_dev,
        "rays_per_s_1dev": round(r1, 1),
        "rays_per_s_Ndev": round(rN, 1),
        "weak_scaling_efficiency": round(eff, 3),
        "hardware_number": platform == "gpu",
        "note": ("" if platform == "gpu" else
                 "virtual CPU mesh shares host cores; harness check only"),
    }))


if __name__ == "__main__":
    main()
