"""Sharding tests on the virtual 8-device CPU mesh.

Tier-3 analog of the reference's parallel reduction tests
(hw_tests/hw3/test.py:452-515, atomic-add fan-in vs numpy): here the psum'd
data-parallel gradients must equal the single-device gradients, and the
tensor-parallel MLP must match the replicated MLP bitwise-closely.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from lomanerf_tpu.core import init_mlp, mlp_apply, sample_along_rays
from lomanerf_tpu.core.pipeline import nerf_loss_rays
from lomanerf_tpu.models import NeRFConfig
from lomanerf_tpu.parallel import (
    RayBatch,
    make_mesh,
    make_train_step,
    shard_tp_params,
    tp_mlp_apply,
    tp_param_specs,
)

from jax import shard_map


def _ray_batch(rng, n, s, cfg):
    o = jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32))
    d = jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32))
    _, t, dists = sample_along_rays(o, d, cfg.near, cfg.far, s)
    target = jnp.asarray(rng.random((n, 3)).astype(np.float32))
    return RayBatch(o, d, t, dists, target)


def test_dp_train_step_matches_single_device(rng):
    cfg = NeRFConfig.small()
    mesh = make_mesh(dp=8, tp=1, axis_names=("data", "model"))
    params = init_mlp(jax.random.PRNGKey(0), cfg.in_channels, 4, cfg.num_layers,
                      cfg.filter_size)
    opt = optax.sgd(1e-3)
    opt_state = opt.init(params)
    batch = _ray_batch(rng, 32, cfg.num_samples, cfg)

    step = make_train_step(cfg, opt, mesh, params, opt_state, donate=False,
                           uniform_depths=True)
    new_params, _, loss = step(params, opt_state, batch)

    # single-device reference
    loss_ref, grads_ref = jax.value_and_grad(
        lambda p: nerf_loss_rays(
            p, batch.origins, batch.directions, batch.t_vals, batch.dists,
            batch.target, num_functions=cfg.num_encoding_functions, mode=cfg.mode,
        )
    )(params)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    expect = jax.tree.map(lambda p, g: p - 1e-3 * g, params, grads_ref)
    for a, b in zip(jax.tree.leaves(new_params), jax.tree.leaves(expect)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_tp_mlp_matches_replicated(rng):
    """4-layer width-32 MLP, tp=4: sharded forward == replicated forward."""
    tp = 4
    mesh = make_mesh(dp=2, tp=tp, axis_names=("data", "model"))
    params = init_mlp(jax.random.PRNGKey(1), 33, 4, num_layers=4, filter_size=32)
    x = jnp.asarray(rng.standard_normal((16, 33)).astype(np.float32))

    full = mlp_apply(params, x, head="rgba")

    local = [shard_tp_params(params, 4, tp, i) for i in range(tp)]
    # stack shards into global arrays laid out for tp_param_specs
    p_spec = tp_param_specs(4)

    def stack(i_layer, which):
        shards = [l[which][i_layer] for l in local]
        axis = 1 if (i_layer % 2 == 0 and which == "w") else 0
        if which == "b" and i_layer % 2 == 1:
            return local[0][which][i_layer]  # replicated bias
        return jnp.concatenate(shards, axis=axis)

    gparams = {
        "w": [stack(i, "w") for i in range(4)],
        "b": [stack(i, "b") for i in range(4)],
    }
    # sanity: reassembled == original
    for a, b in zip(jax.tree.leaves(gparams), jax.tree.leaves(params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))

    fn = shard_map(
        lambda p, xx: tp_mlp_apply(p, xx, head="rgba"),
        mesh=mesh,
        in_specs=(p_spec, P()),
        out_specs=P(),
        check_vma=False,
    )
    out = fn(gparams, x)
    np.testing.assert_allclose(np.asarray(out), np.asarray(full), rtol=1e-5,
                               atol=1e-6)


def test_tp_odd_layers_all_gather_tail(rng):
    """3 layers ends column-parallel; the all-gather tail must still match."""
    tp = 2
    mesh = make_mesh(dp=4, tp=tp, axis_names=("data", "model"))
    params = init_mlp(jax.random.PRNGKey(2), 33, 4, num_layers=3, filter_size=30)
    x = jnp.asarray(rng.standard_normal((8, 33)).astype(np.float32))
    full = mlp_apply(params, x, head="rgba")
    p_spec = tp_param_specs(3)
    fn = shard_map(
        lambda p, xx: tp_mlp_apply(p, xx, head="rgba"),
        mesh=mesh,
        in_specs=(p_spec, P()),
        out_specs=P(),
        check_vma=False,
    )
    out = fn(params, x)  # jit+shard_map shards the params per spec
    np.testing.assert_allclose(np.asarray(out), np.asarray(full), rtol=1e-5,
                               atol=1e-6)


def test_mesh_sharded_render_matches_single_device(rng):
    """BASELINE config 5's render path: the mesh-sharded full-image render
    (chunks sharded over 8 devices, frame reassembled by tiled all_gather,
    parallel/render_step.py) must reproduce the single-device chunked
    render pixel-for-pixel."""
    from lomanerf_tpu.models import NeRFModel
    from lomanerf_tpu.parallel import make_render_step, shard_ray_chunks

    cfg = NeRFConfig(num_layers=2, filter_size=8, num_samples=4)
    mesh = make_mesh(dp=8, tp=1, axis_names=("data", "model"))
    model = NeRFModel(cfg)
    params = model.init(jax.random.PRNGKey(7))
    from lomanerf_tpu.core import normalized_intrinsics
    from lomanerf_tpu.data import sphere_poses

    K = normalized_intrinsics(1.1)
    pose = jnp.asarray(sphere_poses(1, radius=4.0)[0])

    single = model.render_image(params, K, pose, img_size=16, chunk=32)
    sharded = model.render_image(params, K, pose, img_size=16, chunk=32,
                                 mesh=mesh)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single),
                               rtol=1e-6, atol=1e-6)

    # the low-level step: ragged ray count (not a multiple of chunk*n_dev)
    # pads, renders, and reassembles in global ray order
    step = make_render_step(cfg, mesh)
    o = rng.standard_normal((37, 3)).astype(np.float32)
    d = rng.standard_normal((37, 3)).astype(np.float32)
    oc, dc, n = shard_ray_chunks(mesh, o, d, chunk=2)
    assert n == 37 and oc.shape[0] % 8 == 0
    cols = step(params, oc, dc)
    from lomanerf_tpu.models.nerf import render_chunk

    ref = render_chunk(cfg, params, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_allclose(np.asarray(cols[:n]), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_host_local_batch_to_global(rng):
    """The multi-host batch placement helper: on a 1-process mesh the
    assembled global arrays equal the local batch and carry the ray
    sharding (P('data')); on N processes the same call stitches per-host
    slices (jax.make_array_from_process_local_data semantics)."""
    from lomanerf_tpu.parallel import host_local_batch_to_global
    from lomanerf_tpu.parallel.mesh import data_mesh, ray_sharding

    cfg = NeRFConfig(num_samples=8)
    mesh = data_mesh()
    batch = _ray_batch(rng, 16, cfg.num_samples, cfg)
    g = host_local_batch_to_global(mesh, batch)
    np.testing.assert_array_equal(np.asarray(g.origins),
                                  np.asarray(batch.origins))
    np.testing.assert_array_equal(np.asarray(g.target),
                                  np.asarray(batch.target))
    assert g.origins.sharding == ray_sharding(mesh)
    # uniform (S,) depths are replicated, not ray-sharded
    from lomanerf_tpu.parallel.mesh import replicated
    assert g.t_vals.sharding == replicated(mesh)


def test_shard_batch_routes_to_process_local_on_multihost(rng, monkeypatch):
    """shard_batch must use the process-local global-array assembly when
    jax.process_count() > 1 (docs/scaling.md step 2)."""
    import lomanerf_tpu.parallel.mesh as mesh_mod

    cfg = NeRFConfig(num_samples=8)
    mesh = mesh_mod.data_mesh()
    batch = _ray_batch(rng, 16, cfg.num_samples, cfg)
    hits = []
    monkeypatch.setattr(
        mesh_mod, "host_local_batch_to_global",
        lambda m, b, axis="data": hits.append(axis) or b,
    )
    monkeypatch.setattr(mesh_mod.jax, "process_count", lambda: 2)
    mesh_mod.shard_batch(mesh, batch)
    assert hits == ["data"]


def test_metrics_logger_primary_only(tmp_path, monkeypatch):
    """Only process 0 writes metrics (docs/scaling.md step 4)."""
    from lomanerf_tpu.train.logging_utils import MetricsLogger

    monkeypatch.setattr(jax, "process_index", lambda: 1)
    log1 = MetricsLogger(str(tmp_path / "h1"))
    log1.log(0, loss=1.0)
    log1.close()
    assert not (tmp_path / "h1" / "metrics.jsonl").exists()

    monkeypatch.setattr(jax, "process_index", lambda: 0)
    log0 = MetricsLogger(str(tmp_path / "h0"))
    log0.log(0, loss=1.0)
    log0.close()
    assert (tmp_path / "h0" / "metrics.jsonl").exists()


def test_mirror_spec_chained_optimizer(rng):
    """Opt-state sharding for nested/chained optimizers: an optax.chain
    with TWO scale_by_adam states (colliding state paths) plus empty and
    scalar states must get param specs on every moment subtree and P() on
    counts — and the dp x tp train step must actually run with it."""
    from lomanerf_tpu.parallel.train_step import state_specs

    cfg = NeRFConfig(num_layers=4, filter_size=32, num_samples=8)
    params = init_mlp(jax.random.PRNGKey(9), cfg.in_channels, 4,
                      cfg.num_layers, cfg.filter_size)
    opt = optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.scale_by_adam(),
        optax.scale_by_adam(b1=0.95),
        optax.scale(-5e-3),
    )
    opt_state = opt.init(params)
    p_spec, o_spec = state_specs(cfg, params, opt_state, tp=True)
    # both adam states mirror the param specs; counts are replicated
    for i in (1, 2):
        assert o_spec[i].mu == p_spec
        assert o_spec[i].nu == p_spec
        assert o_spec[i].count == P()

    mesh = make_mesh(dp=2, tp=4, axis_names=("data", "model"))
    batch = _ray_batch(rng, 16, cfg.num_samples, cfg)
    step = make_train_step(cfg, opt, mesh, params, opt_state, tp=True,
                           donate=False, uniform_depths=True)
    losses = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_dp_tp_train_step_runs_and_improves(rng):
    """Full dp=2 x tp=4 train step: loss decreases over a few iterations."""
    cfg = NeRFConfig(num_layers=4, filter_size=32, num_samples=8)
    mesh = make_mesh(dp=2, tp=4, axis_names=("data", "model"))
    params = init_mlp(jax.random.PRNGKey(3), cfg.in_channels, 4, cfg.num_layers,
                      cfg.filter_size)
    opt = optax.adam(5e-3)
    opt_state = opt.init(params)
    batch = _ray_batch(rng, 16, cfg.num_samples, cfg)
    step = make_train_step(cfg, opt, mesh, params, opt_state, tp=True,
                           donate=False, uniform_depths=True)
    losses = []
    for _ in range(5):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_two_process_multihost_cpu_end_to_end():
    """Real 2-process multi-host: launches scripts/multihost_cpu_check.py,
    which forms a jax.distributed CPU cluster (2 processes x 4 devices),
    assembles a global batch from disjoint per-host slices through
    shard_batch -> host_local_batch_to_global, runs one sharded train step,
    and asserts loss/params match the single-host oracle.  This covers the
    process_count() > 1 placement path the in-suite tests cannot reach
    (BASELINE's 1 chip -> N>=2 hosts correctness half)."""
    import os
    import subprocess
    import sys

    script = os.path.join(os.path.dirname(__file__), "..", "scripts",
                          "multihost_cpu_check.py")
    r = subprocess.run(
        [sys.executable, script], capture_output=True, text=True,
        timeout=280,
    )
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "2-process multi-host check PASSED" in r.stdout


@pytest.mark.parametrize("dp,tp,layers", [(8, 1, 4), (4, 2, 4), (2, 4, 4),
                                          (4, 2, 3)])
def test_train_step_grads_match_single_device(rng, dp, tp, layers):
    """The sharded step's gradients equal one device's, for data parallel
    and dp x tp meshes (3 layers: the all-gather tail).  SGD at lr 1 turns
    the updated params back into the gradients."""
    from lomanerf_tpu.train.steps import nerf_loss_fn

    cfg = NeRFConfig(num_layers=layers, filter_size=32, num_samples=8)
    mesh = make_mesh(dp=dp, tp=tp, axis_names=("data", "model"))
    params = init_mlp(jax.random.PRNGKey(11), cfg.in_channels, 4,
                      cfg.num_layers, cfg.filter_size, init="nerf")
    opt = optax.sgd(1.0)
    opt_state = opt.init(params)
    batch = _ray_batch(rng, 32, cfg.num_samples, cfg)
    step = make_train_step(cfg, opt, mesh, params, opt_state, tp=tp > 1,
                           donate=False, uniform_depths=True)
    new_params, _, loss = step(params, opt_state, batch)
    loss_1, grads_1 = jax.value_and_grad(nerf_loss_fn)(params, *batch, cfg)
    np.testing.assert_allclose(float(loss), float(loss_1), rtol=1e-5)
    for p, q, g in zip(jax.tree.leaves(params), jax.tree.leaves(new_params),
                       jax.tree.leaves(grads_1)):
        np.testing.assert_allclose(np.asarray(p) - np.asarray(q),
                                   np.asarray(g), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_rays", [5, 20])
def test_sharded_render_fewer_rays_than_chunks(rng, n_rays):
    """Fewer rays than chunk x devices: padding chunks on every device,
    real rays back in order."""
    from lomanerf_tpu.models.nerf import render_chunk
    from lomanerf_tpu.parallel import make_render_step, shard_ray_chunks

    cfg = NeRFConfig(num_layers=2, filter_size=8, num_samples=4)
    mesh = make_mesh(dp=8, tp=1, axis_names=("data", "model"))
    params = init_mlp(jax.random.PRNGKey(3), cfg.in_channels, 4,
                      cfg.num_layers, cfg.filter_size)
    o = rng.standard_normal((n_rays, 3)).astype(np.float32)
    d = rng.standard_normal((n_rays, 3)).astype(np.float32)
    oc, dc, n = shard_ray_chunks(mesh, o, d, chunk=4)
    assert n == n_rays and oc.shape == (8, 4, 3)
    assert {sh.device for sh in oc.addressable_shards} == set(jax.devices())
    cols = make_render_step(cfg, mesh)(params, oc, dc)
    assert cols.shape == (32, 3)
    ref = render_chunk(cfg, params, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_allclose(np.asarray(cols[:n]), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
