"""Smoke test of the system on NVIDIA GPUs, through its user entry points.

Run from the root of a checkout:

    python chip_smoke.py           # one GPU
    python chip_smoke.py --multi   # four GPUs: the multi-device paths only

One GPU: every preset's and both image fields' train loss, gradients and
render against the exact fp32 reference computed on the host CPU in this
process; the flagship ``train_nerf --preset full`` with an 800x800 eval
render; ``fit_image`` at 1024x1024; one DSL program forward and reverse.
``--multi``: the flagship train step at dp=4 and at dp=2 x tp=2, and the
sharded 800x800 render, each against the same work on one GPU.

Exits non-zero, with no result line, if JAX finds no GPU or any phase
fails.  The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "smoke_out")  # git-ignored

SINGLE_PHASES = ("parity", "train_nerf", "fit_image", "dsl")
MULTI_PHASES = ("multi_dp", "multi_dp_tp", "multi_render")
MULTI_DEVICES = 4

# the oracle-parity tolerances (tests/test_parity_oracle.py)
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 3e-4, 3e-5
# bf16 operands carry 8 significant bits (relative rounding 2^-9 ~ 2e-3)
# into each of the flagship's 8 layers, forward and backward; fp32
# accumulation keeps the sums themselves exact to ~1e-7.  So elementwise
# parity is out of reach, and the bound is on aggregates.
BF16_BOUNDS = {"loss_rel": 2e-3, "grad_norm_rel": 2e-2, "grad_cos": 0.999,
               "color_abs": 3e-2}
# the same step or frame on 4 GPUs against 1: only the order of the fp32
# sums differs (per-shard sums plus psum, other GEMM tilings), which can
# move a bf16 rounding of an activation by one step
MULTI_BOUNDS = {"loss_rel": 1e-4, "grad_rel": 1e-3, "color_abs": 3e-2,
                "color_mean_abs": 1e-4}

PARITY_RAYS = 512
PARITY_PIXELS = 4096
RAYS_PER_STEP = 4096  # the flagship step, per device under --multi
EVAL_SIZE = 800  # the production frame
FIT_SIZE = 1024  # the hi-res image field


def phases(multi: bool) -> tuple:
    return MULTI_PHASES if multi else SINGLE_PHASES


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def require_gpu(devices):
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU: JAX found {devices[0].platform}")


def _flat(tree) -> np.ndarray:
    import jax

    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in jax.tree.leaves(tree)])


def compare_parity(got_loss, want_loss, got_grads, want_grads, got_pred,
                   want_pred, precision: str):
    """(ok, report): the GPU's loss, gradients and prediction against the
    fp32 reference, held to the parity tolerances, or to BF16_BOUNDS for
    "bf16"."""
    g, w = _flat(got_grads), _flat(want_grads)
    p, q = np.asarray(got_pred, np.float64), np.asarray(want_pred,
                                                         np.float64)
    loss_rel = abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))
    grad_abs = float(np.max(np.abs(g - w)))
    grad_rel = grad_abs / float(np.max(np.abs(w)))
    color_abs = float(np.max(np.abs(p - q)))
    report = (f"loss rel err {loss_rel:.3e}, grad max abs err {grad_abs:.3e}"
              f" (rel to max {grad_rel:.3e}), color max abs err "
              f"{color_abs:.3e}")
    if precision == "bf16":
        norm_rel = abs(np.linalg.norm(g) - np.linalg.norm(w)) / \
            np.linalg.norm(w)
        cos = float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))
        ok = (loss_rel <= BF16_BOUNDS["loss_rel"]
              and norm_rel <= BF16_BOUNDS["grad_norm_rel"]
              and cos >= BF16_BOUNDS["grad_cos"]
              and color_abs <= BF16_BOUNDS["color_abs"])
        report += (f", grad norm rel err {norm_rel:.3e}, grad cosine "
                   f"{cos:.7f}; tolerance {BF16_BOUNDS}")
    else:
        ratio = max(
            float(np.max(np.abs(g - w) / (GRAD_ATOL + GRAD_RTOL * np.abs(w)))),
            float(np.max(np.abs(p - q) / (GRAD_ATOL + GRAD_RTOL * np.abs(q)))))
        ok = loss_rel <= LOSS_RTOL and ratio <= 1.0
        report += (f", worst err/tolerance {ratio:.3f}; tolerance loss rtol "
                   f"{LOSS_RTOL}, grads and colors rtol {GRAD_RTOL} atol "
                   f"{GRAD_ATOL}")
    return ok, report


def _parity_cases():
    from lomanerf_tpu.models import ImageFieldConfig, NeRFConfig

    return [(name, NeRFConfig.preset(name))
            for name in ("small", "single64", "full")] + [
        ("fit", ImageFieldConfig.small()),
        ("fit-hires", ImageFieldConfig.hires())]


def _parity_inputs(cfg, rng):
    import jax.numpy as jnp

    from lomanerf_tpu.core import sample_along_rays

    if hasattr(cfg, "num_samples"):
        n = PARITY_RAYS
        o = rng.standard_normal((n, 3)).astype(np.float32) * 0.3
        d = rng.standard_normal((n, 3)).astype(np.float32)
        _, t, dists = sample_along_rays(jnp.asarray(o), jnp.asarray(d),
                                        cfg.near, cfg.far, cfg.num_samples)
        tgt = rng.random((n, 3)).astype(np.float32)
        return (o, d, np.asarray(t), np.asarray(dists), tgt)
    n = PARITY_PIXELS
    return (rng.random((n, 2)).astype(np.float32),
            rng.random((n, 3)).astype(np.float32))


def _loss_grads_pred(cfg, params, args):
    """One step's loss and gradients, and one render, jitted on the
    device the inputs live on."""
    import jax

    from lomanerf_tpu.models import ImageFieldModel, NeRFModel
    from lomanerf_tpu.train.steps import image_fit_loss_fn, nerf_loss_fn

    if hasattr(cfg, "num_samples"):
        model = NeRFModel(cfg)
        vg = jax.jit(jax.value_and_grad(
            lambda p, a: nerf_loss_fn(p, *a, cfg)))
        render = jax.jit(lambda p, a: model.render_rays(p, *a[:4]))
    else:
        model = ImageFieldModel(cfg)
        vg = jax.jit(jax.value_and_grad(
            lambda p, a: image_fit_loss_fn(p, *a, cfg)))
        render = jax.jit(lambda p, a: model.predict_coords(p, a[0]))
    loss, grads = vg(params, args)
    return float(loss), jax.device_get(grads), np.asarray(render(params,
                                                                  args))


def parity_case(cfg):
    """(ok, report, seed): ``cfg``'s loss, gradients and render on the GPU
    against the exact fp32 reference on the host CPU."""
    import jax

    from lomanerf_tpu.core import init_mlp

    cpu = jax.devices("cpu")[0]
    gpu = jax.devices()[0]
    args = _parity_inputs(cfg, np.random.default_rng(215))
    ref_cfg = dataclasses.replace(cfg, precision="highest")
    # the first seed whose reference gradient is not all zero (a plain He
    # init can start with a dead density head)
    for seed in range(8):
        params = init_mlp(jax.random.PRNGKey(seed), cfg.in_channels,
                          cfg.out_channels, cfg.num_layers, cfg.filter_size,
                          init=cfg.init)
        with jax.default_device(cpu):
            want = _loss_grads_pred(ref_cfg, jax.device_put(params, cpu),
                                    jax.device_put(args, cpu))
        if np.any(_flat(want[1])):
            break
    else:
        raise AssertionError("every seed's reference gradient is zero")
    got = _loss_grads_pred(cfg, jax.device_put(params, gpu),
                           jax.device_put(args, gpu))
    ok, report = compare_parity(got[0], want[0], got[1], want[1], got[2],
                                want[2], cfg.precision)
    return ok, report, seed


def phase_parity(ctx):
    ok_all = True
    for name, cfg in _parity_cases():
        ok, report, seed = parity_case(cfg)
        n_items = PARITY_RAYS if hasattr(cfg, "num_samples") else \
            PARITY_PIXELS
        unit = "rays" if hasattr(cfg, "num_samples") else "pixels"
        print(f"parity {name} [precision {cfg.precision}, {n_items} {unit}, "
              f"seed {seed}]: {'OK' if ok else 'FAIL'}: {report}", flush=True)
        ok_all &= ok
    if not ok_all:
        raise AssertionError("parity outside tolerance")


def _peak_gb(dev) -> float:
    return dev.memory_stats()["peak_bytes_in_use"] / 1e9


def _falling(losses) -> bool:
    k = max(len(losses) // 5, 1)
    return float(np.mean(losses[-k:])) < float(np.mean(losses[:k]))


def phase_train_nerf(ctx):
    import jax

    from lomanerf_tpu.train import train_nerf

    out = os.path.join(OUT_DIR, "train_nerf")
    res = train_nerf.main([
        "--preset", "full", "--data", "synthetic",
        "--img-size", str(EVAL_SIZE), "--steps", "30",
        "--rays-per-batch", str(RAYS_PER_STEP), "--eval-every", "25",
        "--log-dir", os.path.join(out, "logs"),
        "--ckpt-dir", os.path.join(out, "ckpt"), "--ckpt-every", "0",
    ])
    losses = np.asarray(res["losses"])
    assert len(losses) == 30 and np.all(np.isfinite(losses)), losses
    assert _falling(losses), f"loss not falling: {losses}"
    assert len(res["eval_s"]) == 2 and np.all(np.isfinite(res["psnrs"]))
    step_ms = float(np.median(res["step_s"][1:])) * 1e3
    print(f"train_nerf [preset full: 8x256, 128 samples, bf16; "
          f"{RAYS_PER_STEP} rays/step]: loss {losses[0]:.2f} -> {losses[-1]:.2f}, median "
          f"step {step_ms:.2f} ms, first step (compile) "
          f"{res['step_s'][0]:.1f} s, {EVAL_SIZE}x{EVAL_SIZE} frame render "
          f"{res['eval_s'][1] * 1e3:.1f} ms (first, with compile, "
          f"{res['eval_s'][0]:.1f} s), eval PSNR {res['psnrs'][-1]:.2f} dB, "
          f"peak device memory so far {_peak_gb(jax.devices()[0]):.2f} GB"
          f" | {ctx['gpu']}", flush=True)


def phase_fit_image(ctx):
    import jax

    from lomanerf_tpu.train import fit_image

    out = os.path.join(OUT_DIR, "fit_image")
    res = fit_image.main([
        "--img", "synthetic", "--img-size", str(FIT_SIZE), "--layers", "4",
        "--width", "128", "--enc-functions", "8", "--steps", "30",
        "--optimizer", "adam", "--lr", "3e-3", "--log-every", "25",
        "--log-dir", os.path.join(out, "logs"),
        "--ckpt-dir", os.path.join(out, "ckpt"), "--ckpt-every", "0",
    ])
    losses = np.asarray(res["losses"])
    assert len(losses) == 30 and np.all(np.isfinite(losses)), losses
    assert _falling(losses), f"loss not falling: {losses}"
    assert np.isfinite(res["psnr"])
    step_ms = float(np.median(res["step_s"][1:])) * 1e3
    print(f"fit_image [{FIT_SIZE}x{FIT_SIZE}, 4x128, 8 encoding functions, precision "
          f"high]: loss {losses[0]:.1f} -> {losses[-1]:.1f}, median step "
          f"{step_ms:.2f} ms, first step (compile) {res['step_s'][0]:.1f} s,"
          f" PSNR {res['psnr']:.2f} dB, peak device memory so far "
          f"{_peak_gb(jax.devices()[0]):.2f} GB | {ctx['gpu']}", flush=True)


def phase_dsl(ctx):
    """examples/diff_raytrace.py's program (structs, exp, rev_diff),
    forward on a pixel grid and reverse at four pixels, GPU against CPU."""
    import jax

    from lomanerf_tpu import dsl

    sys.path.insert(0, os.path.join(REPO, "examples"))
    from diff_raytrace import CODE

    sphere = {"center": {"x": 0.2, "y": -0.1, "z": 0.0}, "radius": 0.5}
    xs = np.linspace(-1.0, 1.0, 8)

    def run():
        _, lib = dsl.compile(CODE)
        img = np.array([[lib.intensity(sphere, float(x), float(y))
                         for x in xs] for y in xs])
        grads = []
        for x in xs[2:6]:
            d_sph = {"center": {k: np.zeros((), np.float32) for k in "xyz"},
                     "radius": np.zeros((), np.float32)}
            adj = lib.d_intensity(sphere, d_sph, float(x),
                                  np.zeros((), np.float32), 0.0,
                                  np.zeros((), np.float32), 1.0)
            grads.append(_flat(adj["sph"]))
        return img, np.stack(grads)

    img_gpu, g_gpu = run()
    with jax.default_device(jax.devices("cpu")[0]):
        img_cpu, g_cpu = run()
    err = max(float(np.max(np.abs(img_gpu - img_cpu))),
              float(np.max(np.abs(g_gpu - g_cpu))))
    ok = (np.allclose(img_gpu, img_cpu, rtol=1e-5, atol=1e-6)
          and np.allclose(g_gpu, g_cpu, rtol=1e-5, atol=1e-6)
          and np.any(g_cpu))
    print(f"dsl [examples/diff_raytrace.py: forward on 8x8 pixels, rev_diff "
          f"at 4]: {'OK' if ok else 'FAIL'}: max abs err GPU vs CPU {err:.3e}"
          f"; tolerance rtol 1e-5 atol 1e-6", flush=True)
    if not ok:
        raise AssertionError("DSL GPU result differs from CPU")


# ---- --multi: four GPUs ----

def _flagship_step_inputs():
    import jax
    import jax.numpy as jnp

    from lomanerf_tpu.core import init_mlp, sample_along_rays
    from lomanerf_tpu.models import NeRFConfig

    cfg = NeRFConfig.full()
    params = init_mlp(jax.random.PRNGKey(0), cfg.in_channels,
                      cfg.out_channels, cfg.num_layers, cfg.filter_size,
                      init=cfg.init)
    rng = np.random.default_rng(215)
    n = MULTI_DEVICES * RAYS_PER_STEP
    o = jnp.asarray(rng.standard_normal((n, 3)) * 0.3, jnp.float32)
    d = jnp.asarray(rng.standard_normal((n, 3)), jnp.float32)
    _, t, dists = sample_along_rays(o, d, cfg.near, cfg.far, cfg.num_samples)
    tgt = jnp.asarray(rng.random((n, 3)), jnp.float32)
    return cfg, params, (o, d, t, dists, tgt)


def _one_gpu_grads(cfg, params, batch):
    import jax

    from lomanerf_tpu.train.steps import nerf_loss_fn

    dev = jax.devices()[0]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: nerf_loss_fn(p, *b, cfg)))(
        jax.device_put(params, dev), jax.device_put(batch, dev))
    return float(loss), _flat(grads)


def _check_ray_shards(arr, n_shards: int, host_rows: np.ndarray, what: str):
    """Each device holds its own 1/n_shards of the rows, and they are the
    right rows."""
    per = host_rows.shape[0] // n_shards
    seen = {}
    for sh in arr.addressable_shards:
        start = sh.index[0].start or 0
        assert sh.data.shape[0] == per, (what, sh.data.shape, per)
        np.testing.assert_array_equal(np.asarray(sh.data),
                                      host_rows[start:start + per])
        seen.setdefault(start, set()).add(sh.device.id)
    assert sorted(seen) == [i * per for i in range(n_shards)], (what, seen)
    devices = [d for ids in seen.values() for d in ids]
    assert len(devices) == len(set(devices)) == len(arr.addressable_shards)


def _multi_train(ctx, dp: int, tp: int):
    import jax
    import optax

    from lomanerf_tpu.parallel import RayBatch, make_mesh, make_train_step, \
        shard_batch

    cfg, params, batch = _flagship_step_inputs()
    mesh = make_mesh(dp=dp, tp=tp, devices=jax.devices()[:MULTI_DEVICES])
    opt = optax.sgd(1.0)  # new params = params - grads: grads read back
    opt_state = opt.init(params)
    rb = shard_batch(mesh, RayBatch(*batch))
    _check_ray_shards(rb.origins, dp, np.asarray(batch[0]), "origins")
    _check_ray_shards(rb.target, dp, np.asarray(batch[4]), "target")
    step = make_train_step(cfg, opt, mesh, params, opt_state, tp=tp > 1,
                           donate=False, uniform_depths=True)
    new_params, _, loss = step(params, opt_state, rb)
    g_multi = _flat(params) - _flat(jax.device_get(new_params))
    loss_1, g_1 = _one_gpu_grads(cfg, params, batch)
    loss_rel = abs(float(loss) - loss_1) / abs(loss_1)
    grad_rel = float(np.linalg.norm(g_multi - g_1) / np.linalg.norm(g_1))
    ok = (loss_rel <= MULTI_BOUNDS["loss_rel"]
          and grad_rel <= MULTI_BOUNDS["grad_rel"])
    print(f"multi train [flagship, dp={dp} x tp={tp}, {len(batch[0])} rays, "
          f"{len(batch[0]) // dp} per data shard] vs one GPU: "
          f"{'OK' if ok else 'FAIL'}: loss rel err {loss_rel:.3e}, grad "
          f"rel L2 err {grad_rel:.3e}; tolerance loss {MULTI_BOUNDS['loss_rel']}"
          f", grads {MULTI_BOUNDS['grad_rel']} | {ctx['gpu_first']}",
          flush=True)
    if not ok:
        raise AssertionError("multi-GPU train step differs from one GPU")


def phase_multi_dp(ctx):
    _multi_train(ctx, dp=MULTI_DEVICES, tp=1)


def phase_multi_dp_tp(ctx):
    _multi_train(ctx, dp=2, tp=2)


def phase_multi_render(ctx):
    import jax
    import jax.numpy as jnp

    from lomanerf_tpu.core import get_rays, normalized_intrinsics
    from lomanerf_tpu.data import sphere_poses
    from lomanerf_tpu.models import NeRFConfig, NeRFModel
    from lomanerf_tpu.parallel import data_mesh, make_render_step, \
        shard_ray_chunks

    cfg = NeRFConfig.full()
    model = NeRFModel(cfg)
    params = model.init(jax.random.PRNGKey(0))
    K = normalized_intrinsics(1.1)
    pose = jnp.asarray(sphere_poses(4, radius=4.0)[1])
    size, chunk = EVAL_SIZE, 4096
    mesh = data_mesh(jax.devices()[:MULTI_DEVICES])
    o, d = get_rays(size, size, K, pose)
    oc, dc, n = shard_ray_chunks(mesh, o, d, chunk)
    per = oc.shape[0] // MULTI_DEVICES
    for sh in oc.addressable_shards:
        assert sh.data.shape == (per, chunk, 3), sh.data.shape
    assert len({sh.device.id for sh in oc.addressable_shards}) == \
        MULTI_DEVICES
    step = make_render_step(cfg, mesh)
    frame = np.asarray(step(params, oc, dc))[:n].reshape(size, size, 3)
    t0 = time.perf_counter()
    jax.block_until_ready(step(params, oc, dc))
    t_multi = time.perf_counter() - t0
    one = np.asarray(model.render_image(params, K, pose, size, chunk=chunk))
    diff = np.abs(frame.astype(np.float64) - one)
    ok = (diff.max() <= MULTI_BOUNDS["color_abs"]
          and diff.mean() <= MULTI_BOUNDS["color_mean_abs"])
    print(f"multi render [flagship {size}x{size}, {MULTI_DEVICES} GPUs, {per} "
          f"chunks of {chunk} rays each] vs one GPU: "
          f"{'OK' if ok else 'FAIL'}: color max abs err {diff.max():.3e}, "
          f"mean abs err {diff.mean():.3e}; tolerance max "
          f"{MULTI_BOUNDS['color_abs']}, mean {MULTI_BOUNDS['color_mean_abs']}"
          f"; frame {t_multi * 1e3:.1f} ms | {ctx['gpu_first']}", flush=True)
    if not ok:
        raise AssertionError("sharded render differs from one GPU")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help=f"run only the {MULTI_DEVICES}-GPU paths")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    require_gpu(devices)
    if args.multi and len(devices) != MULTI_DEVICES:
        raise SystemExit(f"chip_smoke --multi: needs {MULTI_DEVICES} GPUs, "
                         f"JAX found {len(devices)}")

    from lomanerf_tpu.utils import enable_compile_cache, \
        gpu_name_and_power_limit

    print(f"compile cache: {enable_compile_cache()}")
    gpu = gpu_name_and_power_limit()
    if not gpu:
        raise SystemExit("chip_smoke: nvidia-smi gave no name/power limit")
    print(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    print(f"nvidia-smi name, power.limit:\n{gpu}", flush=True)
    ctx = {"gpu": gpu.replace("\n", "; "),
           "gpu_first": gpu.splitlines()[0] + f" (x{len(devices)})"}

    failed = []
    for name in phases(args.multi):
        t0 = time.perf_counter()
        try:
            globals()[f"phase_{name}"](ctx)
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
        print(f"phase {name}: {'FAILED' if name in failed else 'passed'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
