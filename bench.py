"""Headline benchmark: NeRF train-step rays/sec on one device (fwd+bwd).

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N,
     "platform": ..., "device_kind": ..., "device_count": N,
     "gpu_name_power_limit": ...}

Every time is wall time to ``block_until_ready``, the median of --steps
calls after a warm-up call that compiles.

Baseline = the reference loma CPU implementation (gcc -O2, serial C) running
the same parity workload (30 samples/ray, MLP 33->30->30->4, fwd+grad per
chunk of 4 rays).  Measured live with --live-baseline when /root/reference
+ gcc are present; otherwise the recorded constant below is used.  The
reference publishes no numbers of its own (BASELINE.md).

``--task fit`` benchmarks the 2D image-fit train step instead (BASELINE
configs 1-2): pixels/s fwd+bwd, baseline = the loma CPU mlp_fit fwd+grad
loop over 256-px chunks (fit_img.py:423-431).
"""

from __future__ import annotations

import argparse
import json
import time

# Recorded loma CPU oracle throughputs (--live-baseline runs of the
# reference's own kernels on one host CPU core, gcc -O2).
LOMA_CPU_RAYS_PER_S = 391.0
# fwd+grad over 256-px chunks
LOMA_CPU_FIT_PX_PER_S = 29800.0
# forward-only (render/eval path): the reference's eval loop calls only the
# forward kernel.  Its loma kernels are compile-time capped at 3 layers x
# 32 wide, so the flagship 8x256 MLP is not expressible there; this
# parity-shape rate is the closest runnable analog.
LOMA_CPU_RENDER_RAYS_PER_S = 2100.0

PARITY_SAMPLES = 30
PARITY_LAYERS = [(33, 30), (30, 30), (30, 4)]
FIT_LAYERS = [(22, 16), (16, 16), (16, 3)]


def emit(metric: str, value: float, unit: str, const_baseline: float,
         live_baseline=None, **extra) -> None:
    """Print the one-line JSON result, naming the device it ran on.

    ``vs_baseline`` is the headline multiplier: against the LIVE-measured
    loma CPU oracle when ``--live-baseline`` ran, else the recorded
    constant.  Both denominators are self-described in the line
    (``vs_baseline_const`` + ``baseline_live`` when measured)."""
    import jax

    from lomanerf_tpu.utils import gpu_name_and_power_limit

    dev = jax.devices()[0]
    rec = {"metric": metric, "value": value, "unit": unit,
           "vs_baseline": round(value / (live_baseline or const_baseline), 2),
           "vs_baseline_const": round(value / const_baseline, 2)}
    if live_baseline:
        rec["vs_baseline_live"] = rec["vs_baseline"]
        rec["baseline_live"] = round(live_baseline, 1)
    rec.update(extra)
    rec.update(platform=dev.platform, device_kind=dev.device_kind,
               device_count=jax.device_count(),
               gpu_name_power_limit=gpu_name_and_power_limit())
    print(json.dumps(rec))


def median_call_s(fn, steps: int) -> float:
    """Median wall seconds of ``fn()`` to its result being ready, after one
    warm-up call (which compiles)."""
    import jax
    import numpy as np

    jax.block_until_ready(fn())
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def measure_baseline_live(budget_s: float = 3.0) -> float:
    import numpy as np

    from lomanerf_tpu.parity import oracle

    if not oracle.oracle_available():
        return LOMA_CPU_RAYS_PER_S
    rng = np.random.default_rng(0)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in PARITY_LAYERS]
    bs = [rng.standard_normal(s[1]).astype(np.float32) * 0.1 for s in PARITY_LAYERS]
    n_rays, s = 4, PARITY_SAMPLES
    enc = rng.standard_normal((n_rays * s, 33)).astype(np.float32)
    target = rng.random((n_rays, 3)).astype(np.float32)
    t = np.linspace(2.0, 6.0, s).astype(np.float32)
    dists = np.tile(np.concatenate([t[1:] - t[:-1], [1e8]]), (n_rays, 1)).astype(
        np.float32
    )
    oracle.nerf_forward(enc, ws, bs, target, dists)
    oracle.nerf_grad(enc, ws, bs, target, dists)
    t0 = time.perf_counter()
    iters = 0
    while time.perf_counter() - t0 < budget_s:
        oracle.nerf_forward(enc, ws, bs, target, dists)
        oracle.nerf_grad(enc, ws, bs, target, dists)
        iters += 1
    return iters * n_rays / (time.perf_counter() - t0)


def measure_fit_baseline_live(budget_s: float = 3.0) -> float:
    import numpy as np

    from lomanerf_tpu.parity import oracle

    if not oracle.oracle_available():
        return LOMA_CPU_FIT_PX_PER_S
    rng = np.random.default_rng(0)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in FIT_LAYERS]
    bs = [rng.standard_normal(s[1]).astype(np.float32) * 0.1 for s in FIT_LAYERS]
    n = 256  # the reference's chunk (fit_img.py:421)
    enc = rng.standard_normal((n, 22)).astype(np.float32)
    target = rng.random((n, 3)).astype(np.float32)
    oracle.mlp_fit_forward(enc, ws, bs, target)
    oracle.mlp_fit_grad(enc, ws, bs, target)
    t0 = time.perf_counter()
    iters = 0
    while time.perf_counter() - t0 < budget_s:
        oracle.mlp_fit_forward(enc, ws, bs, target)
        oracle.mlp_fit_grad(enc, ws, bs, target)
        iters += 1
    return iters * n / (time.perf_counter() - t0)


def bench_fit(args) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from lomanerf_tpu.core import init_mlp
    from lomanerf_tpu.models import ImageFieldConfig
    from lomanerf_tpu.models.image_mlp import image_grid_coords
    from lomanerf_tpu.train.steps import make_image_fit_step

    cfg = {"fit": ImageFieldConfig.small,
           "fit-hires": ImageFieldConfig.hires}[args.config]()
    params = init_mlp(
        jax.random.PRNGKey(0), cfg.in_channels, cfg.out_channels,
        cfg.num_layers, cfg.filter_size, init=cfg.init,
    )
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    n_px = cfg.img_size * cfg.img_size
    coords = image_grid_coords(cfg.img_size)
    target = jnp.asarray(np.random.default_rng(0).random((n_px, 3)),
                         jnp.float32)
    step = make_image_fit_step(cfg, opt, donate=False)
    _, _, loss = step(params, opt_state, coords, target, None)
    if not np.isfinite(float(loss)):
        raise RuntimeError("non-finite loss in benchmark")
    px_per_s = n_px / median_call_s(
        lambda: step(params, opt_state, coords, target, None), args.steps)
    emit(
        f"fit2d_train_px_per_s[{cfg.precision}]"
        + ("" if args.config == "fit" else "[hires]"),
        px_per_s, "px/s", LOMA_CPU_FIT_PX_PER_S,
        measure_fit_baseline_live() if args.live_baseline else None,
    )


def measure_render_baseline_live(budget_s: float = 3.0) -> float:
    """loma CPU oracle FORWARD-ONLY rays/s (the render path's honest
    baseline: the reference's eval loop calls only the forward kernel,
    train_nerf.py:558-712)."""
    import numpy as np

    from lomanerf_tpu.parity import oracle

    if not oracle.oracle_available():
        return LOMA_CPU_RENDER_RAYS_PER_S
    rng = np.random.default_rng(0)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in PARITY_LAYERS]
    bs = [rng.standard_normal(s[1]).astype(np.float32) * 0.1 for s in PARITY_LAYERS]
    n_rays, s = 4, PARITY_SAMPLES
    enc = rng.standard_normal((n_rays * s, 33)).astype(np.float32)
    target = rng.random((n_rays, 3)).astype(np.float32)
    t = np.linspace(2.0, 6.0, s).astype(np.float32)
    dists = np.tile(np.concatenate([t[1:] - t[:-1], [1e8]]), (n_rays, 1)).astype(
        np.float32
    )
    oracle.nerf_forward(enc, ws, bs, target, dists)
    t0 = time.perf_counter()
    iters = 0
    while time.perf_counter() - t0 < budget_s:
        oracle.nerf_forward(enc, ws, bs, target, dists)
        iters += 1
    return iters * n_rays / (time.perf_counter() - t0)


def bench_render(args) -> None:
    """BASELINE config 5: 800x800 render (eval path, flagship MLP) rays/s
    through the production mesh-sharded render (parallel/render_step.py):
    the frame's ray chunks sharded over a data mesh of all local devices,
    reassembled in-program by tiled all_gather (a no-op on one device)."""
    import jax
    import numpy as np

    from lomanerf_tpu.core import init_mlp
    from lomanerf_tpu.models import NeRFConfig
    from lomanerf_tpu.parallel import data_mesh, make_render_step, \
        shard_ray_chunks

    cfg = NeRFConfig.full()
    n = args.rays or 800 * 800
    chunk = args.render_chunk
    params = init_mlp(jax.random.PRNGKey(0), cfg.in_channels,
                      cfg.out_channels, cfg.num_layers, cfg.filter_size,
                      init=cfg.init)
    mesh = data_mesh()
    rng = np.random.default_rng(0)
    oc, dc, _ = shard_ray_chunks(
        mesh, rng.standard_normal((n, 3)), rng.standard_normal((n, 3)), chunk
    )
    n_pad = oc.shape[0] * chunk
    render = make_render_step(cfg, mesh)
    rays_per_s = n_pad / median_call_s(lambda: render(params, oc, dc),
                                       args.steps)
    emit(
        "nerf_render_rays_per_s[800x800,full]",
        rays_per_s, "rays/s", LOMA_CPU_RENDER_RAYS_PER_S,
        measure_render_baseline_live() if args.live_baseline else None,
        mesh_devices=mesh.devices.size,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=0,
                    help="rays per step (default: per-config)")
    ap.add_argument("--config", default="small",
                    choices=["small", "single64", "full", "fit", "fit-hires",
                             "pod-render"],
                    help="config ladder entry (small = reference parity; "
                         "fit/fit-hires imply --task fit)")
    ap.add_argument("--steps", type=int, default=20, help="timed calls")
    ap.add_argument(
        "--live-baseline", action="store_true",
        help="re-measure the loma CPU baseline instead of the recorded value",
    )
    ap.add_argument(
        "--render-chunk", type=int, default=16384,
        help="rays per scanned render chunk for --config pod-render (one "
             "fp32 activation of the 8x256 MLP at 128 samples is 2.1 GB "
             "at the default)",
    )
    args = ap.parse_args()
    from lomanerf_tpu.utils import enable_compile_cache

    enable_compile_cache()
    if args.config in ("fit", "fit-hires"):
        bench_fit(args)
        return
    if args.config == "pod-render":
        bench_render(args)
        return

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from lomanerf_tpu.core import init_mlp, sample_along_rays
    from lomanerf_tpu.models import NeRFConfig
    from lomanerf_tpu.train.steps import make_single_chip_train_step

    cfg = NeRFConfig.preset(args.config)
    if not args.rays:
        # keep per-step sample count comparable across the ladder
        args.rays = {"small": 262144, "single64": 65536, "full": 16384}[
            args.config]
    params = init_mlp(
        jax.random.PRNGKey(0), cfg.in_channels, cfg.out_channels,
        cfg.num_layers, cfg.filter_size, init=cfg.init,
    )
    opt = optax.adam(5e-4)
    opt_state = opt.init(params)

    rng = np.random.default_rng(0)
    n = args.rays
    o = jnp.asarray(rng.standard_normal((n, 3)), dtype=jnp.float32)
    d = jnp.asarray(rng.standard_normal((n, 3)), dtype=jnp.float32)
    _, t_vals, dists = sample_along_rays(o, d, cfg.near, cfg.far,
                                         cfg.num_samples)
    target = jnp.asarray(rng.random((n, 3)), dtype=jnp.float32)
    batch = (o, d, t_vals, dists, target)
    step = make_single_chip_train_step(cfg, opt, donate=False)
    _, _, loss = step(params, opt_state, *batch)
    if not np.isfinite(float(loss)):
        raise RuntimeError("non-finite loss in benchmark")
    rays_per_s = n / median_call_s(lambda: step(params, opt_state, *batch),
                                   args.steps)
    emit(
        f"nerf_train_rays_per_s[{cfg.precision}]"
        + ("" if args.config == "small" else f"[{args.config}]"),
        rays_per_s, "rays/s", LOMA_CPU_RAYS_PER_S,
        measure_baseline_live() if args.live_baseline else None,
    )


if __name__ == "__main__":
    main()
