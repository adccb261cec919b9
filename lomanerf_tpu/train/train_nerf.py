"""NeRF training driver (the ``train_nerf.py`` capability).

Trains a radiance field on a Blender-format dataset (or a synthetic scene
rendered in memory) with rays sharded over the device mesh.  Differences
from the reference:
  * per step, a fixed-size random ray batch from a random view (static
    shapes for XLA) instead of the reference's 4-ray chunk loop;
  * data-parallel over all devices via shard_map + psum (the reference is
    single-core serial C);
  * optional stratified depth jitter (the reference sketches it, commented
    out, train_nerf.py:290-294);
  * real checkpointing/resume; PSNR eval renders like the reference's
    every-25-iters view-2 dump (train_nerf.py:558-712).

Run: ``python -m lomanerf_tpu.train.train_nerf --data synthetic --steps 500``
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np


def main(argv=None) -> dict:
    """Train; returns ``{"losses", "step_s", "eval_s", "psnrs"}``: the
    per-step losses, per-step wall seconds (to the loss being ready; the
    first includes compilation), per-eval frame-render seconds (the first
    includes compilation) and per-eval PSNRs."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default="synthetic",
                    help="'synthetic' or a Blender-format dataset dir")
    ap.add_argument("--preset", default=None,
                    choices=["small", "single64", "full"],
                    help="NeRFConfig ladder preset (BASELINE configs; "
                         "overrides --layers/--width/--samples/--mode and "
                         "sets the production matmul precision)")
    ap.add_argument("--img-size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=50000)
    ap.add_argument("--rays-per-batch", type=int, default=4096)
    ap.add_argument("--samples", type=int, default=30)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--width", type=int, default=30)
    ap.add_argument("--enc-functions", type=int, default=5)
    ap.add_argument("--near", type=float, default=2.0)
    ap.add_argument("--far", type=float, default=6.0)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--optimizer", default="adam",
                    choices=["adam", "loma_adam", "sgd"])
    ap.add_argument("--mode", default="loma", choices=["loma", "standard"],
                    help="transmittance mode (loma = reference parity)")
    ap.add_argument("--stratified", action="store_true",
                    help="jitter depth samples per ray")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel size")
    ap.add_argument("--pipeline", default="python",
                    choices=["python", "native", "numpy"],
                    help="ray-batch producer: in-driver python, the C++ "
                         "prefetcher, or its numpy fallback")
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--eval-view", type=int, default=2)
    ap.add_argument("--log-dir", default="logs_3d")
    ap.add_argument("--ckpt-dir", default="checkpoints/train_nerf")
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=215)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--coordinator", default=None,
                    help="multi-host coordinator address host:port (single "
                         "host / pre-initialized cluster runtimes: omit)")
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp
    import optax

    from lomanerf_tpu.core import get_rays, normalized_intrinsics, psnr, \
        sample_along_rays, stratified_ray_offsets
    from lomanerf_tpu.data import NeRFDataset, synthetic_views
    from lomanerf_tpu.models import NeRFConfig, NeRFModel
    from lomanerf_tpu.parallel import RayBatch, initialize_multihost, \
        is_primary, make_mesh, make_train_step, place_state, shard_batch
    from lomanerf_tpu.train import checkpoint, optim
    from lomanerf_tpu.train.logging_utils import MetricsLogger, \
        save_comparison
    from lomanerf_tpu.utils import enable_compile_cache

    # multi-host first: the mesh below spans ALL processes' devices
    initialize_multihost(args.coordinator)
    enable_compile_cache()

    if args.preset:
        cfg = dataclasses.replace(NeRFConfig.preset(args.preset),
                                  near=args.near, far=args.far)
    else:
        cfg = NeRFConfig(
            num_layers=args.layers,
            filter_size=args.width,
            num_encoding_functions=args.enc_functions,
            num_samples=args.samples,
            near=args.near,
            far=args.far,
            mode=args.mode,
        )
    model = NeRFModel(cfg)

    if args.data == "synthetic":
        # rendered in memory, identically on every process (fixed seed)
        images, poses, focal = synthetic_views(n_frames=16,
                                               img_size=args.img_size)
    else:
        dataset = NeRFDataset(args.data, img_size=args.img_size,
                              phase="train")
        focal = dataset.focal_length
        images = np.stack([dataset[i]["image"] for i in range(len(dataset))])
        poses = np.stack([dataset[i]["pose"] for i in range(len(dataset))])
    n_views = len(images)
    K = normalized_intrinsics(focal)

    # precompute per-view rays once (pose set is static)
    all_o, all_d = [], []
    for p in poses:
        o, d = get_rays(args.img_size, args.img_size, K, jnp.asarray(p))
        all_o.append(np.asarray(o))
        all_d.append(np.asarray(d))
    all_o = np.stack(all_o)  # (V, HW, 3)
    all_d = np.stack(all_d)
    all_t = images.reshape(n_views, -1, 3)

    params = model.init(jax.random.PRNGKey(args.seed))
    opt = {
        "adam": optax.adam(args.lr),
        "loma_adam": optim.loma_adam(args.lr),
        "sgd": optim.loma_sgd(args.lr),
    }[args.optimizer]
    opt_state = opt.init(params)

    n_dev = jax.device_count()
    tp = args.tp
    mesh = make_mesh(dp=n_dev // tp, tp=tp)
    # every pipeline (python/native/numpy, stratified or not) emits (S,)
    # per-ray-uniform depths — stratified jitter is folded into the origins
    # as a per-ray comb shift; the step infers the depth sharding spec from
    # t_vals rank
    step_fn = make_train_step(
        cfg, opt, mesh, params, opt_state, tp=(tp > 1), donate=False,
    )

    ckpt = checkpoint.CheckpointManager(args.ckpt_dir)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        params, opt_state, start_step = ckpt.restore(params, opt_state)
        # restored arrays are committed to one device; re-place on the mesh
        params, opt_state = place_state(mesh, cfg, params, opt_state,
                                        tp=(tp > 1))
        print(f"resumed from step {start_step}")

    logger = MetricsLogger(args.log_dir)
    # per-host RNG partition: each host draws a DISJOINT ray stream (the
    # multi-host analog of the reference's single-process sampling)
    host_seed = args.seed + 7919 * jax.process_index()
    rng = np.random.default_rng(host_seed)
    jkey = jax.random.PRNGKey(host_seed)
    psnrs, losses, step_s, eval_s = [], [], [], []

    pipe = None
    if args.pipeline in ("native", "numpy"):
        from lomanerf_tpu.data.native import RayBatchPipeline

        pipe = RayBatchPipeline(
            poses, images, focal, args.rays_per_batch, cfg.num_samples,
            cfg.near, cfg.far, stratified=args.stratified, seed=args.seed,
            force_numpy=(args.pipeline == "numpy"),
        )
        if args.pipeline == "native" and not pipe.is_native:
            print("native pipeline unavailable; using numpy fallback")

    n_rays = args.rays_per_batch
    for i in range(start_step, args.steps):
        if pipe is not None:
            # offset-form depths: fold the per-ray stratified offset into
            # the origins (o + d*dt); depths stay the static (S,) comb
            o_np, d_np, toff_np, tgt_np = pipe.next_batch()
            o_np = o_np + d_np * toff_np[:, None]
            batch = shard_batch(
                mesh,
                RayBatch(*(jnp.asarray(x) for x in (
                    o_np, d_np, pipe.t_base, pipe.dists, tgt_np))),
            )
        else:
            v = rng.integers(n_views)
            idx = rng.integers(all_o.shape[1], size=n_rays)
            o = jnp.asarray(all_o[v, idx])
            d = jnp.asarray(all_d[v, idx])
            if args.stratified:
                jkey, key = jax.random.split(jkey)
                dt = stratified_ray_offsets(
                    key, n_rays, cfg.near, cfg.far, cfg.num_samples
                )
                o = o + d * dt[:, None]
            _, t_vals, dists = sample_along_rays(
                o, d, cfg.near, cfg.far, cfg.num_samples
            )
            batch = shard_batch(
                mesh,
                RayBatch(o, d, t_vals, dists, jnp.asarray(all_t[v, idx])),
            )
        t0 = time.perf_counter()
        params, opt_state, loss = step_fn(params, opt_state, batch)
        losses.append(float(loss))  # waits for the step
        step_s.append(time.perf_counter() - t0)
        if not np.isfinite(losses[-1]):
            # the reference drops into pdb on NaN grads (train_nerf.py:486-
            # 489); here: report and stop so the checkpoint stays usable
            print(f"non-finite loss at step {i}; stopping")
            break

        if i % args.eval_every == 0:
            # SPMD-safe eval with rays sharded over the mesh (BASELINE
            # config 5: each device renders 1/N of the frame's chunks,
            # reassembled by all-gather — parallel/render_step.py); only
            # process 0 writes.  TP-sharded params take the plain jit path
            # (XLA gathers the width shards for the render).
            view = args.eval_view % n_views
            t0 = time.perf_counter()
            img = model.render_image(params, K, jnp.asarray(poses[view]),
                                     args.img_size,
                                     mesh=mesh if tp == 1 else None)
            img = np.asarray(img)  # waits for the render
            eval_s.append(time.perf_counter() - t0)
            p = float(psnr(jnp.asarray(images[view]), jnp.asarray(img)))
            psnrs.append(p)
            logger.log(i, loss=losses[-1], psnr=p)
            if is_primary():
                print(f"step {i} loss {losses[-1]:.4f} psnr {p:.2f} dB "
                      f"step {step_s[-1] * 1e3:.2f} ms "
                      f"render {eval_s[-1] * 1e3:.1f} ms")
                frame = os.path.join(args.log_dir, f"{i}.png")
                save_comparison(frame, images[view], img)
                logger.log_image(i, "render", frame)
        if args.ckpt_every and i and i % args.ckpt_every == 0:
            ckpt.save(i, params, opt_state)

    ckpt.save(args.steps, params, opt_state)
    logger.close()
    if is_primary():
        print(f"done; final loss {losses[-1]:.4f}")
    return {"losses": losses, "step_s": step_s, "eval_s": eval_s,
            "psnrs": psnrs}


if __name__ == "__main__":
    main()
