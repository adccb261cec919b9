"""Assemble rendered frames into a video (make_nerf_video.py capability).

The reference stitches test-set frame PNGs into an mp4 with imageio
(/root/reference/make_nerf_video.py:1-44); this version can also render the
frames itself from a checkpoint along an orbit of poses.

Run:
    python -m lomanerf_tpu.train.make_video --frames logs_3d --out nerf.mp4
    python -m lomanerf_tpu.train.make_video --ckpt-dir checkpoints/train_nerf \
        --orbit 60 --img-size 64 --out orbit.mp4
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", default=None,
                    help="directory of numbered pngs to stitch")
    ap.add_argument("--ckpt-dir", default=None,
                    help="render an orbit from this checkpoint instead")
    ap.add_argument("--orbit", type=int, default=60, help="orbit frame count")
    ap.add_argument("--preset", default=None,
                    choices=["small", "single64", "full"],
                    help="NeRFConfig ladder preset (must match the "
                         "checkpoint's training config)")
    ap.add_argument("--img-size", type=int, default=64)
    ap.add_argument("--samples", type=int, default=30)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--width", type=int, default=30)
    ap.add_argument("--enc-functions", type=int, default=5)
    ap.add_argument("--focal", type=float, default=1.1106)
    ap.add_argument("--radius", type=float, default=4.0)
    ap.add_argument("--fps", type=int, default=15)
    ap.add_argument("--out", default="nerf.mp4")
    ap.add_argument("--platform", default=None)
    args = ap.parse_args(argv)

    import imageio.v2 as imageio

    frames = []
    if args.frames:
        paths = sorted(
            glob.glob(os.path.join(args.frames, "*.png")),
            key=lambda p: int(
                "".join(c for c in os.path.basename(p) if c.isdigit()) or 0
            ),
        )
        frames = [imageio.imread(p) for p in paths]
    elif args.ckpt_dir:
        import jax

        if args.platform:
            jax.config.update("jax_platforms", args.platform)
        import jax.numpy as jnp
        import optax

        from lomanerf_tpu.core import normalized_intrinsics
        from lomanerf_tpu.data import sphere_poses
        from lomanerf_tpu.models import NeRFConfig, NeRFModel
        from lomanerf_tpu.train import checkpoint
        from lomanerf_tpu.utils import enable_compile_cache

        enable_compile_cache()
        if args.preset:
            cfg = NeRFConfig.preset(args.preset)
        else:
            cfg = NeRFConfig(
                num_layers=args.layers, filter_size=args.width,
                num_encoding_functions=args.enc_functions,
                num_samples=args.samples,
            )
        model = NeRFModel(cfg)
        params = model.init(jax.random.PRNGKey(0))
        opt_state = optax.adam(1e-3).init(params)
        mgr = checkpoint.CheckpointManager(args.ckpt_dir)
        params, _, step = mgr.restore(params, opt_state)
        print(f"rendering {args.orbit}-frame orbit from step {step}")
        K = normalized_intrinsics(args.focal)
        # shard each frame's rays over all devices (parallel/render_step.py)
        mesh = None
        if jax.device_count() > 1:
            from lomanerf_tpu.parallel import data_mesh

            mesh = data_mesh()
        for pose in sphere_poses(args.orbit, radius=args.radius):
            img = model.render_image(params, K, jnp.asarray(pose),
                                     args.img_size, mesh=mesh)
            frames.append(
                (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)
            )
    else:
        raise SystemExit("need --frames or --ckpt-dir")

    if not frames:
        raise SystemExit("no frames found")
    out = args.out
    try:
        imageio.mimsave(out, frames, fps=args.fps)
    except (ValueError, OSError):
        # no ffmpeg backend available: fall back to gif
        out = os.path.splitext(out)[0] + ".gif"
        imageio.mimsave(out, frames, fps=args.fps)
    print(f"wrote {out} ({len(frames)} frames)")


if __name__ == "__main__":
    main()
