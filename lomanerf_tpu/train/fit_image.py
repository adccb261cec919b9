"""2D image-fit training driver (the ``fit_img.py`` capability).

Fits an MLP to a target image through positional-encoded pixel coords.
Deliberate differences from the reference:
  * the whole image trains as ONE batch per step on-device (the reference
    chunks to 256 px because of loma's 256-row bound, fit_img.py:421-431);
    ``--chunk`` restores chunked behavior for parity experiments;
  * optimizer is configurable (raw SGD = reference default);
  * ``--parity-seed`` seeds each step's adjoint with the previous loss
    (the reference's ``_dreturn`` quirk, fit_img.py:497) instead of 1.0;
  * checkpointing is real (orbax, or numpy without it).

Run: ``python -m lomanerf_tpu.train.fit_image --steps 2000 --img synthetic``
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def synthetic_target(img_size: int) -> np.ndarray:
    """A colorful smooth test image (used when no --img is given)."""
    c = np.linspace(0, 1, img_size)
    ii, jj = np.meshgrid(c, c, indexing="xy")
    img = np.stack(
        [
            0.5 + 0.5 * np.sin(6.28 * ii) * np.cos(3.14 * jj),
            0.5 + 0.5 * np.cos(6.28 * (ii + jj)),
            0.5 + 0.5 * np.sin(9.42 * ii * jj),
        ],
        axis=-1,
    )
    return np.clip(img, 0, 1).astype(np.float32)


def load_target(path: str, img_size: int) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).resize((img_size, img_size)).convert("RGB")
    return np.asarray(img, dtype=np.float32) / 255.0


def main(argv=None) -> dict:
    """Fit; returns ``{"losses", "step_s", "psnr"}``: per-step losses, per-
    step wall seconds (to the loss being ready; the first includes
    compilation) and the final PSNR."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--img", default="synthetic",
                    help="'synthetic' or a path to an image file")
    ap.add_argument("--img-size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=50000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adam",
                                                           "loma_adam"])
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--enc-functions", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=0,
                    help="pixels per step (0 = full image per step)")
    ap.add_argument("--parity-seed", action="store_true",
                    help="seed adjoints with the previous loss (reference quirk)")
    ap.add_argument("--log-every", type=int, default=250)
    ap.add_argument("--log-dir", default="logs_2d")
    ap.add_argument("--ckpt-dir", default="checkpoints/fit_image")
    ap.add_argument("--ckpt-every", type=int, default=5000)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--platform", default=None,
                    help="force jax platform (e.g. cpu)")
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp
    import optax

    from lomanerf_tpu.core import psnr
    from lomanerf_tpu.models import ImageFieldConfig, ImageFieldModel
    from lomanerf_tpu.train import checkpoint, optim
    from lomanerf_tpu.train.logging_utils import MetricsLogger, \
        save_comparison
    from lomanerf_tpu.train.steps import make_image_fit_step
    from lomanerf_tpu.utils import enable_compile_cache

    enable_compile_cache()

    cfg = ImageFieldConfig(
        num_layers=args.layers,
        filter_size=args.width,
        num_encoding_functions=args.enc_functions,
        img_size=args.img_size,
    )
    model = ImageFieldModel(cfg)

    target = (
        synthetic_target(args.img_size)
        if args.img == "synthetic"
        else load_target(args.img, args.img_size)
    )
    target_flat = jnp.asarray(target.reshape(-1, 3))
    from lomanerf_tpu.models import image_grid_coords

    coords = image_grid_coords(args.img_size)

    params = model.init(jax.random.PRNGKey(215))
    opt = {
        "sgd": optim.loma_sgd(args.lr),
        "adam": optax.adam(args.lr),
        "loma_adam": optim.loma_adam(args.lr),
    }[args.optimizer]
    opt_state = opt.init(params)

    ckpt = checkpoint.CheckpointManager(args.ckpt_dir)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        params, opt_state, start_step = ckpt.restore(params, opt_state)
        print(f"resumed from step {start_step}")

    step_fn = make_image_fit_step(cfg, opt, donate=False)
    logger = MetricsLogger(args.log_dir)
    losses, step_s = [], []
    prev_loss = None

    n_px = coords.shape[0]
    chunk = args.chunk or n_px
    for i in range(start_step, args.steps):
        t0 = time.perf_counter()
        for lo in range(0, n_px, chunk):
            sl = slice(lo, lo + chunk)
            seed = (prev_loss if (args.parity_seed and prev_loss is not None)
                    else 1.0)
            params, opt_state, loss = step_fn(
                params, opt_state, coords[sl], target_flat[sl], seed
            )
            prev_loss = loss
        losses.append(float(loss))  # waits for the step
        step_s.append(time.perf_counter() - t0)
        if i % args.log_every == 0:
            pred = model.render(params)
            p = float(psnr(pred, jnp.asarray(target)))
            logger.log(i, loss=losses[-1], psnr=p)
            print(f"step {i} loss {losses[-1]:.4f} psnr {p:.2f} dB")
            frame = os.path.join(args.log_dir, f"iter_{i}.png")
            save_comparison(frame, target, np.asarray(pred))
            logger.log_image(i, "fit", frame)
        if args.ckpt_every and i and i % args.ckpt_every == 0:
            ckpt.save(i, params, opt_state)

    ckpt.save(args.steps, params, opt_state)
    pred = model.render(params)
    save_comparison(os.path.join(args.log_dir, f"iter_{args.steps}.png"),
                    target, np.asarray(pred))
    logger.close()
    final_psnr = float(psnr(pred, jnp.asarray(target)))
    print(f"final psnr: {final_psnr:.2f} dB")
    return {"losses": losses, "step_s": step_s, "psnr": final_psnr}


if __name__ == "__main__":
    main()
