"""Ray + dataset visualization (the analog of the reference's notebooks).

The reference ships notebooks/rayvis.ipynb (3D ray visualization) and
scripts/test_dataloader.ipynb (dataset smoke-check); this script does both
against the synthetic Blender-format scene: a 3D plot of camera frusta and
sample points, plus a contact sheet of dataset frames.

Run: python examples/ray_visualization.py --out rayvis.png
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import jax.numpy as jnp
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default="data/synthetic_scene")
    ap.add_argument("--img-size", type=int, default=32)
    ap.add_argument("--out", default="rayvis.png")
    args = ap.parse_args()

    from lomanerf_tpu.core import get_rays, normalized_intrinsics, \
        sample_along_rays
    from lomanerf_tpu.data import NeRFDataset, write_blender_dataset

    if not os.path.exists(os.path.join(args.data, "transforms_train.json")):
        write_blender_dataset(args.data, n_frames=8, img_size=args.img_size)
    ds = NeRFDataset(args.data, img_size=args.img_size)
    K = normalized_intrinsics(ds.focal_length)

    fig = plt.figure(figsize=(14, 6))

    # --- 3D ray plot (rayvis analog) ---
    ax = fig.add_subplot(1, 2, 1, projection="3d")
    for idx in range(0, len(ds), 2):
        pose = ds[idx]["pose"]
        o, d = get_rays(args.img_size, args.img_size, K, jnp.asarray(pose))
        # a sparse subset of rays per camera
        sel = np.linspace(0, o.shape[0] - 1, 9).astype(int)
        o_np, d_np = np.asarray(o)[sel], np.asarray(d)[sel]
        pts, _, _ = sample_along_rays(
            jnp.asarray(o_np), jnp.asarray(d_np), 2.0, 6.0, 8
        )
        pts = np.asarray(pts)
        ax.scatter(*o_np[0], marker="o", s=40)
        for r in range(len(sel)):
            seg = np.stack([o_np[r], o_np[r] + 6.0 * d_np[r]])
            ax.plot(*seg.T, alpha=0.3, lw=0.8)
            ax.scatter(*pts[r].T, s=2, alpha=0.5)
    ax.set_title("camera origins, rays, depth samples")

    # --- dataset contact sheet (test_dataloader analog) ---
    n_show = min(len(ds), 6)
    for i in range(n_show):
        axi = fig.add_subplot(2, 6, 7 + i) if n_show > 3 else \
            fig.add_subplot(1, 2, 2)
        axi.imshow(ds[i]["image"])
        axi.set_title(f"frame {i}", fontsize=8)
        axi.axis("off")
        if n_show <= 3:
            break

    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    print(f"wrote {args.out}; dataset: {len(ds)} frames, focal "
          f"{ds.focal_length:.4f}, image {ds[0]['image'].shape}")


if __name__ == "__main__":
    main()
