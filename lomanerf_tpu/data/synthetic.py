"""Synthetic volumetric scenes + Blender-format dataset generation.

The reference trains on the Blender 'lego' scene, which is not shipped with
the repo; this module provides a self-contained stand-in: an analytic
emission-absorption volume (colored Gaussian density blobs) rendered with
the same camera model (normalized intrinsics, principal point 0.5).
:func:`synthetic_views` renders the training views in memory (what
``train_nerf --data synthetic`` trains on); :func:`write_blender_dataset`
writes the same views as a reference-compatible on-disk dataset
(``transforms_train.json`` + PNG frames, needs PIL).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from lomanerf_tpu.core import composite, rays


def look_at_pose(eye, target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Camera-to-world pose, -z forward (Blender/NeRF convention)."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    fwd = eye - target  # camera looks along -z, so +z points away from target
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right)
    true_up = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = fwd
    c2w[:3, 3] = eye
    return c2w


def sphere_poses(n: int, radius: float = 4.0, elevation: float = 0.5) -> np.ndarray:
    """n camera poses on a circle around the origin at fixed elevation."""
    poses = []
    for k in range(n):
        th = 2 * np.pi * k / n
        eye = (
            radius * np.cos(th),
            radius * np.sin(th),
            radius * np.sin(elevation),
        )
        poses.append(look_at_pose(eye))
    return np.stack(poses)


class GaussianBlobScene:
    """Analytic volume: sum of colored Gaussian density blobs."""

    def __init__(self, seed: int = 0, num_blobs: int = 4, extent: float = 1.0):
        g = np.random.default_rng(seed)
        self.centers = jnp.asarray(
            g.uniform(-extent * 0.6, extent * 0.6, (num_blobs, 3)), jnp.float32
        )
        self.scales = jnp.asarray(
            g.uniform(0.15, 0.4, (num_blobs,)), jnp.float32
        )
        self.peaks = jnp.asarray(g.uniform(4.0, 10.0, (num_blobs,)), jnp.float32)
        self.colors = jnp.asarray(g.uniform(0.2, 1.0, (num_blobs, 3)), jnp.float32)

    def field(self, x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(sigma, rgb) at points x (..., 3)."""
        d2 = jnp.sum(
            (x[..., None, :] - self.centers) ** 2, axis=-1
        )  # (..., B)
        w = self.peaks * jnp.exp(-0.5 * d2 / self.scales**2)  # (..., B)
        sigma = jnp.sum(w, axis=-1)
        rgb = jnp.sum(w[..., None] * self.colors, axis=-2) / (
            sigma[..., None] + 1e-6
        )
        return sigma, jnp.clip(rgb, 0.0, 1.0)

    def render(
        self,
        K: jnp.ndarray,
        c2w: jnp.ndarray,
        img_size: int,
        num_samples: int = 128,
        near: float = 2.0,
        far: float = 6.0,
    ) -> jnp.ndarray:
        """Ground-truth render via dense sampling + standard compositing."""
        o, d = rays.get_rays(img_size, img_size, K, jnp.asarray(c2w))
        pts, t, dists = rays.sample_along_rays(o, d, near, far, num_samples)
        sigma, rgb = self.field(pts)
        weights = composite.render_weights(sigma, dists, mode="standard")
        img = composite.accumulate_color(weights, rgb)
        return img.reshape(img_size, img_size, 3)


LEGO_CAMERA_ANGLE_X = 0.8575560450553894  # the lego scene's fov


def synthetic_views(
    scene: Optional[GaussianBlobScene] = None,
    n_frames: int = 8,
    img_size: int = 64,
    camera_angle_x: float = LEGO_CAMERA_ANGLE_X,
    radius: float = 4.0,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Render the scene from ``n_frames`` circular poses.

    Returns ``(images (V, H, W, 3) in [0, 1], poses (V, 4, 4), focal)``
    with the normalized focal ``0.5 / tan(0.5 * camera_angle_x)``, the
    values NeRFDataset reads back from a written dataset (up to its 8-bit
    quantization)."""
    scene = scene or GaussianBlobScene()
    focal = float(0.5 / np.tan(0.5 * camera_angle_x))
    K = rays.normalized_intrinsics(focal)
    poses = sphere_poses(n_frames, radius=radius)
    images = np.stack([np.asarray(scene.render(K, pose, img_size))
                       for pose in poses]).astype(np.float32)
    return images, poses, focal


def write_blender_dataset(
    out_dir: str,
    scene: Optional[GaussianBlobScene] = None,
    n_frames: int = 8,
    img_size: int = 64,
    camera_angle_x: float = LEGO_CAMERA_ANGLE_X,
    phase: str = "train",
    radius: float = 4.0,
) -> str:
    """Render the scene from circular poses and write a reference-format
    dataset (transforms_<phase>.json + <phase>/r_i.png).  Returns out_dir."""
    from PIL import Image

    images, poses, _ = synthetic_views(scene, n_frames, img_size,
                                       camera_angle_x, radius)
    frame_dir = os.path.join(out_dir, phase)
    os.makedirs(frame_dir, exist_ok=True)
    frames = []
    for i, (img, pose) in enumerate(zip(images, poses)):
        img8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        rel = f"{phase}/r_{i}"
        Image.fromarray(img8).save(os.path.join(out_dir, rel + ".png"))
        frames.append(
            {"file_path": rel, "transform_matrix": [list(map(float, r)) for r in pose]}
        )
    meta = {"camera_angle_x": camera_angle_x, "frames": frames}
    with open(os.path.join(out_dir, f"transforms_{phase}.json"), "w") as f:
        json.dump(meta, f)
    return out_dir
