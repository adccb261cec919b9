"""Ray generation and depth sampling.

``get_rays`` reproduces /root/reference/train_nerf.py:23-62 exactly under the
default flags:
  * pixel grid is ``linspace(0, 1, width)`` meshgrid'ed 'xy' over BOTH axes
    (the reference uses ``width`` for both; images are square),
  * directions ``[(i - cx)/fx, -(j - cy)/fy, -1] @ R^T``,
  * directions are NOT normalized (a recorded reference quirk),
  * origins are the pose translation tiled per pixel.

``sample_along_rays`` reproduces train_nerf.py:289-311: uniform
``linspace(near, far, S)`` depths shared by all rays, with an optional
stratified jitter (the reference sketches it but leaves it commented out),
and ``dists`` = forward differences with a 1e8 far sentinel appended.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def normalized_intrinsics(focal: float) -> jnp.ndarray:
    """K with normalized focal and principal point 0.5 (train_nerf.py:265-267)."""
    return jnp.array(
        [[focal, 0.0, 0.5], [0.0, focal, 0.5], [0.0, 0.0, 1.0]], dtype=jnp.float32
    )


def get_rays(
    height: int,
    width: int,
    K: jnp.ndarray,
    c2w: jnp.ndarray,
    normalize: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-pixel ray origins/directions in world space.

    Returns ``(origins, directions)`` each of shape ``(width*width, 3)``
    (flattened row-major like the reference's ``.flatten()`` of an 'xy'
    meshgrid).  ``normalize=True`` unit-normalizes directions (the reference
    never does for training; its unused ray_sampling.py:4-41 variant did).
    """
    coord = jnp.linspace(0.0, 1.0, width, dtype=jnp.float32)
    i, j = jnp.meshgrid(coord, coord, indexing="xy")
    i = i.reshape(-1)
    j = j.reshape(-1)
    directions = jnp.stack(
        [
            (i - K[0, 2]) / K[0, 0],
            -(j - K[1, 2]) / K[1, 1],
            -jnp.ones_like(i),
        ],
        axis=-1,
    )
    R = c2w[:3, :3].astype(jnp.float32)
    T = c2w[:3, 3].astype(jnp.float32)
    directions = directions @ R.T
    if normalize:
        directions = directions / jnp.linalg.norm(directions, axis=-1, keepdims=True)
    origins = jnp.broadcast_to(T, directions.shape)
    return origins, directions


def sample_along_rays(
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    near: float,
    far: float,
    num_samples: int,
    key: Optional[jax.Array] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sample points along rays at uniform (optionally stratified) depths.

    Returns ``(points, t_vals, dists)``.  ``points`` is ``(N, S, 3)``.
    Unjittered (``key=None``, the reference's linspace sampling,
    train_nerf.py:289-299), every ray shares the same depths, so ``t_vals``
    and ``dists`` are returned as ``(S,)`` — downstream consumers broadcast,
    and the sharded train step replicates them instead of sharding
    O(N*S) depths.  Stratified (``key`` given), they are per-ray ``(N, S)``.
    ``dists[..., -1]`` is the reference's 1e8 sentinel.
    """
    t = jnp.linspace(near, far, num_samples, dtype=jnp.float32)
    n = origins.shape[0]
    if key is not None:
        # stratified: jitter each bin uniformly within its width, per ray.
        # Training prefers stratified_ray_offsets (per-ray comb shift folded
        # into origins), which keeps depths (S,); this per-bin variant
        # remains as the independent-jitter oracle.
        bin_width = (far - near) / num_samples
        jitter = jax.random.uniform(key, (n, num_samples), dtype=jnp.float32)
        t = t[None, :] + jitter * bin_width
    points = origins[:, None, :] + directions[:, None, :] * t[..., None]
    dists = jnp.concatenate(
        [t[..., 1:] - t[..., :-1], jnp.full_like(t[..., :1], 1e8)], axis=-1
    )
    return points, t, dists


def stratified_ray_offsets(
    key: jax.Array, num_rays: int, near: float, far: float, num_samples: int
) -> jnp.ndarray:
    """Per-ray stratified depth offsets ``dt`` (N,), to fold into origins.

    Shifted-lattice (Cranley-Patterson) stratification: every ray's whole
    depth comb ``t_base[s] = linspace(near, far, S)[s]`` shifts by one
    uniform draw within a bin width, so each sample is still uniform over
    its stratum but depths stay PER-RAY-UNIFORM — ``o + d*dt[:, None]``
    with the unjittered ``(S,)`` t_vals/dists reproduces ``t_base + dt``
    exactly (points depend on depth only through ``o + d*t``), so a batch
    carries O(N) ray data instead of O(N*S) depths.  The reference sketches
    per-sample jitter, commented out (train_nerf.py:289-294).
    """
    bin_width = (far - near) / num_samples
    return jax.random.uniform(key, (num_rays,), dtype=jnp.float32) * bin_width


def generate_random_rays(
    key: jax.Array,
    image_size: Tuple[int, int],
    num_rays: int,
    cameras: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Random-pixel ray sampler with UNIT-normalized directions.

    Capability parity with the reference's alternative sampler
    (ray_sampling.py:4-41 — unused by its trainers, which use the
    unnormalized ``get_rays``): per camera, sample ``num_rays`` random
    pixels, build center-offset camera-space directions, normalize, rotate
    into world space; origins are the camera translations.

    Args:
        key: PRNG key (replaces the reference's global numpy RNG).
        image_size: (W, H).
        num_rays: rays per camera.
        cameras: (C, 4, 4) camera-to-world transforms.

    Returns:
        ``(origins, directions)``, each ``(C*num_rays, 3)``; directions are
        unit length.
    """
    cameras = jnp.asarray(cameras, jnp.float32)
    c = cameras.shape[0]
    kx, ky = jax.random.split(key)
    px = jax.random.randint(kx, (c, num_rays), 0, image_size[0])
    py = jax.random.randint(ky, (c, num_rays), 0, image_size[1])
    dirs = jnp.stack(
        [
            (px - image_size[0] / 2.0) / image_size[0],
            (py - image_size[1] / 2.0) / image_size[1],
            -jnp.ones_like(px, dtype=jnp.float32),
        ],
        axis=-1,
    )  # (C, N, 3)
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = jnp.einsum("cij,cnj->cni", cameras[:, :3, :3], dirs)
    origins = jnp.broadcast_to(cameras[:, None, :3, 3], dirs.shape)
    return origins.reshape(-1, 3), dirs.reshape(-1, 3)
