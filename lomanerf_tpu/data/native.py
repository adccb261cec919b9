"""ctypes binding for the native C++ ray-batch pipeline.

Builds ``native/liblomanerf_host.so`` on demand with g++ (no pybind11; C ABI
via ctypes).  ``RayBatchPipeline`` prefetches batches on a worker pool —
the host-runtime analog of the reference's tasksys.cpp thread pool — with a
pure-numpy fallback that produces identical batches (same counter-based
RNG) when no C++ toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "liblomanerf_host.so")

_lib = None


def _build_lib() -> Optional[str]:
    src = os.path.join(_NATIVE_DIR, "src", "ray_pipeline.cpp")
    if not os.path.exists(src):
        return None
    if os.path.exists(_LIB_PATH) and (
        os.path.getmtime(_LIB_PATH) >= os.path.getmtime(src)
    ):
        return _LIB_PATH
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR], check=True, capture_output=True
        )
        return _LIB_PATH
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None


def load_native():
    """Load (building if needed) the native library, or None."""
    global _lib
    if _lib is not None:
        return _lib
    path = _build_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.ln_create.restype = ctypes.c_void_p
    lib.ln_create.argtypes = [
        f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
    ]
    lib.ln_next_batch.restype = ctypes.c_int
    lib.ln_next_batch.argtypes = [ctypes.c_void_p] + [f32p] * 4
    lib.ln_depths.restype = None
    lib.ln_depths.argtypes = [ctypes.c_void_p, f32p, f32p]
    lib.ln_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):  # uint64 wraparound is the algorithm
        x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def _u01(x: np.ndarray) -> np.ndarray:
    return (x >> np.uint64(11)).astype(np.float64) / 9007199254740992.0


class RayBatchPipeline:
    """Prefetching ray-batch producer (native C++ pool or numpy fallback).

    Batches follow the reference's ray semantics exactly (see
    native/src/ray_pipeline.cpp).  Deterministic per (seed, batch index).

    Depths come in OFFSET form: the static per-pipeline comb ``t_base``
    (S,) / ``dists`` (S, 1e8 sentinel) plus a per-ray scalar ``t_offsets``
    in each batch (stratified = shifted-lattice jitter within one bin; 0
    when unjittered).  Fold offsets into origins (``o + d*dt[:, None]``) —
    depths then stay (S,) per-ray-uniform (O(N) ray bytes, no O(N*S)
    depth arrays).
    """

    def __init__(
        self,
        poses: np.ndarray,  # (V, 4, 4)
        images: np.ndarray,  # (V, H, W, 3)
        focal: float,
        n_rays: int,
        num_samples: int,
        near: float,
        far: float,
        stratified: bool = False,
        seed: int = 0,
        queue_depth: int = 4,
        n_threads: int = 4,
        force_numpy: bool = False,
    ):
        self.poses = np.ascontiguousarray(poses, np.float32)
        self.images = np.ascontiguousarray(images, np.float32)
        self.focal = float(focal)
        self.n_rays = n_rays
        self.num_samples = num_samples
        self.near = near
        self.far = far
        self.stratified = stratified
        self.seed = seed
        self._counter = 0
        self._ctx = None
        self._lib = None if force_numpy else load_native()
        if self._lib is not None:
            v, h, w, _ = self.images.shape
            f32p = ctypes.POINTER(ctypes.c_float)
            self._ctx = self._lib.ln_create(
                self.poses.ctypes.data_as(f32p),
                self.images.ctypes.data_as(f32p),
                v, h, w, self.focal, n_rays, num_samples,
                near, far, int(stratified), seed, queue_depth, n_threads,
            )
        # static depth comb (offset form): identical between C++ and numpy
        s = num_samples
        if self._ctx is not None:
            self.t_base = np.empty(s, np.float32)
            self.dists = np.empty(s, np.float32)
            f32p = ctypes.POINTER(ctypes.c_float)
            self._lib.ln_depths(self._ctx,
                                self.t_base.ctypes.data_as(f32p),
                                self.dists.ctypes.data_as(f32p))
        else:
            step = (far - near) / (s - 1)
            self.t_base = (
                near + step * np.arange(s, dtype=np.float32)
            ).astype(np.float32)
            self.dists = np.full(s, step, np.float32)
            self.dists[-1] = 1e8

    @property
    def is_native(self) -> bool:
        return self._ctx is not None

    def next_batch(self) -> Tuple[np.ndarray, ...]:
        """(origins, dirs, t_offsets, targets) float32 arrays; depths are
        the static ``self.t_base`` / ``self.dists`` combs."""
        n = self.n_rays
        if self._ctx is not None:
            o = np.empty((n, 3), np.float32)
            d = np.empty((n, 3), np.float32)
            toff = np.empty(n, np.float32)
            tgt = np.empty((n, 3), np.float32)
            f32p = ctypes.POINTER(ctypes.c_float)
            self._lib.ln_next_batch(
                self._ctx,
                o.ctypes.data_as(f32p), d.ctypes.data_as(f32p),
                toff.ctypes.data_as(f32p), tgt.ctypes.data_as(f32p),
            )
            return o, d, toff, tgt
        return self._numpy_batch()

    def _numpy_batch(self):
        """Bit-compatible numpy reimplementation of the C++ producer."""
        n, s = self.n_rays, self.num_samples
        v_cnt, h, w, _ = self.images.shape
        batch_id = self._counter
        self._counter += 1
        base = _splitmix64(
            np.uint64(self.seed) ^ (np.uint64(batch_id) * np.uint64(0x9E3779B9))
        )
        view = int(_splitmix64(base ^ np.uint64(0xABCDEF)) % np.uint64(v_cnt))
        P = self.poses[view]
        R, T = P[:3, :3], P[:3, 3]
        hsh = _splitmix64(
            base + np.arange(n, dtype=np.uint64) * np.uint64(0x100000001B3)
        )
        px = (hsh % np.uint64(w * w)).astype(np.int64)
        ix, iy = px % w, px // w
        u = ix / (w - 1) if w > 1 else np.zeros(n)
        vv = iy / (w - 1) if w > 1 else np.zeros(n)
        dc = np.stack(
            [(u - 0.5) / self.focal, -(vv - 0.5) / self.focal,
             -np.ones(n)], axis=-1
        ).astype(np.float32)
        dirs = dc @ R.T
        origins = np.tile(T, (n, 1)).astype(np.float32)
        if self.stratified:
            bin_w = (self.far - self.near) / s
            toff = (_u01(_splitmix64(hsh ^ np.uint64(0x5EEDB175)))
                    * bin_w).astype(np.float32)
        else:
            toff = np.zeros(n, np.float32)
        targets = self.images[view, iy, ix].astype(np.float32)
        return origins, dirs.astype(np.float32), toff, targets

    def close(self):
        if self._ctx is not None:
            self._lib.ln_destroy(self._ctx)
            self._ctx = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
