"""NeRF model family: a radiance-field MLP + volume renderer.

Configs cover the BASELINE.json ladder:
  * ``small()``   — the reference parity config: 3 layers x width 30,
    pos-enc n=5 (in 33), 30 samples/ray, near/far 2/6
    (/root/reference/train_nerf.py:189-203)
  * ``single_view_64()`` — 64 samples/ray, 4-layer MLP (BASELINE config #3)
  * ``full()``    — 8 layers x width 256, 128 samples/ray (BASELINE #4/#5)

The model is functional: ``init`` makes a params pytree, ``render_rays`` /
``loss`` evaluate it through the semantic core (``core.pipeline``) at the
config's matmul precision.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import jax
import jax.numpy as jnp

from lomanerf_tpu.core import encoding, losses, mlp, pipeline, rays


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    num_layers: int = 3
    filter_size: int = 30
    out_channels: int = 4
    num_encoding_functions: int = 5
    num_samples: int = 30
    near: float = 2.0
    far: float = 6.0
    mode: str = "loma"  # transmittance mode: "loma" (reference parity) | "standard"
    init: str = "he"
    dtype: Any = jnp.float32  # parameter dtype
    # matmul precision, train and render alike: "highest" | "high" | "bf16"
    # (core.mlp.PRECISIONS)
    precision: str = "highest"

    @property
    def in_channels(self) -> int:
        return encoding.encoded_dim(3, self.num_encoding_functions)

    # ---- the BASELINE.json config ladder ----
    @staticmethod
    def preset(name: str) -> "NeRFConfig":
        """Ladder preset by name — the ONE registry the drivers
        (train_nerf --preset, make_video --preset) and bench share."""
        return {
            "small": NeRFConfig.small,
            "single64": NeRFConfig.single_view_64,
            "full": NeRFConfig.full,
        }[name]()

    @staticmethod
    def small() -> "NeRFConfig":
        # "high" passes the oracle-parity gate at the gate's own tolerances
        # (tests/test_parity_oracle.py::test_nerf_high_tier_grad_parity).
        # Plain NeRFConfig() keeps "highest" for exact-arithmetic work.
        return NeRFConfig(precision="high")

    @staticmethod
    def single_view_64() -> "NeRFConfig":
        return NeRFConfig(num_layers=4, filter_size=64, num_samples=64,
                          precision="high")

    @staticmethod
    def full() -> "NeRFConfig":
        # init="nerf": deep radiance MLPs at plain He init start with a
        # dead density head ~half the time (all-zero gradients — see
        # core.mlp.init_mlp); the fog-start init trains.  "bf16": the
        # 256-wide matmuls are the whole cost, and bf16 operands with fp32
        # accumulation put them on the tensor cores.
        return NeRFConfig(
            num_layers=8, filter_size=256, num_samples=128, mode="standard",
            precision="bf16", init="nerf",
        )


class NeRFModel:
    def __init__(self, config: NeRFConfig):
        self.config = config
        self._render_steps = {}  # mesh -> jitted sharded render step

    def init(self, key: jax.Array) -> mlp.Params:
        c = self.config
        return mlp.init_mlp(
            key,
            c.in_channels,
            c.out_channels,
            c.num_layers,
            c.filter_size,
            init=c.init,
            dtype=c.dtype,
        )

    def sample(self, origins, directions, key: Optional[jax.Array] = None):
        c = self.config
        return rays.sample_along_rays(
            origins, directions, c.near, c.far, c.num_samples, key=key
        )

    def render_rays(self, params, origins, directions, t_vals, dists) -> jnp.ndarray:
        c = self.config
        return pipeline.nerf_render_rays(
            params,
            origins,
            directions,
            t_vals,
            dists,
            num_functions=c.num_encoding_functions,
            mode=c.mode,
            precision=c.precision,
        )

    def loss(self, params, origins, directions, t_vals, dists, target) -> jnp.ndarray:
        pred = self.render_rays(params, origins, directions, t_vals, dists)
        return losses.sum_mse(pred, target)

    def render_image(
        self, params, K, c2w, img_size: int, chunk: int = 4096, mesh=None
    ) -> jnp.ndarray:
        """Chunked full-image render (the reference renders view 2 every 25
        iters chunk-by-chunk, train_nerf.py:558-712).

        All chunks run inside ONE jit via ``lax.scan``: one dispatch per
        frame, and device memory bounded by one chunk's activations.

        With ``mesh``, the chunk list is sharded over the mesh's ``data``
        axis (BASELINE config 5: rays sharded across devices and hosts) and
        the frame reassembled by a tiled all-gather — see
        ``parallel.render_step``."""
        if mesh is not None:
            from lomanerf_tpu.parallel import render_step

            step = self._render_steps.get(mesh)
            if step is None:
                step = render_step.make_render_step(self.config, mesh)
                self._render_steps[mesh] = step
            return render_step.sharded_render_image(
                params, K, c2w, img_size, mesh, step, chunk=chunk
            )
        o, d = rays.get_rays(img_size, img_size, K, c2w)
        n = o.shape[0]
        pad = (-n) % chunk
        oc = jnp.pad(o, ((0, pad), (0, 0))).reshape(-1, chunk, 3)
        dc = jnp.pad(d, ((0, pad), (0, 0))).reshape(-1, chunk, 3)
        cols = _render_chunks(self.config, params, oc, dc)
        return cols[:n].reshape(img_size, img_size, 3)


def render_chunk(config: NeRFConfig, params, o, d):
    """Render one (chunk, 3) ray block: sample depths, then the pipeline.
    Shared by the single-device chunk scan below and the mesh-sharded
    render step (parallel/render_step.py)."""
    _, tv, dists = rays.sample_along_rays(
        o, d, config.near, config.far, config.num_samples
    )
    return pipeline.nerf_render_rays(
        params, o, d, tv, dists,
        num_functions=config.num_encoding_functions,
        mode=config.mode,
        precision=config.precision,
    )


@functools.partial(jax.jit, static_argnums=(0,))
def _render_chunks(config: NeRFConfig, params, oc, dc):
    """Scan the per-chunk render over all (num_chunks, chunk, 3) ray blocks
    inside one compiled program (one device dispatch per image)."""

    def body(_, od):
        o, d = od
        return None, render_chunk(config, params, o, d)

    _, cols = jax.lax.scan(body, None, (oc, dc))
    return cols.reshape(-1, 3)


def count_params(params: mlp.Params) -> int:
    return sum(int(x.size) for x in jax.tree.leaves(params))
