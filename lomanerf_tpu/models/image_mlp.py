"""2D image-fitting field (the fit_img.py capability).

Config ladder per BASELINE.json: the reference's 256x256 / 22->16->16->3 /
pos-enc n=5 parity config (fit_img.py:379-421) and a hi-res variant.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp

from lomanerf_tpu.core import encoding, losses, mlp, pipeline


@dataclasses.dataclass(frozen=True)
class ImageFieldConfig:
    num_layers: int = 3
    filter_size: int = 16
    out_channels: int = 3
    num_encoding_functions: int = 5
    img_size: int = 256
    init: str = "he"
    dtype: Any = jnp.float32
    # matmul precision (core.mlp.PRECISIONS): "high" passes the parity
    # tolerances and is the production default; "highest" is exact fp32
    precision: str = "high"

    @property
    def in_channels(self) -> int:
        return encoding.encoded_dim(2, self.num_encoding_functions)

    @staticmethod
    def small() -> "ImageFieldConfig":
        return ImageFieldConfig()

    @staticmethod
    def hires() -> "ImageFieldConfig":
        # "2D fit + pos-enc at higher resolution" (BASELINE config #2)
        return ImageFieldConfig(
            num_layers=4, filter_size=128, num_encoding_functions=8, img_size=1024
        )


def image_grid_coords(img_size: int) -> jnp.ndarray:
    """The reference's input grid: meshgrid of linspace(0,1) stacked to
    (H*W, 2) (fit_img.py:390-393)."""
    g = jnp.meshgrid(
        jnp.linspace(0.0, 1.0, img_size), jnp.linspace(0.0, 1.0, img_size)
    )
    return jnp.stack(g, axis=-1).reshape(-1, 2)


class ImageFieldModel:
    def __init__(self, config: ImageFieldConfig):
        self.config = config

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

    def encode(self, coords: jnp.ndarray) -> jnp.ndarray:
        return encoding.positional_encoding(
            coords, self.config.num_encoding_functions
        )

    def predict(self, params, coords_encoded: jnp.ndarray) -> jnp.ndarray:
        """Predict from pre-encoded inputs."""
        return pipeline.image_fit_pred(params, coords_encoded,
                                       precision=self.config.precision)

    def predict_coords(self, params, coords: jnp.ndarray) -> jnp.ndarray:
        """Predict from raw (N, 2) coords (encoding runs in-graph)."""
        return self.predict(params, self.encode(coords))

    def loss(self, params, coords, target) -> jnp.ndarray:
        return losses.sum_mse(self.predict_coords(params, coords), target)

    def render(self, params, img_size: Optional[int] = None) -> jnp.ndarray:
        size = img_size or self.config.img_size
        coords = image_grid_coords(size)
        return self.predict_coords(params, coords).reshape(size, size, 3)
