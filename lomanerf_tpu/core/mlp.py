"""Plain MLP: init + apply, matching the reference's semantics.

Reference behavior being reproduced (not ported):
  * init: He-style ``N(0, sqrt(2/fan_in))`` weights of shape (in, out) and
    ``N(0, 0.5)`` biases (/root/reference/mlp_utils.py:166-204); the 2D-fit
    driver instead uses plain ``randn`` init (fit_img.py:168-206) — exposed
    here via ``init="randn"``.
  * apply: ``x @ W + b`` per layer, ReLU on hidden layers
    (scripts/mlp_fit.py:108-120), and a configurable head on the last layer:
      - ``"sigmoid"``: sigmoid on every output channel (2D image fit,
        scripts/mlp_fit.py:121-132)
      - ``"rgba"``: sigmoid on channels != 3, ReLU on channel 3 (density)
        (scripts/nerf.py:147-167)
      - ``"none"``: raw linear output.

Params are a simple pytree ``{"w": [W_0..W_{L-1}], "b": [b_0..b_{L-1}]}`` with
exact (unpadded) shapes.

Every matmul goes through :func:`dense`, which implements the one precision
contract the configs choose from (``PRECISIONS``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import jax
import jax.numpy as jnp

Params = Dict[str, List[jnp.ndarray]]


def mlp_layer_sizes(
    in_channels: int, out_channels: int, num_layers: int, filter_size: int
) -> List[tuple]:
    """Per-layer (fan_in, fan_out), mirroring mlp_utils.get_sample_mlp."""
    sizes = []
    fan_in = in_channels
    for i in range(num_layers):
        fan_out = out_channels if i == num_layers - 1 else filter_size
        sizes.append((fan_in, fan_out))
        fan_in = fan_out
    return sizes


def init_mlp(
    key: jax.Array,
    in_channels: int,
    out_channels: int,
    num_layers: int,
    filter_size: int = 16,
    init: str = "he",
    dtype: Any = jnp.float32,
) -> Params:
    """Initialize MLP params.

    ``init="he"``: W ~ N(0, sqrt(2/fan_in)), b ~ N(0, 0.5)  (mlp_utils.py:175,196)
    ``init="randn"``: W, b ~ N(0, 1)                         (fit_img.py randn path)
    ``init="nerf"``: He hidden weights, ZERO biases, head weights x0.1, and
    a +0.5 density bias (channel 3 of an rgba head).  Deep (8x256) radiance
    MLPs at plain He init start with a DEAD density head with probability
    ~1/2: the per-unit constant component of the head pre-activation
    (~N(0, 1.6)) dominates its across-point spread (~1.0)
    (every gradient is then EXACTLY zero through relu'(sigma<0)), so the
    sigma unit's sign is a coin flip.  The
    positive density bias starts the field as thin fog — alpha > 0
    everywhere, gradients alive through both the density and color paths —
    the standard NeRF-practice init; the reference never hits this because
    its loma kernels are capped at 3 layers x 32 wide (scripts/nerf.py:67).
    """
    ws, bs = [], []
    for fan_in, fan_out in mlp_layer_sizes(
        in_channels, out_channels, num_layers, filter_size
    ):
        key, kw, kb = jax.random.split(key, 3)
        if init == "nerf":
            w = jax.random.normal(kw, (fan_in, fan_out), dtype) * jnp.sqrt(
                jnp.asarray(2.0 / fan_in, dtype)
            )
            b = jnp.zeros((fan_out,), dtype)
        elif init == "he":
            w = jax.random.normal(kw, (fan_in, fan_out), dtype) * jnp.sqrt(
                jnp.asarray(2.0 / fan_in, dtype)
            )
            b = jax.random.normal(kb, (fan_out,), dtype) * jnp.asarray(0.5, dtype)
        elif init == "randn":
            w = jax.random.normal(kw, (fan_in, fan_out), dtype)
            b = jax.random.normal(kb, (fan_out,), dtype)
        else:
            raise ValueError(f"unknown init {init!r}")
        ws.append(w)
        bs.append(b)
    if init == "nerf":
        ws[-1] = ws[-1] * jnp.asarray(0.1, dtype)
        if out_channels >= 4:
            bs[-1] = bs[-1].at[3].set(jnp.asarray(0.5, dtype))
    return {"w": ws, "b": bs}


def params_from_numpy(ws: Sequence, bs: Sequence, dtype: Any = jnp.float32) -> Params:
    """Wrap externally-created (e.g. numpy, oracle-matched) weights."""
    return {
        "w": [jnp.asarray(w, dtype) for w in ws],
        "b": [jnp.asarray(b, dtype) for b in bs],
    }


def _apply_head(y: jnp.ndarray, head: str) -> jnp.ndarray:
    if head == "sigmoid":
        return jax.nn.sigmoid(y)
    if head == "rgba":
        # sigmoid on color channels, ReLU on density channel 3
        # (scripts/nerf.py:147-167)
        density = jnp.maximum(y[..., 3:4], 0.0)
        rgb = jax.nn.sigmoid(
            jnp.concatenate([y[..., :3], y[..., 4:]], axis=-1)
        )
        return jnp.concatenate([rgb[..., :3], density, rgb[..., 3:]], axis=-1)
    if head == "none":
        return y
    raise ValueError(f"unknown head {head!r}")


# The matmul precision contract.  Parameters are always stored fp32.
#   "highest": fp32 operands, fp32 products (``Precision.HIGHEST``) — the
#              exact reference every parity test compares against.
#   "high":    fp32 operands split into bf16 parts, six bf16 products with
#              fp32 accumulation (``BF16_BF16_F32_X6``): meets the oracle-
#              parity tolerances where HIGHEST does, for 0.55-0.9x its time
#              on an H100.  ``Precision.HIGH`` is no substitute: on that
#              card it lowers to TF32, which misses them (PERF.md).
#   "bf16":    bf16 operands, fp32 accumulation — the wide flagship's
#              tensor-core path.
PRECISIONS = ("highest", "high", "bf16")


@jax.custom_vjp
def _dense_bf16(x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    return jnp.matmul(x.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)


def _dense_bf16_fwd(x, w):
    xb, wb = x.astype(jnp.bfloat16), w.astype(jnp.bfloat16)
    y = jnp.matmul(xb, wb, preferred_element_type=jnp.float32)
    return y, (xb, wb)


def _dense_bf16_bwd(res, g):
    # both backward products in bf16 too (autodiff would run them on the
    # fp32 cotangent); residuals are kept in bf16, half the bytes
    xb, wb = res
    gb = g.astype(jnp.bfloat16)
    dx = jnp.matmul(gb, wb.T, preferred_element_type=jnp.float32)
    dw = jnp.matmul(xb.T, gb, preferred_element_type=jnp.float32)
    return dx, dw


_dense_bf16.defvjp(_dense_bf16_fwd, _dense_bf16_bwd)


def dense(x: jnp.ndarray, w: jnp.ndarray, precision: str = "highest"):
    """``x @ w`` under the named precision of the contract above, for fp32
    ``x`` (N, K) and ``w`` (K, M); fp32 result."""
    if precision == "highest":
        return jnp.matmul(x, w, precision=jax.lax.Precision.HIGHEST)
    if precision == "high":
        return jnp.matmul(
            x, w, precision=jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X6)
    if precision == "bf16":
        return _dense_bf16(x, w)
    raise ValueError(f"unknown precision {precision!r}; want one of "
                     f"{PRECISIONS}")


def mlp_apply(
    params: Params,
    x: jnp.ndarray,
    head: str = "sigmoid",
    precision: str = "highest",
) -> jnp.ndarray:
    """Forward the MLP: ReLU hidden layers, ``head`` on the output layer.

    Matmuls run at ``precision`` (see :data:`PRECISIONS`); the default is
    exact fp32, the semantic-oracle setting.
    """
    n = len(params["w"])
    y = x
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        y = dense(y, w, precision) + b
        if i < n - 1:
            y = jnp.maximum(y, 0.0)
        else:
            y = _apply_head(y, head)
    return y
