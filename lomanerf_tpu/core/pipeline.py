"""End-to-end differentiable pipelines (pure jnp — the semantic oracle path).

These are the jnp equivalents of the reference's two loma kernels:

* :func:`image_fit_loss`  ≡ ``mlp_fit``  (scripts/mlp_fit.py:1-147)
* :func:`nerf_loss`       ≡ ``nerf_evaluate_and_march`` (scripts/nerf.py:1-304)

Both return a scalar sum-MSE loss; reverse-mode gradients come from
``jax.grad`` / ``jax.vjp`` instead of loma's source-to-source ``rev_diff``.
The reference seeds the adjoint with the *previous* loss value rather than 1.0
(train_nerf.py:477, fit_img.py:497); :func:`seeded_value_and_grad` exposes
that quirk explicitly (seed=1.0 gives the mathematically standard gradient).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from lomanerf_tpu.core.composite import accumulate_color, render_weights
from lomanerf_tpu.core.encoding import positional_encoding
from lomanerf_tpu.core.losses import sum_mse
from lomanerf_tpu.core.mlp import Params, mlp_apply


def image_fit_pred(
    params: Params, coords_encoded: jnp.ndarray, precision: str = "highest"
) -> jnp.ndarray:
    """MLP prediction for the 2D image fit (sigmoid head on all channels)."""
    return mlp_apply(params, coords_encoded, head="sigmoid",
                     precision=precision)


def image_fit_loss(
    params: Params, coords_encoded: jnp.ndarray, target: jnp.ndarray
) -> jnp.ndarray:
    """Sum-MSE of the sigmoid MLP against target pixels (≡ mlp_fit)."""
    return sum_mse(image_fit_pred(params, coords_encoded), target)


def nerf_render(
    params: Params,
    points_encoded: jnp.ndarray,
    dists: jnp.ndarray,
    mode: str = "loma",
    precision: str = "highest",
    mlp: Callable = mlp_apply,
) -> jnp.ndarray:
    """Radiance-field render: MLP -> rgba -> compositing -> per-ray color.

    Args:
        params: MLP params (output channels >= 4; ch 0-2 rgb, ch 3 density).
        points_encoded: ``(N, S, F)`` encoded sample points.
        dists: ``(N, S)`` step sizes (with far sentinel), or ``(S,)`` shared
            by every ray.
        mode: transmittance mode (see core.composite).
        precision: matmul precision (see core.mlp.PRECISIONS).
        mlp: ``(params, x, head=, precision=) -> y``; ``mlp_apply`` or the
            tensor-parallel ``parallel.tp.tp_mlp_apply``.

    Returns:
        ``(N, 3)`` accumulated colors.
    """
    n, s, f = points_encoded.shape
    rgba = mlp(params, points_encoded.reshape(n * s, f), head="rgba",
               precision=precision)
    rgba = rgba.reshape(n, s, -1)
    weights = render_weights(rgba[..., 3], dists, mode=mode)
    return accumulate_color(weights, rgba[..., :3])


def nerf_loss(
    params: Params,
    points_encoded: jnp.ndarray,
    dists: jnp.ndarray,
    target: jnp.ndarray,
    mode: str = "loma",
) -> jnp.ndarray:
    """Sum-MSE of rendered colors vs targets (≡ nerf_evaluate_and_march)."""
    return sum_mse(nerf_render(params, points_encoded, dists, mode=mode), target)


def nerf_render_rays(
    params: Params,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    t_vals: jnp.ndarray,
    dists: jnp.ndarray,
    num_functions: int = 5,
    mode: str = "loma",
    precision: str = "highest",
    mlp: Callable = mlp_apply,
) -> jnp.ndarray:
    """Render straight from rays: sample points + encoding computed in-graph.

    This is the production entry point — positional encoding is computed
    on-device from 6 floats/ray instead of streaming 3*(1+2n) floats/sample
    from the host (the reference encodes on the host in numpy,
    train_nerf.py:302).
    """
    points = origins[:, None, :] + directions[:, None, :] * t_vals[..., None]
    enc = positional_encoding(points, num_functions=num_functions)
    return nerf_render(params, enc, dists, mode=mode, precision=precision,
                       mlp=mlp)


def nerf_loss_rays(
    params: Params,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    t_vals: jnp.ndarray,
    dists: jnp.ndarray,
    target: jnp.ndarray,
    num_functions: int = 5,
    mode: str = "loma",
    precision: str = "highest",
    mlp: Callable = mlp_apply,
) -> jnp.ndarray:
    pred = nerf_render_rays(
        params, origins, directions, t_vals, dists, num_functions, mode,
        precision, mlp,
    )
    return sum_mse(pred, target)


def seeded_value_and_grad(
    loss_fn: Callable[..., jnp.ndarray],
) -> Callable[..., Tuple[jnp.ndarray, Params]]:
    """``value_and_grad`` w.r.t. arg 0 with an explicit adjoint seed.

    The returned function takes ``(params, *args, seed=...)`` and returns
    ``(loss, grads)`` where ``grads = seed * dloss/dparams``.  ``seed``
    defaults to 1.0; passing the previous step's loss reproduces the
    reference's ``_dreturn = losses[-1]`` convention (train_nerf.py:477).
    """

    def wrapped(params, *args, seed: Optional[jnp.ndarray] = None):
        loss, vjp_fn = jax.vjp(lambda p: loss_fn(p, *args), params)
        s = jnp.asarray(1.0 if seed is None else seed, dtype=loss.dtype)
        (grads,) = vjp_fn(s)
        return loss, grads

    return wrapped
