"""Single-device train steps (jitted, donated) for both model families."""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import optax

from lomanerf_tpu.core import encoding, losses, pipeline


def nerf_loss_fn(params, origins, directions, t_vals, dists, target, cfg):
    """Sum-MSE NeRF loss at the config's matmul precision."""
    return pipeline.nerf_loss_rays(
        params, origins, directions, t_vals, dists, target,
        num_functions=cfg.num_encoding_functions, mode=cfg.mode,
        precision=cfg.precision,
    )


def image_fit_loss_fn(params, coords, target, cfg):
    """Sum-MSE of the image field on RAW (N, 2) pixel coords (encoded
    in-graph) at the config's matmul precision."""
    enc = encoding.positional_encoding(coords, cfg.num_encoding_functions)
    pred = pipeline.image_fit_pred(params, enc, precision=cfg.precision)
    return losses.sum_mse(pred, target)


def make_single_chip_train_step(
    cfg, optimizer: optax.GradientTransformation, donate: bool = True,
) -> Callable:
    """step(params, opt_state, origins, directions, t_vals, dists, target)
    -> (params, opt_state, loss), jitted with donated carry."""

    def step(params, opt_state, origins, directions, t_vals, dists, target):
        loss, grads = jax.value_and_grad(nerf_loss_fn)(
            params, origins, directions, t_vals, dists, target, cfg
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return jax.jit(step, donate_argnums=(0, 1) if donate else ())


def make_image_fit_step(
    cfg, optimizer: optax.GradientTransformation, donate: bool = True,
) -> Callable:
    """2D-fit step: step(params, opt_state, coords, target, seed).

    Takes RAW (N, 2) pixel coords — encoding runs on-device inside the
    step; the reference encodes on the host in numpy and marshals 22
    floats/pixel per call (fit_img.py:395-397)."""

    def step(params, opt_state, coords, target, seed=None):
        loss, vjp = jax.vjp(
            lambda p: image_fit_loss_fn(p, coords, target, cfg), params)
        s = jnp.asarray(1.0 if seed is None else seed, dtype=loss.dtype)
        (grads,) = vjp(s)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return jax.jit(step, donate_argnums=(0, 1) if donate else ())
