"""The JAX pipeline against an independent float64 numpy reference.

Train loss and autodiff gradients, and the chunked image render, at exact
fp32 ("highest"), over both transmittance modes, two sample counts, shared
(S,) and per-ray (N, S) depths, and the stratified offset folded into the
ray origins (``stratified_ray_offsets``) against explicit shifted depths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from numpy_nerf import image_fit_loss_and_grads, nerf_loss_and_grads

from lomanerf_tpu.core import (
    get_rays,
    init_mlp,
    normalized_intrinsics,
    positional_encoding,
    sample_along_rays,
    stratified_ray_offsets,
)
from lomanerf_tpu.core.pipeline import image_fit_loss
from lomanerf_tpu.data import sphere_poses
from lomanerf_tpu.models import NeRFConfig, NeRFModel
from lomanerf_tpu.models.nerf import render_chunk
from lomanerf_tpu.train.steps import nerf_loss_fn

# fp32 against float64: sums over a few hundred terms
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-5


def _assert_grads_close(got, want):
    scale = max(float(np.max(np.abs(w))) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64), w,
                                   rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_OF_MAX * scale)


@pytest.mark.parametrize("stratified", [False, True])
@pytest.mark.parametrize("depths", ["uniform", "perray"])
@pytest.mark.parametrize("num_samples", [8, 30])
@pytest.mark.parametrize("mode", ["loma", "standard"])
def test_train_loss_and_grads_match_numpy(rng, mode, num_samples, depths,
                                          stratified):
    cfg = NeRFConfig(num_layers=3, filter_size=16, num_samples=num_samples,
                     mode=mode)
    n = 6
    params = init_mlp(jax.random.PRNGKey(num_samples), cfg.in_channels, 4,
                      cfg.num_layers, cfg.filter_size)
    o = jnp.asarray(rng.standard_normal((n, 3)) * 0.5, jnp.float32)
    d = jnp.asarray(rng.standard_normal((n, 3)), jnp.float32)
    key = jax.random.PRNGKey(7) if depths == "perray" else None
    _, t, dists = sample_along_rays(o, d, cfg.near, cfg.far, num_samples,
                                    key=key)
    target = jnp.asarray(rng.random((n, 3)), jnp.float32)
    o_in, t_ref = o, np.asarray(t, np.float64)
    if stratified:
        dt = stratified_ray_offsets(jax.random.PRNGKey(3), n, cfg.near,
                                    cfg.far, num_samples)
        o_in = o + d * dt[:, None]  # the drivers' offset form
        t_ref = (np.broadcast_to(t_ref, (n, num_samples))
                 + np.asarray(dt, np.float64)[:, None])

    loss, grads = jax.value_and_grad(nerf_loss_fn)(
        params, o_in, d, t, dists, target, cfg)
    want_loss, _, want_w, want_b = nerf_loss_and_grads(
        params["w"], params["b"], o, d, t_ref, np.asarray(dists), target,
        cfg.num_encoding_functions, mode)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    _assert_grads_close(grads["w"] + grads["b"], want_w + want_b)


@pytest.mark.parametrize("img_size,chunk", [(8, 16), (9, 16), (10, 7),
                                            (5, 32)])
@pytest.mark.parametrize("mode", ["loma", "standard"])
def test_render_image_matches_numpy(mode, img_size, chunk):
    """Chunked frame render, frames that are and are not a whole number of
    chunks, against the reference colors of the same rays."""
    cfg = NeRFConfig(num_layers=2, filter_size=16, num_samples=8, mode=mode,
                     init="nerf")
    model = NeRFModel(cfg)
    params = model.init(jax.random.PRNGKey(img_size))
    K = normalized_intrinsics(1.1)
    pose = jnp.asarray(sphere_poses(3, radius=4.0)[1])
    img = model.render_image(params, K, pose, img_size, chunk=chunk)
    assert img.shape == (img_size, img_size, 3)

    o, d = get_rays(img_size, img_size, K, pose)
    _, t, dists = sample_along_rays(o, d, cfg.near, cfg.far, cfg.num_samples)
    _, want, _, _ = nerf_loss_and_grads(
        params["w"], params["b"], o, d, np.asarray(t), np.asarray(dists),
        np.zeros((o.shape[0], 3)), cfg.num_encoding_functions, mode)
    np.testing.assert_allclose(np.asarray(img).reshape(-1, 3), want,
                               rtol=1e-5, atol=1e-6)
    # render_chunk on the same rays is the same colors
    cols = render_chunk(cfg, params, o, d)
    np.testing.assert_allclose(np.asarray(cols), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("num_functions", [5, 8])
def test_image_fit_loss_and_grads_match_numpy(rng, num_functions):
    n = 64
    params = init_mlp(jax.random.PRNGKey(1), 2 * (1 + 2 * num_functions), 3,
                      3, 16)
    coords = jnp.asarray(rng.random((n, 2)), jnp.float32)
    target = jnp.asarray(rng.random((n, 3)), jnp.float32)
    enc = positional_encoding(coords, num_functions)
    loss, grads = jax.value_and_grad(image_fit_loss)(params, enc, target)
    want_loss, _, want_w, want_b = image_fit_loss_and_grads(
        params["w"], params["b"], coords, target, num_functions)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    _assert_grads_close(grads["w"] + grads["b"], want_w + want_b)
