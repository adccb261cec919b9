"""End-to-end parity vs the reference loma CPU implementation (golden oracle).

The BASELINE.md correctness gate: losses, rendered colors, and parameter
gradients of our jnp pipelines must be allclose to the gcc-compiled loma
kernels for (a) the 2D image fit and (b) the single-view NeRF configs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lomanerf_tpu.core import (
    image_fit_loss,
    nerf_loss,
    nerf_render,
    params_from_numpy,
    positional_encoding,
    seeded_value_and_grad,
)
from lomanerf_tpu.parity import oracle

pytestmark = pytest.mark.skipif(
    not oracle.oracle_available(), reason="reference loma compiler not present"
)


def _make_mlp(rng, sizes):
    ws = [rng.standard_normal(s).astype(np.float32) * (2.0 / s[0]) ** 0.5 for s in sizes]
    bs = [rng.standard_normal(s[1]).astype(np.float32) * 0.5 for s in sizes]
    return ws, bs


def test_mlp_fit_forward_parity(rng):
    """2D-fit forward loss vs oracle (config: fit_img.py 22->16->16->3)."""
    n, in_ch = 64, 22
    ws, bs = _make_mlp(rng, [(22, 16), (16, 16), (16, 3)])
    coords = rng.standard_normal((n, in_ch)).astype(np.float32)
    target = rng.random((n, 3)).astype(np.float32)

    loss_oracle = oracle.mlp_fit_forward(coords, ws, bs, target)
    params = params_from_numpy(ws, bs)
    loss_jnp = float(image_fit_loss(params, jnp.asarray(coords), jnp.asarray(target)))
    np.testing.assert_allclose(loss_jnp, loss_oracle, rtol=1e-5)


def test_mlp_fit_grad_parity(rng):
    n = 64
    ws, bs = _make_mlp(rng, [(22, 16), (16, 16), (16, 3)])
    coords = rng.standard_normal((n, 22)).astype(np.float32)
    target = rng.random((n, 3)).astype(np.float32)
    seed = 0.37  # loss-valued adjoint seed quirk (fit_img.py:497)

    d_ws_o, d_bs_o, d_in_o = oracle.mlp_fit_grad(coords, ws, bs, target, seed=seed)

    params = params_from_numpy(ws, bs)
    vag = seeded_value_and_grad(image_fit_loss)
    _, grads = vag(params, jnp.asarray(coords), jnp.asarray(target), seed=seed)

    for got, want in zip(grads["w"], d_ws_o):
        np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=2e-5)
    for got, want in zip(grads["b"], d_bs_o):
        np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=2e-5)


def test_nerf_forward_parity(rng):
    """Single-view NeRF chunk vs oracle (train_nerf.py config: 4 rays x 30
    samples, MLP 33->30->30->4)."""
    n_rays, s, in_ch = 4, 30, 33
    ws, bs = _make_mlp(rng, [(33, 30), (30, 30), (30, 4)])
    pts = rng.standard_normal((n_rays, s, 3)).astype(np.float32)
    enc = np.asarray(positional_encoding(jnp.asarray(pts), num_functions=5))
    target = rng.random((n_rays, 3)).astype(np.float32)
    t = np.linspace(2.0, 6.0, s).astype(np.float32)
    dists = np.concatenate([t[1:] - t[:-1], [1e8]]).astype(np.float32)
    dists = np.tile(dists, (n_rays, 1))

    loss_o, color_o = oracle.nerf_forward(enc.reshape(-1, in_ch), ws, bs, target, dists)

    params = params_from_numpy(ws, bs)
    color_j = np.asarray(
        nerf_render(params, jnp.asarray(enc), jnp.asarray(dists), mode="loma")
    )
    loss_j = float(
        nerf_loss(params, jnp.asarray(enc), jnp.asarray(dists), jnp.asarray(target))
    )
    np.testing.assert_allclose(color_j, color_o, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(loss_j, loss_o, rtol=1e-4)


def test_nerf_grad_parity(rng):
    n_rays, s = 4, 30
    ws, bs = _make_mlp(rng, [(33, 30), (30, 30), (30, 4)])
    pts = rng.standard_normal((n_rays, s, 3)).astype(np.float32)
    enc = np.asarray(positional_encoding(jnp.asarray(pts), num_functions=5))
    target = rng.random((n_rays, 3)).astype(np.float32)
    t = np.linspace(2.0, 6.0, s).astype(np.float32)
    dists = np.tile(np.concatenate([t[1:] - t[:-1], [1e8]]), (n_rays, 1)).astype(
        np.float32
    )
    seed = 1.7  # train_nerf.py:477 seeds with the running loss value

    d_ws_o, d_bs_o, d_enc_o = oracle.nerf_grad(
        enc.reshape(-1, 33), ws, bs, target, dists, seed=seed
    )

    params = params_from_numpy(ws, bs)
    vag = seeded_value_and_grad(nerf_loss)
    _, grads = vag(
        params, jnp.asarray(enc), jnp.asarray(dists), jnp.asarray(target), seed=seed
    )
    for got, want in zip(grads["w"], d_ws_o):
        np.testing.assert_allclose(np.asarray(got), want, rtol=3e-4, atol=3e-5)
    for got, want in zip(grads["b"], d_bs_o):
        np.testing.assert_allclose(np.asarray(got), want, rtol=3e-4, atol=3e-5)


def test_nerf_input_grad_parity(rng):
    """d(loss)/d(encoded points) must also match (pixel-gradient parity)."""
    n_rays, s = 2, 8
    ws, bs = _make_mlp(rng, [(33, 30), (30, 30), (30, 4)])
    pts = rng.standard_normal((n_rays, s, 3)).astype(np.float32)
    enc = np.asarray(positional_encoding(jnp.asarray(pts), num_functions=5))
    target = rng.random((n_rays, 3)).astype(np.float32)
    t = np.linspace(2.0, 6.0, s).astype(np.float32)
    dists = np.tile(np.concatenate([t[1:] - t[:-1], [1e8]]), (n_rays, 1)).astype(
        np.float32
    )

    _, _, d_enc_o = oracle.nerf_grad(enc.reshape(-1, 33), ws, bs, target, dists)

    params = params_from_numpy(ws, bs)
    d_enc_j = jax.grad(
        lambda e: nerf_loss(params, e, jnp.asarray(dists), jnp.asarray(target))
    )(jnp.asarray(enc))
    np.testing.assert_allclose(
        np.asarray(d_enc_j).reshape(-1, 33), d_enc_o, rtol=3e-4, atol=3e-5
    )


def test_nerf_high_tier_grad_parity(rng):
    """The "high" matmul precision (core.mlp.PRECISIONS) meets the SAME
    oracle-parity tolerances as the fp32-HIGHEST gate (rtol 3e-4 / atol
    3e-5) — the evidence that backs it as the production precision of the
    narrow configs."""
    from lomanerf_tpu.core.pipeline import nerf_loss_rays

    n_rays, s = 4, 30
    ws, bs = _make_mlp(rng, [(33, 30), (30, 30), (30, 4)])
    o = rng.standard_normal((n_rays, 3)).astype(np.float32)
    d = rng.standard_normal((n_rays, 3)).astype(np.float32)
    t = np.linspace(2.0, 6.0, s).astype(np.float32)
    dists_1d = np.concatenate([t[1:] - t[:-1], [1e8]]).astype(np.float32)
    pts = o[:, None, :] + d[:, None, :] * t[None, :, None]
    enc = np.asarray(positional_encoding(jnp.asarray(pts), num_functions=5))
    target = rng.random((n_rays, 3)).astype(np.float32)

    loss_o, _ = oracle.nerf_forward(
        enc.reshape(-1, 33), ws, bs, target, np.tile(dists_1d, (n_rays, 1))
    )
    d_ws_o, d_bs_o, _ = oracle.nerf_grad(
        enc.reshape(-1, 33), ws, bs, target, np.tile(dists_1d, (n_rays, 1))
    )

    params = params_from_numpy(ws, bs)
    loss_f, grads = jax.value_and_grad(
        lambda p: nerf_loss_rays(
            p, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
            jnp.asarray(dists_1d), jnp.asarray(target), precision="high")
    )(params)
    np.testing.assert_allclose(float(loss_f), loss_o, rtol=1e-4)
    for got, want in zip(grads["w"], d_ws_o):
        np.testing.assert_allclose(np.asarray(got), want, rtol=3e-4,
                                   atol=3e-5)
    for got, want in zip(grads["b"], d_bs_o):
        np.testing.assert_allclose(np.asarray(got), want, rtol=3e-4,
                                   atol=3e-5)
