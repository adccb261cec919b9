"""The matmul precision contract (core.mlp.PRECISIONS), read from the
lowered programs of every config, and the bf16 flagship's stated bound."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from lomanerf_tpu.core import init_mlp, sample_along_rays
from lomanerf_tpu.core.mlp import dense
from lomanerf_tpu.models import ImageFieldConfig, ImageFieldModel, NeRFConfig
from lomanerf_tpu.models.nerf import render_chunk
from lomanerf_tpu.train.steps import image_fit_loss_fn, nerf_loss_fn

CONFIGS = {
    "small": NeRFConfig.small,
    "single64": NeRFConfig.single_view_64,
    "full": NeRFConfig.full,
    "fit": ImageFieldConfig.small,
    "fit-hires": ImageFieldConfig.hires,
}
EXPECTED = {"small": "high", "single64": "high", "full": "bf16",
            "fit": "high", "fit-hires": "high"}


def _inputs(cfg, n=8):
    rng = np.random.default_rng(0)
    params = init_mlp(jax.random.PRNGKey(0), cfg.in_channels,
                      cfg.out_channels, cfg.num_layers, cfg.filter_size,
                      init=cfg.init)
    if isinstance(cfg, NeRFConfig):
        o = jnp.asarray(rng.standard_normal((n, 3)) * 0.3, jnp.float32)
        d = jnp.asarray(rng.standard_normal((n, 3)), jnp.float32)
        _, t, dists = sample_along_rays(o, d, cfg.near, cfg.far,
                                        cfg.num_samples)
        tgt = jnp.asarray(rng.random((n, 3)), jnp.float32)
        return params, (o, d, t, dists, tgt)
    return params, (jnp.asarray(rng.random((n, 2)), jnp.float32),
                    jnp.asarray(rng.random((n, 3)), jnp.float32))


def _train_fn(cfg):
    if isinstance(cfg, NeRFConfig):
        return jax.value_and_grad(lambda p, a: nerf_loss_fn(p, *a, cfg))
    return jax.value_and_grad(lambda p, a: image_fit_loss_fn(p, *a, cfg))


def _render_fn(cfg):
    if isinstance(cfg, NeRFConfig):
        return lambda p, a: render_chunk(cfg, p, a[0], a[1])
    return lambda p, a: ImageFieldModel(cfg).predict_coords(p, a[0])


def _dots(fn, *args):
    text = jax.jit(fn).lower(*args).as_text()
    return [line for line in text.splitlines()
            if "stablehlo.dot_general" in line]


def _follows_contract(line: str, precision: str) -> bool:
    if precision == "highest":
        return "precision = [HIGHEST, HIGHEST]" in line
    if precision == "high":
        return ("lhs_precision_type = bf16" in line
                and "accumulation_type = f32" in line
                and "num_primitive_operations = 6" in line)
    # bf16 operands, fp32 result
    return re.search(r": \(tensor<[0-9x]+xbf16>, tensor<[0-9x]+xbf16>\) -> "
                     r"tensor<[0-9x]+xf32>", line) is not None


@pytest.mark.parametrize("path", ["train", "render"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_precision_contract_in_lowered_program(name, path):
    """Every matmul of the config's train step (forward and backward) and
    of its render runs at the config's precision."""
    cfg = CONFIGS[name]()
    assert cfg.precision == EXPECTED[name]
    params, args = _inputs(cfg)
    fn = _train_fn(cfg) if path == "train" else _render_fn(cfg)
    dots = _dots(fn, params, args)
    # forward: one per layer; backward adds dW and dx (no dx into the
    # encoding, which depends on no parameter)
    want = cfg.num_layers if path == "render" else 3 * cfg.num_layers - 1
    assert len(dots) >= want, dots
    bad = [d for d in dots if not _follows_contract(d, cfg.precision)]
    assert not bad, bad


def test_highest_is_exact_fp32():
    cfg = NeRFConfig()
    assert cfg.precision == "highest"
    params, args = _inputs(cfg)
    dots = _dots(_train_fn(cfg), params, args)
    assert dots and all(_follows_contract(d, "highest") for d in dots)


@pytest.mark.parametrize("path", ["train", "render"])
def test_bf16_flagship_within_stated_bound_of_fp32(path):
    """The flagship at bf16 against itself at exact fp32, held to the bound
    chip_smoke.py states and applies on the card."""
    cfg = NeRFConfig.full()
    ref = NeRFConfig(**{**cfg.__dict__, "precision": "highest"})
    params, args = _inputs(cfg, n=32)
    if path == "train":
        loss, grads = jax.jit(_train_fn(cfg))(params, args)
        loss_r, grads_r = jax.jit(_train_fn(ref))(params, args)
        pred = pred_r = np.zeros(3)
    else:
        loss = loss_r = 1.0
        grads = grads_r = params
        pred = jax.jit(_render_fn(cfg))(params, args)
        pred_r = jax.jit(_render_fn(ref))(params, args)
        assert float(np.max(np.abs(np.asarray(pred) - np.asarray(pred_r)))) \
            > 0.0, "bf16 render identical to fp32: bf16 not applied"
    ok, report = chip_smoke.compare_parity(loss, loss_r, grads, grads_r, pred,
                                           pred_r, "bf16")
    assert ok, report


def test_dense_bf16_gradient_rule(rng):
    """The bf16 backward: dx = bf16(g) @ bf16(w)^T and dW = bf16(x)^T @
    bf16(g), accumulated in fp32."""
    x = jnp.asarray(rng.standard_normal((16, 24)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((24, 8)), jnp.float32)
    g = jnp.asarray(rng.standard_normal((16, 8)), jnp.float32)
    y, vjp = jax.vjp(lambda a, b: dense(a, b, "bf16"), x, w)
    dx, dw = vjp(g)
    assert y.dtype == dx.dtype == dw.dtype == jnp.float32

    def b(a):
        return np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float64)

    np.testing.assert_allclose(np.asarray(y), b(x) @ b(w), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(dx), b(g) @ b(w).T, rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(dw), b(x).T @ b(g), rtol=1e-6,
                               atol=1e-5)


def test_dense_rejects_unknown_precision():
    with pytest.raises(ValueError, match="unknown precision"):
        dense(jnp.ones((2, 2)), jnp.ones((2, 2)), "default")
