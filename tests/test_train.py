"""Training-layer tests: optimizer parity, checkpointing, driver smoke runs."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from lomanerf_tpu.train import loma_adam, loma_sgd
from lomanerf_tpu.train.checkpoint import CheckpointManager


def _reference_adam_update(params, grads, m, v, t, lr=5e-4, b1=0.9, b2=0.999,
                           eps=1e-8):
    """Numpy transcription of the reference AdamOptimizer.update semantics
    (train_nerf.py:143-161) for cross-checking."""
    lr_t = lr * (np.sqrt(1 - b2**t) / (1 - b1**t))
    out_p, out_m, out_v = [], [], []
    for p, g, mm, vv in zip(params, grads, m, v):
        mm = b1 * mm + (1 - b1) * g
        vv = b2 * vv + (1 - b2) * g**2
        m_hat = mm / (1 - b1**t)
        v_hat = vv / (1 - b2**t)
        out_p.append(p - lr_t * m_hat / (np.sqrt(v_hat) + eps))
        out_m.append(mm)
        out_v.append(vv)
    return out_p, out_m, out_v


def test_loma_adam_matches_reference_formula(rng):
    params = [rng.standard_normal((4, 3)).astype(np.float32),
              rng.standard_normal(3).astype(np.float32)]
    opt = loma_adam(5e-4)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    m = [np.zeros_like(p) for p in params]
    v = [np.zeros_like(p) for p in params]
    np_params = [p.copy() for p in params]
    for t in range(1, 4):
        grads = [rng.standard_normal(p.shape).astype(np.float32) for p in params]
        updates, state = opt.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        np_params, m, v = _reference_adam_update(np_params, grads, m, v, t)
        for a, b in zip(jp, np_params):
            np.testing.assert_allclose(np.asarray(a), b, rtol=1e-5, atol=1e-6)


def test_loma_adam_differs_from_standard_adam(rng):
    """The reference double-corrects bias; make sure we didn't silently
    implement textbook adam."""
    p = [jnp.asarray(rng.standard_normal(5).astype(np.float32))]
    g = [jnp.asarray(rng.standard_normal(5).astype(np.float32))]
    la, sa = loma_adam(1e-3), optax.adam(1e-3)
    u1, _ = la.update(g, la.init(p), p)
    u2, _ = sa.update(g, sa.init(p), p)
    assert not np.allclose(np.asarray(u1[0]), np.asarray(u2[0]))


def test_checkpoint_roundtrip(tmp_path, rng):
    params = {"w": [jnp.asarray(rng.standard_normal((3, 2)).astype(np.float32))],
              "b": [jnp.asarray(rng.standard_normal(2).astype(np.float32))]}
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(7, params, opt_state)
    assert mgr.latest_step() == 7
    zeros = jax.tree.map(jnp.zeros_like, params)
    zstate = opt.init(zeros)
    rp, rs, step = mgr.restore(zeros, zstate)
    assert step == 7
    for a, b in zip(jax.tree.leaves(rp), jax.tree.leaves(params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
    mgr.close()


def test_fit_image_driver_smoke(tmp_path):
    from lomanerf_tpu.train import fit_image

    fit_image.main([
        "--img", "synthetic", "--img-size", "32", "--steps", "30",
        "--optimizer", "adam", "--lr", "3e-3", "--log-every", "20",
        "--log-dir", str(tmp_path / "logs_2d"),
        "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "0",
    ])
    assert os.path.exists(tmp_path / "logs_2d" / "iter_20.png")
    assert os.path.exists(tmp_path / "logs_2d" / "metrics.jsonl")


def test_train_nerf_converges_psnr(tmp_path, monkeypatch):
    """Convergence regression (hermetic-CPU analog of the reference's
    completed-run evidence in logs_2d/): a short synthetic-scene run must
    lift eval PSNR well above its starting point.  Calibrated headroom:
    this config reaches ~18.5 dB from 10.3 dB in 200 steps."""
    import json

    from lomanerf_tpu.train import train_nerf

    monkeypatch.chdir(tmp_path)
    train_nerf.main([
        "--data", "synthetic", "--img-size", "16", "--steps", "301",
        "--rays-per-batch", "256", "--samples", "8", "--width", "16",
        "--lr", "5e-3", "--eval-every", "100",
        "--log-dir", str(tmp_path / "logs_3d"),
        "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "0",
    ])
    rows = [json.loads(l) for l in
            open(tmp_path / "logs_3d" / "metrics.jsonl")]
    psnrs = [r["psnr"] for r in rows if "psnr" in r]
    assert psnrs[0] < 13.0, "starting PSNR unexpectedly high"
    assert max(psnrs) > 15.0, f"did not converge: {psnrs}"
    assert max(psnrs) > psnrs[0] + 4.0, f"insufficient improvement: {psnrs}"


def test_train_nerf_driver_smoke(tmp_path, monkeypatch):
    from lomanerf_tpu.train import train_nerf

    monkeypatch.chdir(tmp_path)
    train_nerf.main([
        "--data", "synthetic", "--img-size", "16", "--steps", "12",
        "--rays-per-batch", "64", "--samples", "8", "--width", "16",
        "--eval-every", "10",
        "--log-dir", str(tmp_path / "logs_3d"),
        "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "0",
    ])
    assert os.path.exists(tmp_path / "logs_3d" / "10.png")
    # resume path
    train_nerf.main([
        "--data", "synthetic", "--img-size", "16", "--steps", "14",
        "--rays-per-batch", "64", "--samples", "8", "--width", "16",
        "--eval-every", "100",
        "--log-dir", str(tmp_path / "logs_3d"),
        "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "0", "--resume",
    ])


def test_flagship_init_density_alive(rng):
    """The flagship config's init="nerf" must produce LIVE gradients.

    At plain He init the deep 8x256 MLP's density head is dead with
    probability ~1/2 (sigma < 0 for every sample point -> relu' kills every
    gradient path EXACTLY: 0.0 for all 16 leaves).  The fog-start init
    (zero biases, 0.1x head weights, +0.5 density bias — core.mlp.init_mlp)
    keeps alpha > 0 everywhere so the field can learn."""
    import jax
    import jax.numpy as jnp

    from lomanerf_tpu.core import init_mlp, sample_along_rays
    from lomanerf_tpu.models import NeRFConfig
    from lomanerf_tpu.train.steps import nerf_loss_fn

    cfg = NeRFConfig.full()
    assert cfg.init == "nerf"
    n = 8
    params = init_mlp(jax.random.PRNGKey(215), cfg.in_channels,
                      cfg.out_channels, cfg.num_layers, cfg.filter_size,
                      init=cfg.init)
    o = jnp.asarray(rng.standard_normal((n, 3)), jnp.float32)
    d = jnp.asarray(rng.standard_normal((n, 3)), jnp.float32)
    _, tv, dists = sample_along_rays(o, d, cfg.near, cfg.far, cfg.num_samples)
    tgt = jnp.asarray(rng.random((n, 3)), jnp.float32)
    loss, grads = jax.value_and_grad(
        lambda p: nerf_loss_fn(p, o, d, tv, dists, tgt, cfg)
    )(params)
    assert bool(jnp.isfinite(loss))
    gmax = max(float(jnp.abs(g).max()) for g in jax.tree.leaves(grads))
    assert gmax > 1e-6, f"dead init: max |grad| {gmax}"
    # EVERY layer's weight gradient is alive (not just the head)
    for i, g in enumerate(grads["w"]):
        assert float(jnp.abs(g).max()) > 1e-10, f"layer {i} grad is zero"


OPTIONAL_PACKAGES = ("PIL", "PIL.Image", "matplotlib", "matplotlib.pyplot",
                     "orbax", "orbax.checkpoint", "imageio", "imageio.v2",
                     "wandb")


@pytest.fixture
def no_optional_packages(monkeypatch):
    """Make the optional packages unimportable, as on a machine without
    them, and re-import the modules that probe for them at import time."""
    import importlib
    import sys

    from lomanerf_tpu.train import checkpoint, logging_utils

    for name in OPTIONAL_PACKAGES:
        monkeypatch.setitem(sys.modules, name, None)
    importlib.reload(checkpoint)
    importlib.reload(logging_utils)
    assert not checkpoint._HAVE_ORBAX
    yield
    monkeypatch.undo()
    importlib.reload(checkpoint)
    importlib.reload(logging_utils)


def test_train_nerf_without_optional_packages(tmp_path, monkeypatch,
                                              no_optional_packages, capsys):
    """--data synthetic, the PNG logs and a resume through the numpy
    checkpoint need nothing beyond the core dependencies."""
    from lomanerf_tpu.train import train_nerf

    monkeypatch.chdir(tmp_path)
    common = ["--data", "synthetic", "--img-size", "12",
              "--rays-per-batch", "32", "--samples", "8", "--width", "16",
              "--log-dir", str(tmp_path / "logs"),
              "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "0"]
    first = train_nerf.main(common + ["--steps", "4", "--eval-every", "3"])
    assert (tmp_path / "ck" / "ckpt_4.npz").exists()
    assert (tmp_path / "logs" / "3.png").exists()
    assert len(first["losses"]) == 4 and len(first["eval_s"]) == 2
    second = train_nerf.main(common + ["--steps", "6", "--eval-every", "100",
                                       "--resume"])
    assert "resumed from step 4" in capsys.readouterr().out
    assert len(second["losses"]) == 2
    assert (tmp_path / "ck" / "ckpt_6.npz").exists()


def test_fit_image_without_optional_packages(tmp_path, no_optional_packages,
                                             capsys):
    from lomanerf_tpu.train import fit_image

    common = ["--img", "synthetic", "--img-size", "16", "--optimizer",
              "adam", "--lr", "3e-3", "--log-every", "2",
              "--log-dir", str(tmp_path / "logs"),
              "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "0"]
    first = fit_image.main(common + ["--steps", "3"])
    assert np.isfinite(first["psnr"]) and len(first["step_s"]) == 3
    assert (tmp_path / "logs" / "iter_2.png").exists()
    fit_image.main(common + ["--steps", "5", "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert (tmp_path / "ck" / "ckpt_5.npz").exists()


def test_write_png_decodes_to_the_image(tmp_path, rng):
    """The stdlib PNG writer, decoded without any image library."""
    import struct
    import zlib

    from lomanerf_tpu.train.logging_utils import write_png

    img = rng.random((5, 7, 3)).astype(np.float32)
    write_png(str(tmp_path / "a.png"), img)
    data = (tmp_path / "a.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, dims = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            dims = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    assert dims == (7, 5)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(5, 1 + 21)
    assert np.all(rows[:, 0] == 0)
    want = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(rows[:, 1:].reshape(5, 7, 3), want)


def test_synthetic_views_match_written_dataset(tmp_path):
    """What train_nerf --data synthetic trains on is what a written
    Blender-format copy of the scene reads back as (up to 8-bit PNGs)."""
    from lomanerf_tpu.data import NeRFDataset, synthetic_views, \
        write_blender_dataset

    images, poses, focal = synthetic_views(n_frames=3, img_size=10)
    write_blender_dataset(str(tmp_path), n_frames=3, img_size=10)
    ds = NeRFDataset(str(tmp_path), img_size=10)
    assert len(ds) == 3 and ds.focal_length == pytest.approx(focal)
    for i in range(3):
        np.testing.assert_allclose(ds[i]["image"], images[i], atol=1 / 255)
        np.testing.assert_allclose(ds[i]["pose"], poses[i], atol=1e-6)
