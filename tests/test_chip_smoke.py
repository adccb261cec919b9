"""The parts of chip_smoke.py that run without a GPU, and the compile
cache it and the drivers share."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import chip_smoke
from lomanerf_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_refuses_without_gpu(tmp_path, where):
    """No GPU (or no repo beside the script): non-zero exit, no result."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, script], capture_output=True,
                       text=True, timeout=120, env=env,
                       cwd=os.path.dirname(script))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_compile_cache_follows_environment(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_fixed_checkout_path(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_result_line_format():
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB "
                            "HBM3")] * 4
    line = chip_smoke.result_line(devs)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


@pytest.mark.parametrize("multi", [False, True])
def test_multi_selects_only_its_phases(multi):
    names = chip_smoke.phases(multi)
    assert names == (chip_smoke.MULTI_PHASES if multi
                     else chip_smoke.SINGLE_PHASES)
    assert all(n.startswith("multi") == multi for n in names)
    assert all(callable(getattr(chip_smoke, f"phase_{n}")) for n in names)


def _grads(scale, n=64, seed=0):
    g = np.random.default_rng(seed).standard_normal(n)
    return {"w": [g * scale]}


@pytest.mark.parametrize("precision,perturb,ok", [
    ("high", 1e-6, True),
    ("high", 1e-2, False),
    ("bf16", 1e-3, True),
    ("bf16", 5e-2, False),
])
def test_compare_parity_holds_its_tolerances(precision, perturb, ok):
    want = _grads(1.0)
    noise = np.random.default_rng(1).standard_normal(64)
    got = {"w": [want["w"][0] * (1.0 + perturb * noise)]}
    pred = np.linspace(0.0, 1.0, 30).reshape(10, 3)
    res, report = chip_smoke.compare_parity(
        10.0 * (1.0 + perturb), 10.0, got, want, pred * (1.0 + perturb),
        pred, precision)
    assert res == ok, report


def test_ray_shard_check_on_a_sharded_batch(rng):
    """Each of the 8 devices holds its own eighth of a sharded batch."""
    from lomanerf_tpu.parallel import RayBatch, make_mesh, shard_batch

    mesh = make_mesh(dp=8, tp=1)
    rows = rng.standard_normal((64, 3)).astype(np.float32)
    batch = shard_batch(mesh, RayBatch(rows, rows, np.zeros(4, np.float32),
                                       np.zeros(4, np.float32), rows))
    chip_smoke._check_ray_shards(batch.origins, 8, rows, "origins")
    with pytest.raises(AssertionError):
        chip_smoke._check_ray_shards(batch.origins, 8, rows[::-1].copy(),
                                     "origins")
