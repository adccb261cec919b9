"""Tests that need an NVIDIA GPU: each config's loss, gradients and render
on the card against the exact fp32 reference on the host CPU, at the
tolerances chip_smoke.py states.  They skip where JAX finds no GPU; run
them on a card with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m
gpu``."""

import pytest

import chip_smoke

CASES = dict(chip_smoke._parity_cases())


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_config_on_gpu_matches_fp32_reference(gpu, name):
    ok, report, _ = chip_smoke.parity_case(CASES[name])
    assert ok, report
