"""Profiling / observability hooks.

The reference's only 'tracing' is printing generated C code and
differentiated functions at compile time (compiler.py:133-134,
autodiff.py:307-317).  The JAX analogs provided here:

* :func:`trace` — context manager around ``jax.profiler`` emitting a
  TensorBoard-loadable trace directory,
* :func:`dump_hlo` — compiled-HLO text for a jitted function (the
  'generated code dump' analog),
* :func:`print_lowered` — StableHLO of the traced computation,
* :func:`device_memory_stats` — live/peak device memory,
* :func:`gpu_name_and_power_limit` — what every device number is reported
  beside.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
from typing import Any, Callable, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str = "profile_trace"):
    """Profile everything inside the block; view with TensorBoard."""
    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def dump_hlo(fn: Callable, *example_args, path: Optional[str] = None,
             **example_kwargs) -> str:
    """Compiled HLO text of ``jit(fn)`` on the example arguments."""
    compiled = jax.jit(fn).lower(*example_args, **example_kwargs).compile()
    text = compiled.as_text()
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def print_lowered(fn: Callable, *example_args, **example_kwargs) -> str:
    """StableHLO (pre-optimization) of the traced function."""
    return jax.jit(fn).lower(*example_args, **example_kwargs).as_text()


def cost_analysis(fn: Callable, *example_args, **example_kwargs):
    """XLA cost analysis dict (flops, bytes accessed) for the compiled fn."""
    compiled = jax.jit(fn).lower(*example_args, **example_kwargs).compile()
    return compiled.cost_analysis()


def device_memory_stats(device=None) -> dict:
    d = device or jax.devices()[0]
    stats = getattr(d, "memory_stats", lambda: None)()
    return stats or {}


def gpu_name_and_power_limit() -> Optional[str]:
    """The cards' names and power limits, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them; None where there is no nvidia-smi."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip()
