"""Utilities: profiling/observability hooks, the compile cache."""

from lomanerf_tpu.utils.cache import enable_compile_cache  # noqa: F401

from lomanerf_tpu.utils.profiling import (  # noqa: F401
    cost_analysis,
    device_memory_stats,
    dump_hlo,
    gpu_name_and_power_limit,
    print_lowered,
    trace,
)
