"""Pre-compile the loma CPU oracle into _oracle/ (untimed).

The reference's parse -> autodiff -> gcc pipeline takes minutes for the NeRF
kernel (reverse_diff emits tens of MB of statically-taped C); running it
inside a timed benchmark window distorts it.  Run this once
(no timeout pressure), then ``bench.py --live-baseline`` and the parity
tests load the cached .so instantly (parity/oracle.get_lib fast path).

Pure CPU / no jax — safe to run alongside a process that holds the GPU.
"""

import sys
import time

sys.path.insert(0, "/root/repo")

from lomanerf_tpu.parity import oracle

if not oracle.oracle_available():
    print("reference not present; nothing to do")
    sys.exit(0)

for kernel in ("mlp_fit", "nerf"):
    t0 = time.perf_counter()
    oracle.get_lib(kernel)
    print(f"{kernel}: ready in {time.perf_counter() - t0:.1f}s")
