"""Hamiltonian gradients for a mass-spring system via DSL reverse mode.

Capability parity with loma_public/examples/mass_spring_rev[_loop].py:
symplectic Euler integration where the force comes from ``rev_diff`` of the
Hamiltonian (dH/dq), run over a bounded loop.

Run: python examples/mass_spring.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from lomanerf_tpu import dsl

CODE = """
def hamiltonian(q : In[Array[float, 2]], p : In[Array[float, 2]],
                k : In[float], m : In[float]) -> float:
    # H = |p|^2 / (2m) + 0.5 k |q - rest|^2 with rest at (1, 0)
    dq0 : float = q[0] - 1.0
    dq1 : float = q[1]
    return (p[0] * p[0] + p[1] * p[1]) / (2.0 * m) + \
        0.5 * k * (dq0 * dq0 + dq1 * dq1)

grad_h = rev_diff(hamiltonian)
"""


def main():
    _, lib = dsl.compile(CODE)
    k, m, dt = 4.0, 1.0, 0.01
    q = np.array([1.5, 0.2], np.float32)
    p = np.zeros(2, np.float32)
    e0 = lib.hamiltonian(q, p, k, m)
    for step in range(500):
        dq = np.zeros(2, np.float32)
        dp = np.zeros(2, np.float32)
        dk = np.zeros((), np.float32)
        dm = np.zeros((), np.float32)
        lib.grad_h(q, dq, p, dp, k, dk, m, dm, 1.0)
        # symplectic Euler: momentum first, then position with the UPDATED
        # momentum (dH/dp = p/m for this separable H)
        p = p - dt * dq
        q = q + dt * p / m
        if step % 100 == 0:
            print(f"step {step}: q={q} H={lib.hamiltonian(q, p, k, m):.5f}")
    e1 = lib.hamiltonian(q, p, k, m)
    # symplectic Euler approximately conserves energy
    assert abs(e1 - e0) / e0 < 0.05, (e0, e1)
    print(f"energy drift over 500 steps: {abs(e1-e0)/e0:.3%} (H0={e0:.5f})")


if __name__ == "__main__":
    main()
