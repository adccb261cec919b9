"""Single-pendulum simulation driven by forward-mode DSL derivatives.

Capability parity with loma_public/examples/single_pendulum_fwd.py: the
Hamiltonian is a DSL function over a struct config; its partials dH/dq and
dH/dp are themselves DSL functions that build ``Diff[...]`` duals
(struct-of-duals) and call the ``fwd_diff`` function from DSL code; the host
integrates with symplectic Euler and writes a trajectory plot.

Run: python examples/single_pendulum.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import math

import numpy as np

from lomanerf_tpu import dsl

CODE = """
class PendulumConfig:
    mass : float
    radius : float
    g : float

def hamiltonian(q : In[float], p : In[float],
                c : In[PendulumConfig]) -> float:
    K : float = p * p / (c.mass * c.radius * c.radius)
    U : float = c.mass * c.g * (0.0 - c.radius * cos(q))
    return K + U

d_hamiltonian = fwd_diff(hamiltonian)

def dHdq(q : In[float], p : In[float], c : In[PendulumConfig]) -> float:
    d_q : Diff[float]
    d_q.val = q
    d_q.dval = 1.0
    d_p : Diff[float]
    d_p.val = p
    d_c : Diff[PendulumConfig]
    d_c.mass.val = c.mass
    d_c.radius.val = c.radius
    d_c.g.val = c.g
    return d_hamiltonian(d_q, d_p, d_c).dval

def dHdp(q : In[float], p : In[float], c : In[PendulumConfig]) -> float:
    d_q : Diff[float]
    d_q.val = q
    d_p : Diff[float]
    d_p.val = p
    d_p.dval = 1.0
    d_c : Diff[PendulumConfig]
    d_c.mass.val = c.mass
    d_c.radius.val = c.radius
    d_c.g.val = c.g
    return d_hamiltonian(d_q, d_p, d_c).dval
"""


def main():
    _, lib = dsl.compile(CODE)
    cfg = {"mass": 1.0, "radius": 20.0, "g": 9.8}
    q, p = math.pi / 4, 0.0
    ts, steps = 0.01, 600
    traj = []
    for _ in range(steps):
        # symplectic Euler: advance p with dH/dq, then q with dH/dp(new p)
        p = p - ts * lib.dHdq(q, p, cfg)
        q = q + ts * lib.dHdp(q, p, cfg)
        traj.append(q)
    traj = np.asarray(traj)
    print(f"q range over {steps} steps: [{traj.min():.4f}, {traj.max():.4f}]")
    # energy-ish sanity: symplectic Euler keeps |q| bounded by the start
    assert abs(traj).max() <= math.pi / 4 + 0.05, "pendulum diverged"
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.plot(np.arange(steps) * ts, traj)
        plt.xlabel("t [s]")
        plt.ylabel("q [rad]")
        plt.title("single pendulum (DSL fwd-diff Hamiltonian partials)")
        out = os.path.join(os.path.dirname(__file__), "single_pendulum.png")
        plt.savefig(out, dpi=80)
        print("wrote", out)
    except Exception:  # matplotlib optional
        pass


if __name__ == "__main__":
    main()
