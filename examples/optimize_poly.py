"""Newton's method on a polynomial via DSL derivatives.

Capability parity with the reference's compiler demos
(loma_public/examples/optimize_poly_{fwd,rev,hess}.py): minimize
f(x) = x^4 - 3x^3 + 2 using first derivatives from ``fwd_diff``/``rev_diff``
and the second derivative from the rev-over-fwd composition
(third_order_poly_hess.py:23-45 pattern) — all running on XLA.

Run: python examples/optimize_poly.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from lomanerf_tpu import dsl

CODE = """
def poly(x : In[float]) -> float:
    return x * x * x * x - 3.0 * x * x * x + 2.0

d_poly = fwd_diff(poly)
grad_poly = rev_diff(poly)
hess_poly = rev_diff(d_poly)
"""


def main():
    _, lib = dsl.compile(CODE)

    def f(x):
        return lib.poly(float(x))

    def df(x):
        # forward mode: seed dval = 1
        return lib.d_poly(dsl.make__dfloat(x, 1.0))["dval"]

    def df_rev(x):
        dx = np.zeros((), np.float32)
        return float(lib.grad_poly(float(x), dx, 1.0)["x"])

    def d2f(x):
        # rev over fwd: cotangent on the dual return's dval extracts f''
        dxd = {"val": np.zeros((), np.float32), "dval": np.zeros((), np.float32)}
        adj = lib.hess_poly(
            dsl.make__dfloat(x, 1.0), dxd, {"val": 0.0, "dval": 1.0}
        )
        return float(np.asarray(adj["x"]["val"]))

    x = 3.0
    for it in range(12):
        g, h = df(x), d2f(x)
        assert np.isclose(g, df_rev(x), rtol=1e-3, atol=1e-4), (g, df_rev(x))
        step = g / h
        x -= step
        print(f"iter {it}: x={x:.6f} f={f(x):.6f} f'={g:.5f} f''={h:.5f}")
        if abs(step) < 1e-6:
            break
    # analytic minimum of x^4 - 3x^3 + 2 is at x = 9/4
    assert np.isclose(x, 2.25, atol=1e-4), x
    print("converged to x =", x, "(analytic 9/4)")


if __name__ == "__main__":
    main()
