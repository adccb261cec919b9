"""Differentiable sphere raytracer in the DSL (struct support demo).

Capability parity with loma_public/examples/raytrace.py / diff_raytrace.py
(Vec3/Sphere struct DSL raytracer): render a sphere via ray-sphere
intersection written in the DSL with structs, and differentiate the pixel
intensity w.r.t. the sphere position with ``rev_diff``.

Run: python examples/diff_raytrace.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from lomanerf_tpu import dsl

CODE = """
class Vec3:
    x : float
    y : float
    z : float

class Sphere:
    center : Vec3
    radius : float

def intensity(sph : In[Sphere], ox : In[float], oy : In[float]) -> float:
    # orthographic ray from (ox, oy, -10) along +z; soft hit via smooth
    # distance to the sphere surface (differentiable everywhere)
    dx : float = ox - sph.center.x
    dy : float = oy - sph.center.y
    d2 : float = dx * dx + dy * dy
    r2 : float = sph.radius * sph.radius
    s : float = 0
    s = r2 - d2
    # softplus-like shading: exp keeps it smooth for the gradient
    return 1.0 / (1.0 + exp(0.0 - 20.0 * s))

d_intensity = rev_diff(intensity)
"""


def main():
    _, lib = dsl.compile(CODE)
    sphere = {"center": {"x": 0.2, "y": -0.1, "z": 0.0}, "radius": 0.5}

    size = 24
    img = np.zeros((size, size), np.float32)
    for j, y in enumerate(np.linspace(-1, 1, size)):
        for i, x in enumerate(np.linspace(-1, 1, size)):
            img[j, i] = lib.intensity(sphere, float(x), float(y))
    print("rendered sphere, mean intensity:", img.mean())
    assert img.max() > 0.9 and img.min() < 0.1

    # gradient of one pixel's intensity w.r.t. the sphere parameters
    d_sph = {
        "center": {"x": np.zeros((), np.float32),
                   "y": np.zeros((), np.float32),
                   "z": np.zeros((), np.float32)},
        "radius": np.zeros((), np.float32),
    }
    dox = np.zeros((), np.float32)
    doy = np.zeros((), np.float32)
    adj = lib.d_intensity(sphere, d_sph, 0.45, dox, 0.0, doy, 1.0)
    g = adj["sph"]
    gx = float(np.asarray(g["center"]["x"]))
    gr = float(np.asarray(g["radius"]))
    print(f"d(intensity)/d(center.x) = {gx:.4f}, d/d(radius) = {gr:.4f}")
    # pixel right of center: moving the sphere right increases intensity
    assert gx > 0 and gr > 0


if __name__ == "__main__":
    main()
