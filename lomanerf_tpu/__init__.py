"""lomanerf_tpu — a differentiable NeRF / neural-field framework on JAX/XLA.

A from-scratch JAX/XLA re-design of the capabilities of the reference
``loma-nerf`` project (an educational differentiable-programming DSL driving a
CPU NeRF).  The loma DSL + C/ISPC/OpenCL compiler stack collapses here into:

* ``core``     — pure-jnp semantic ops (the CPU-runnable oracle layer)
* ``models``   — NeRF / image-field MLP model families
* ``parallel`` — jax.sharding Mesh + shard_map data/tensor parallelism
* ``data``     — Blender-synthetic dataset loader, ray generation, batching
* ``train``    — optimizers, train drivers, checkpointing, metrics, logging
* ``parity``   — harness that drives the reference loma CPU compiler as a
                 golden oracle (images + gradients allclose)
* ``dsl``      — a loma-compatible DSL front-end that lowers to JAX instead of
                 C/ISPC/OpenCL (capability parity with loma_public/compiler.py)
"""

__version__ = "0.1.0"

from lomanerf_tpu.core import (  # noqa: F401
    positional_encoding,
    init_mlp,
    mlp_apply,
    render_weights,
    accumulate_color,
    sum_mse,
    psnr,
    get_rays,
    sample_along_rays,
    stratified_ray_offsets,
)
