"""Mesh-sharded full-image rendering (BASELINE config 5).

The train step shards rays over the ``data`` mesh axis
(parallel/train_step.py); this module gives the EVAL/render path the same
layout: a frame's rays are split into fixed-size chunks, the chunk list is
sharded over the mesh, each device scans ITS chunks through the pipeline,
and the full frame is reassembled in-program by a tiled ``all_gather``.
This replaces the reference's serial chunk loop in its eval pass
(/root/reference/train_nerf.py:558-712): "800x800 renders with rays
sharded across N devices" = N devices each render 1/N of the frame's
chunks concurrently; the all-gather moves 7.7 MB for an 800x800 fp32
frame, small next to the per-chunk MLP work.

Multi-host: every process computes the (tiny) ray grid from (K, c2w)
identically, and ``jax.make_array_from_callback`` places each host's chunk
shards on its local devices — no cross-host input movement.  The output is
fully replicated, so every process can read the frame locally (process 0
writes it).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P



def sharded_render_fn(config, mesh: Mesh, axis: str = "data"):
    """The UNJITTED sharded render: (params, oc, dc) -> (N, 3) colors.

    ``oc``/``dc`` are (n_chunks, chunk, 3) ray-chunk stacks with n_chunks
    divisible by the mesh's ``axis`` size, sharded on the leading dim;
    params are replicated.  Output is the fully-assembled, replicated color
    block.  Exposed unjitted so callers (bench.py, the jitted step below)
    can embed it in their own programs.
    """
    from lomanerf_tpu.models.nerf import render_chunk  # lazy: no import cycle

    def local_render(params, oc, dc):
        def body(_, od):
            o, d = od
            return None, render_chunk(config, params, o, d)

        _, cols = jax.lax.scan(body, None, (oc, dc))
        cols = cols.reshape(-1, 3)
        # reassemble the frame: device i rendered chunks [i*k, (i+1)*k)
        return jax.lax.all_gather(cols, axis, tiled=True)

    return jax.shard_map(
        local_render, mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=P(), check_vma=False,
    )


def make_render_step(config, mesh: Mesh, axis: str = "data"):
    """Jitted mesh-sharded render step: (params, oc, dc) -> (N, 3)."""
    return jax.jit(sharded_render_fn(config, mesh, axis))


def shard_ray_chunks(mesh: Mesh, o, d, chunk: int, axis: str = "data"):
    """Pad (N, 3) rays to a whole number of chunks per device and place the
    (n_chunks, chunk, 3) stacks on the mesh, chunk-sharded over ``axis``.

    Works on one process (sharded device_put) and on a multi-host mesh
    (every host holds the same full ray set; the callback hands each device
    its own chunk rows)."""
    o = np.asarray(o, dtype=np.float32)
    d = np.asarray(d, dtype=np.float32)
    n = o.shape[0]
    quantum = chunk * mesh.shape[axis]
    n_pad = -(-n // quantum) * quantum
    oc = np.pad(o, ((0, n_pad - n), (0, 0))).reshape(-1, chunk, 3)
    dc = np.pad(d, ((0, n_pad - n), (0, 0))).reshape(-1, chunk, 3)
    sh = NamedSharding(mesh, P(axis))
    oc, dc = (
        jax.make_array_from_callback(x.shape, sh, lambda idx, x=x: x[idx])
        for x in (oc, dc)
    )
    return oc, dc, n


def sharded_render_image(params, K, c2w, img_size: int, mesh: Mesh, step,
                         chunk: int = 4096, axis: str = "data"):
    """Render a full (img_size, img_size, 3) frame with rays sharded over
    the mesh.  ``step`` comes from :func:`make_render_step` (cached by the
    caller so repeated evals reuse one executable)."""
    from lomanerf_tpu.core import rays

    o, d = rays.get_rays(img_size, img_size, K, c2w)
    oc, dc, n = shard_ray_chunks(mesh, o, d, chunk, axis)
    cols = step(params, oc, dc)
    return cols[:n].reshape(img_size, img_size, 3)
