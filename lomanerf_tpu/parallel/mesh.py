"""Device mesh construction + multi-host initialization.

Replacement for the reference's entire parallelism surface (the
``@simd``/``atomic_add``/tasksys.cpp stack, SURVEY.md §2.2): rays are data-
parallel across a ``Mesh`` axis, optionally with a tensor-parallel axis for
wide-MLP configs; gradient reduction is ``lax.psum`` across devices.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    dp: Optional[int] = None,
    tp: int = 1,
    devices: Optional[Sequence] = None,
    axis_names: Tuple[str, str] = ("data", "model"),
) -> Mesh:
    """Build a (data, model) mesh.

    ``dp=None`` uses all remaining devices for data parallelism.  The
    layout follows the algorithm alone: the cards of one host are joined
    all to all, so no axis order is faster than another.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp * tp > n:
        raise ValueError(f"dp*tp={dp * tp} exceeds {n} devices")
    arr = np.array(devices[: dp * tp]).reshape(dp, tp)
    return Mesh(arr, axis_names)


def data_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D all-data-parallel mesh."""
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), ("data",))


def initialize_multihost(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host init (jax.distributed).

    No-op when already initialized (e.g. a cluster runtime that pre-wires
    ``jax.distributed``).  With an explicit ``coordinator`` (or the standard
    ``JAX_COORDINATOR_ADDRESS`` env var) it joins/forms the cluster; on a
    plain single host with neither it is a no-op.

    Must run before anything touches the XLA backend — including
    ``jax.process_count()``, so the already-initialized probe uses
    ``jax.distributed.is_initialized`` (which does not poke the backend),
    not a process-count check."""
    import os

    if jax.distributed.is_initialized():
        return
    if coordinator is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    elif os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize()


def is_primary() -> bool:
    """True on the process that owns host-side writes (metrics, images,
    non-collective checkpoint fallbacks)."""
    return jax.process_index() == 0


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())


def ray_sharding(mesh: Mesh, axis: str = "data"):
    """Shard the leading (ray) dimension over the data axis."""
    return NamedSharding(mesh, P(axis))


def _leaf_sharding(mesh: Mesh, x, axis: str):
    """Per-ray (rank >= 2) leaves shard on the leading axis; 1-D leaves
    (e.g. the (S,) uniform t_vals/dists of unjittered sampling) are
    replicated — every shard needs all S depths."""
    return NamedSharding(mesh, P(axis) if np.ndim(x) >= 2 else P())


def host_local_batch_to_global(mesh: Mesh, batch, axis: str = "data"):
    """Assemble GLOBAL ray-sharded arrays from each host's LOCAL batch.

    Every host produces its own disjoint slice of the step's rays (the
    driver partitions the RNG stream per process); this stitches those
    per-host slices into global jax.Arrays of leading dimension
    ``process_count * local_n`` via
    ``jax.make_array_from_process_local_data`` — no cross-host data
    movement, each host's rows land on its local devices.  1-D leaves are
    replicated (every host passes the identical full array)."""
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(
            _leaf_sharding(mesh, x, axis), np.asarray(x)),
        batch,
    )


def shard_batch(mesh: Mesh, batch, axis: str = "data"):
    """Place a per-host batch pytree onto the mesh with rays sharded on
    ``axis`` (1-D leaves replicated): a plain sharded device_put on one
    host, the process-local global-array assembly on a multi-host mesh."""
    if jax.process_count() > 1:
        return host_local_batch_to_global(mesh, batch, axis)
    return jax.tree.map(
        lambda x: jax.device_put(x, _leaf_sharding(mesh, x, axis)), batch)
