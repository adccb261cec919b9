"""Sharded training steps: shard_map over a (data[, model]) mesh.

Rays are sharded on the ``data`` axis (they are independent — the structural
analog of the reference's host-side ray chunking, train_nerf.py:275-286, done
properly); params are replicated across ``data`` and optionally sharded over
``model`` (see parallel.tp).  Weight-gradient reduction is ``lax.psum`` over
the device interconnect — the replacement for loma's ``atomic_add`` adjoint
accumulation (reverse_diff.py:144-155).  XLA's latency-hiding scheduler
overlaps the per-layer psums with the remaining backward compute.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from lomanerf_tpu.core import pipeline
from lomanerf_tpu.core.mlp import Params, mlp_apply
from lomanerf_tpu.parallel.tp import tp_mlp_apply, tp_param_specs


class RayBatch(NamedTuple):
    """One training batch of rays (leading dim sharded over ``data``).

    ``t_vals``/``dists`` are per-ray ``(N, S)`` for stratified sampling, or
    ``(S,)`` replicated for uniform depths (the unjittered
    sample_along_rays contract — pass ``uniform_depths=True`` to
    make_train_step so their shard_map specs replicate)."""

    origins: jnp.ndarray  # (N, 3)
    directions: jnp.ndarray  # (N, 3)
    t_vals: jnp.ndarray  # (N, S) or (S,)
    dists: jnp.ndarray  # (N, S) or (S,)
    target: jnp.ndarray  # (N, 3)


def _mirror_spec(opt_state, params, p_spec):
    """PartitionSpec tree for an optax state.

    Optimizer moments (adam m/v, momentum, ...) are sub-trees STRUCTURALLY
    EQUAL to the param tree — same treedef and same leaf shapes.  Each such
    subtree mirrors ``p_spec`` wholesale; every other leaf (step counts,
    scalars) is replicated.  Structural matching (rather than key-path
    suffix matching) stays correct for nested/chained optimizers whose
    state paths collide or nest, e.g. ``optax.chain`` of several
    scale-by-adam-like transforms."""
    pdef = jax.tree.structure(params)
    p_shapes = [jnp.shape(x) for x in jax.tree.leaves(params)]

    def is_param_like(node):
        try:
            if jax.tree.structure(node) != pdef:
                return False
            return [jnp.shape(x) for x in jax.tree.leaves(node)] == p_shapes
        except Exception:  # non-pytree odds and ends
            return False

    def spec_for(node):
        if is_param_like(node):
            return p_spec
        return jax.tree.map(lambda _: P(), node)

    return jax.tree.map(spec_for, opt_state, is_leaf=is_param_like)


def state_specs(config, params, opt_state, tp: bool = False):
    """(param_spec, opt_state_spec) PartitionSpec trees for the train state."""
    if tp:
        p_spec = tp_param_specs(config.num_layers)
    else:
        p_spec = jax.tree.map(lambda _: P(), params)
    return p_spec, _mirror_spec(opt_state, params, p_spec)


def place_state(mesh: Mesh, config, params, opt_state, tp: bool = False):
    """Device-put (params, opt_state) onto the mesh with train-step sharding
    (replicated over data, TP-sharded over model).  Needed e.g. after a
    checkpoint restore, which leaves arrays committed to one device."""
    from jax.sharding import NamedSharding

    p_spec, o_spec = state_specs(config, params, opt_state, tp)
    params = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
        p_spec,
    )
    opt_state = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), opt_state,
        o_spec,
    )
    return params, opt_state


def make_train_step(
    config,
    optimizer: optax.GradientTransformation,
    mesh: Mesh,
    params: Params,
    opt_state,
    tp: bool = False,
    donate: bool = True,
    uniform_depths: bool | None = None,
):
    """Build a jitted sharded NeRF train step.

    Args:
        config: NeRFConfig.
        params / opt_state: example pytrees (for sharding-spec derivation;
            their values are not captured).
        tp: also tensor-parallel the MLP over the ``model`` mesh axis.
        uniform_depths: batches carry (S,) t_vals/dists shared by all rays
            (replicated over the mesh) instead of per-ray (N, S).  Default
            None infers it from ``batch.t_vals.ndim`` at call time (static
            under jit), so the default ``sample_along_rays`` output and
            per-ray pipelines both compose without flags.

    Returns:
        ``step(params, opt_state, batch) -> (params, opt_state, loss)``.
    """
    mlp_fn = functools.partial(tp_mlp_apply, axis_name="model") if tp \
        else mlp_apply
    p_spec, o_spec = state_specs(config, params, opt_state, tp)

    def local_step(params, opt_state, batch):
        def loss_fn(p):
            return pipeline.nerf_loss_rays(
                p, batch.origins, batch.directions, batch.t_vals,
                batch.dists, batch.target,
                num_functions=config.num_encoding_functions,
                mode=config.mode, precision=config.precision, mlp=mlp_fn,
            )

        loss, grads = jax.value_and_grad(loss_fn)(params)
        # gradient all-reduce over the ray shards (the analog of loma's
        # atomic_add adjoint accumulation)
        grads = jax.lax.psum(grads, "data")
        loss = jax.lax.psum(loss, "data")
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    _variants: dict = {}

    def _sharded_for(uniform: bool):
        if uniform not in _variants:
            d_spec = P() if uniform else P("data")
            batch_spec = RayBatch(P("data"), P("data"), d_spec, d_spec,
                                  P("data"))
            # replication checker off: the step psums explicitly, and the
            # tp collectives carry their own gradient rules (parallel/tp.py)
            sharded = jax.shard_map(
                local_step, mesh=mesh,
                in_specs=(p_spec, o_spec, batch_spec),
                out_specs=(p_spec, o_spec, P()), check_vma=False,
            )
            _variants[uniform] = jax.jit(
                sharded, donate_argnums=(0, 1) if donate else ()
            )
        return _variants[uniform]

    if uniform_depths is not None:
        return _sharded_for(uniform_depths)

    def step(params, opt_state, batch):
        # t_vals rank is static: (S,) = depths shared by all rays
        # (replicated spec), (N, S) = per-ray (sharded on "data")
        return _sharded_for(batch.t_vals.ndim == 1)(params, opt_state, batch)

    return step
