"""Tensor-parallel MLP (Megatron-style column/row alternation).

For wide configs (the 8x256 "full NeRF"), hidden layers are sharded over the
``model`` mesh axis: even layers column-parallel (output features sharded),
odd layers row-parallel (input features sharded) with a single ``psum`` per
pair.  Elementwise ReLU runs on the column-sharded activations, so only row
layers communicate.  This is new scope vs the reference (which has no model
parallelism at all — SURVEY.md §2.2 "strategies NOT present").

All functions here run *inside* ``shard_map``; params are the local shards.
The steps run shard_map with the replication checker off, and there the
transpose of ``psum`` is ``psum`` and that of ``all_gather`` is a
reduce-scatter — both wrong for a cotangent that is already replicated.
So each collective here carries its own gradient rule (Megatron's f / g).
"""

from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from lomanerf_tpu.core.mlp import Params, _apply_head, dense


def tp_param_specs(num_layers: int) -> Params:
    """PartitionSpecs for TP params: even layers column-sharded
    (W: (in, out/tp), b: (out/tp)), odd layers row-sharded
    (W: (in/tp, out), b replicated)."""
    w_specs: List[P] = []
    b_specs: List[P] = []
    for i in range(num_layers):
        if i % 2 == 0:
            w_specs.append(P(None, "model"))
            b_specs.append(P("model"))
        else:
            w_specs.append(P("model", None))
            b_specs.append(P())
    return {"w": w_specs, "b": b_specs}


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _to_columns(x, axis_name):
    """Identity forward; backward all-reduces the partial input gradients
    of a column layer (Megatron's f)."""
    return x


_to_columns.defvjp(lambda x, axis_name: (x, None),
                   lambda axis_name, _, g: (jax.lax.psum(g, axis_name),))


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _sum_rows(z, axis_name):
    """All-reduce of a row layer's partial products; backward passes the
    replicated cotangent through unchanged (Megatron's g)."""
    return jax.lax.psum(z, axis_name)


_sum_rows.defvjp(lambda z, axis_name: (jax.lax.psum(z, axis_name), None),
                 lambda axis_name, _, g: (g,))


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _gather_columns(y, axis_name):
    """Tiled all-gather of column-sharded features; backward keeps this
    shard's slice of the replicated cotangent."""
    return jax.lax.all_gather(y, axis_name, axis=-1, tiled=True)


def _gather_columns_fwd(y, axis_name):
    return _gather_columns(y, axis_name), y.shape[-1]


def _gather_columns_bwd(axis_name, width, g):
    start = jax.lax.axis_index(axis_name) * width
    return (jax.lax.dynamic_slice_in_dim(g, start, width, axis=-1),)


_gather_columns.defvjp(_gather_columns_fwd, _gather_columns_bwd)


def tp_mlp_apply(
    params: Params,
    x: jnp.ndarray,
    head: str = "rgba",
    axis_name: str = "model",
    precision: str = "highest",
) -> jnp.ndarray:
    """Forward the TP-sharded MLP on replicated activations ``x``.

    Column layer i: ``y_loc = x @ W_loc + b_loc`` (output sharded).
    Row layer i:    ``y = psum(x_loc @ W_loc) + b`` (output replicated).
    ReLU between layers runs wherever the activation lives (elementwise).
    The head must see full features, so an odd number of layers ends with
    a column layer whose output is all-gathered over the model axis.
    """
    n = len(params["w"])
    y = x
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        if i % 2 == 0:
            y = dense(_to_columns(y, axis_name), w, precision) + b
            if i == n - 1:
                # last layer landed column-parallel: all-gather over the
                # model axis so the head sees full features
                return _apply_head(_gather_columns(y, axis_name), head)
        else:
            y = _sum_rows(dense(y, w, precision), axis_name) + b
        if i < n - 1:
            y = jnp.maximum(y, 0.0)
        else:
            y = _apply_head(y, head)
    return y


def shard_tp_params(params: Params, num_layers: int, tp: int, tp_index: int) -> Params:
    """Slice full params into the shard owned by ``tp_index`` (host-side
    helper for tests / checkpoint resharding)."""
    out_w, out_b = [], []
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        if i % 2 == 0:
            step = w.shape[1] // tp
            out_w.append(w[:, tp_index * step : (tp_index + 1) * step])
            out_b.append(b[tp_index * step : (tp_index + 1) * step])
        else:
            step = w.shape[0] // tp
            out_w.append(w[tp_index * step : (tp_index + 1) * step, :])
            out_b.append(b)
    return {"w": out_w, "b": out_b}
