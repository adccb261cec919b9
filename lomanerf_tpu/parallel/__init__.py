"""Mesh + collectives parallelism (data-parallel rays, tensor-parallel MLP)."""

from lomanerf_tpu.parallel.mesh import (  # noqa: F401
    data_mesh,
    host_local_batch_to_global,
    initialize_multihost,
    is_primary,
    make_mesh,
    ray_sharding,
    replicated,
    shard_batch,
)
from lomanerf_tpu.parallel.tp import (  # noqa: F401
    shard_tp_params,
    tp_mlp_apply,
    tp_param_specs,
)
from lomanerf_tpu.parallel.render_step import (  # noqa: F401
    make_render_step,
    shard_ray_chunks,
    sharded_render_fn,
    sharded_render_image,
)
from lomanerf_tpu.parallel.train_step import (  # noqa: F401
    RayBatch,
    make_train_step,
    place_state,
    state_specs,
)
