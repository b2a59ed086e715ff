"""Parallelism of the port: the device mesh and the sharding rules
(counterpart of ``vla_fastvlm_tpu/parallel``; the GPipe pipeline,
``pipeline.py``, is not ported yet)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    cli_mesh,
    initialize_distributed,
    is_main_rank,
    make_mesh,
    needs_own_ranks,
    single_device_mesh,
    spawn_ranks,
)
from .sharding import (
    FSDP_MIN_ELEMENTS,
    batch_shardings,
    batch_spec,
    cache_shardings,
    fsdp_param_shardings,
    fsdp_spec_for_param,
    full_state_dict,
    param_shardings,
    shard_batch,
    shard_cache,
    shard_params,
    spec_for_param,
)

__all__ = [
    "DATA_AXIS",
    "FSDP_MIN_ELEMENTS",
    "MODEL_AXIS",
    "batch_shardings",
    "cli_mesh",
    "batch_spec",
    "cache_shardings",
    "fsdp_param_shardings",
    "fsdp_spec_for_param",
    "full_state_dict",
    "initialize_distributed",
    "is_main_rank",
    "make_mesh",
    "needs_own_ranks",
    "param_shardings",
    "shard_batch",
    "shard_cache",
    "shard_params",
    "single_device_mesh",
    "spawn_ranks",
    "spec_for_param",
]
