"""Training, meshes and sharding plans: the loss and the train step (on
one device, or over a mesh with tensor parallelism and FSDP2:
:mod:`.spmd`), ``make_mesh`` over ``torch.distributed``'s
``DeviceMesh``, and the name → PartitionSpec plans the materializer
places shards by."""

from .mesh import DEFAULT_AXIS_ORDER, VirtualMesh, make_mesh, single_device_mesh
from .pipeline import valid_next_token_mask
from .sharding import (
    CallableShardingPlan,
    PartitionSpec,
    ShardingPlan,
    fsdp_plan,
    gspmd_2d_plan,
    local_shard,
    parse_spec_str,
    placements_for,
    plan_digest,
    spec_str,
)
from .train import lm_cross_entropy, make_train_step

__all__ = [
    "DEFAULT_AXIS_ORDER",
    "CallableShardingPlan",
    "PartitionSpec",
    "ShardingPlan",
    "VirtualMesh",
    "fsdp_plan",
    "gspmd_2d_plan",
    "lm_cross_entropy",
    "local_shard",
    "make_mesh",
    "make_train_step",
    "parse_spec_str",
    "placements_for",
    "plan_digest",
    "single_device_mesh",
    "spec_str",
    "valid_next_token_mask",
]
