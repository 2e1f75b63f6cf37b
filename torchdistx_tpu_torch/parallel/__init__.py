"""Training, meshes and sharding plans: the loss and the train step (on
one device, or over a mesh with tensor parallelism, FSDP2 and sequence
parallelism: :mod:`.spmd`, or as pipeline stages: :mod:`.pipeline`),
``make_mesh`` over ``torch.distributed``'s ``DeviceMesh``, the name →
PartitionSpec plans the materializer places shards by, and the
sequence-parallel attentions (ring-flash, the dense ring and Ulysses)
over a mesh's ``sp`` axis."""

from .mesh import (
    DEFAULT_AXIS_ORDER,
    VirtualMesh,
    initialize_multihost,
    make_hybrid_mesh,
    make_mesh,
    single_device_mesh,
)
from .pipeline import (
    pipeline_plan_overrides,
    pipeline_train_1f1b,
    pipeline_train_gpipe,
    pipeline_train_interleaved,
    pipelined_decoder_apply,
    valid_next_token_mask,
)
from .ring_attention import make_ring_attention
from .ring_flash import make_ring_flash_attention, ring_flash_attention
from .sharding import (
    CallableShardingPlan,
    PartitionSpec,
    ShardingPlan,
    StageShardingPlan,
    fsdp_plan,
    gspmd_2d_plan,
    local_shard,
    parse_spec_str,
    placements_for,
    plan_digest,
    spec_str,
    stage_layers,
)
from .train import lm_cross_entropy, make_train_step, train_elastic
from .ulysses import make_ulysses_attention

__all__ = [
    "DEFAULT_AXIS_ORDER",
    "CallableShardingPlan",
    "PartitionSpec",
    "ShardingPlan",
    "StageShardingPlan",
    "VirtualMesh",
    "fsdp_plan",
    "gspmd_2d_plan",
    "initialize_multihost",
    "lm_cross_entropy",
    "local_shard",
    "make_hybrid_mesh",
    "make_mesh",
    "make_ring_attention",
    "make_ring_flash_attention",
    "make_train_step",
    "train_elastic",
    "make_ulysses_attention",
    "parse_spec_str",
    "pipeline_plan_overrides",
    "pipeline_train_1f1b",
    "pipeline_train_gpipe",
    "pipeline_train_interleaved",
    "pipelined_decoder_apply",
    "placements_for",
    "plan_digest",
    "ring_flash_attention",
    "single_device_mesh",
    "spec_str",
    "stage_layers",
    "valid_next_token_mask",
]
