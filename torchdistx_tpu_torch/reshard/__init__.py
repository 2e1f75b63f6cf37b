"""Elastic resharding: topology-migrating checkpoint redistribution (the
port's counterpart of ``torchdistx_tpu/reshard``).

The elastic loop (:mod:`torchdistx_tpu_torch.utils.failures`) survives
preemption and can resume onto another mesh: a job drains, its
checkpoint (parameters AND optimizer state) is redistributed to the new
layout, and training continues.  Two forms:

**Offline** — :func:`reshard_checkpoint` rewrites a committed checkpoint
under a new ``ShardingPlan``/mesh.  A checkpoint stores each leaf as
chunks of raw bytes, one per saved shard, so the rewrite is a streaming
rechunk-copy, bitwise-verified leaf-by-leaf before the destination
gains its commit marker.

**Online** — :func:`restore_resharded` streams a checkpoint straight
into a differently-sharded live state; ``run_elastic`` routes through it
automatically when :func:`needs_reshard` sees the manifest's topology
block disagree with the relaunch mesh.

Both paths are memory-bounded per arXiv:2112.01075: leaf-by-leaf
streaming, with any per-shard slice over ``TDX_RESHARD_CHUNK_MB`` split
into budget-sized slab reads — a full unsharded leaf never exists on one
host (:func:`last_transfer_peak_bytes`).

Failure contract (degrade-never-corrupt): a failed reshard — including
injected ``reshard``-site chaos faults — quarantines nothing, leaves the
source checkpoint untouched, leaves no committed destination, and raises
a typed :class:`ReshardError`.

Telemetry: ``tdx.reshard.{leaves,bytes_moved,chunks,elastic_reshards,
verify_fail}`` counters and ``reshard.plan`` / ``reshard.transfer`` /
``reshard.verify`` spans.
"""

from __future__ import annotations

from .diff import (
    LeafTransfer,
    MeshSpec,
    ReshardError,
    ReshardPlan,
    chunk_boxes,
)
from .engine import (
    last_transfer_peak_bytes,
    needs_reshard,
    plan_reshard,
    reshard_checkpoint,
    restore_resharded,
    verify_reshard,
)

__all__ = [
    "LeafTransfer",
    "MeshSpec",
    "ReshardError",
    "ReshardPlan",
    "chunk_boxes",
    "last_transfer_peak_bytes",
    "needs_reshard",
    "plan_reshard",
    "reshard_checkpoint",
    "restore_resharded",
    "verify_reshard",
]
