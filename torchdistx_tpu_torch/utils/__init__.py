"""Auxiliary subsystems (counterpart of ``torchdistx_tpu/utils``):
sharded checkpoints with integrity manifests over
``torch.distributed.checkpoint``, failure detection and the elastic
(checkpoint-restart) loop, and the framework logger."""

from .checkpoint import AsyncCheckpointSaver, restore_checkpoint, save_checkpoint
from .failures import FailureDetector, device_health, run_elastic
from .logging import get_logger

__all__ = [
    "AsyncCheckpointSaver",
    "FailureDetector",
    "device_health",
    "get_logger",
    "restore_checkpoint",
    "run_elastic",
    "save_checkpoint",
]
