"""Auxiliary subsystems (counterpart of ``torchdistx_tpu/utils``):
sharded checkpoints with integrity manifests over
``torch.distributed.checkpoint``, failure detection and the elastic
(checkpoint-restart) loop, profiling over ``torch.profiler``, and the
framework logger."""

from .checkpoint import AsyncCheckpointSaver, restore_checkpoint, save_checkpoint
from .failures import FailureDetector, device_health, run_elastic
from .logging import get_logger
from .profiling import StepTimer, Timer, annotate, trace

__all__ = [
    "AsyncCheckpointSaver",
    "FailureDetector",
    "StepTimer",
    "Timer",
    "annotate",
    "device_health",
    "get_logger",
    "restore_checkpoint",
    "run_elastic",
    "save_checkpoint",
    "trace",
]
