"""Attention ops: the port's hand-written CUDA kernels, their plain
PyTorch versions, and the flash launch-shape tuner."""

from .flash_attention import (
    BlockConfigError,
    built_blocks,
    flash_attention,
    flash_backward,
    flash_backward_dbias,
    flash_forward,
    make_flash_attention,
)
from .autotune import tune_flash_blocks
from .paged_attention import (
    paged_attention,
    paged_attention_reference,
    paged_prefill_attention,
)

__all__ = ["BlockConfigError", "built_blocks", "flash_attention",
           "flash_backward", "flash_backward_dbias", "flash_forward",
           "make_flash_attention", "paged_attention",
           "paged_attention_reference", "paged_prefill_attention",
           "tune_flash_blocks"]
