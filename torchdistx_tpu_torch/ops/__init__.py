"""Attention ops: the port's hand-written CUDA kernels and their plain
PyTorch versions."""

from .flash_attention import (
    flash_attention,
    flash_backward,
    flash_backward_dbias,
    flash_forward,
    make_flash_attention,
)
from .paged_attention import (
    paged_attention,
    paged_attention_reference,
    paged_prefill_attention,
)

__all__ = ["flash_attention", "flash_backward", "flash_backward_dbias",
           "flash_forward", "make_flash_attention", "paged_attention",
           "paged_attention_reference", "paged_prefill_attention"]
