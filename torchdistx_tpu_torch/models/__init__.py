"""Decoder-LM families as ``nn.Module``s: GPT-2 and Llama."""

from .configs import (
    GPT2_125M,
    LLAMA3_8B,
    LLAMA3_70B,
    PRESETS,
    TINY,
    TINY_GPT2,
    TransformerConfig,
)
from .convert import from_flax_params
from .decomposition import DecodeDecomposition
from .gpt2 import GPT2Model, make_gpt2
from .llama import LlamaModel, make_llama

__all__ = [
    "GPT2_125M",
    "LLAMA3_8B",
    "LLAMA3_70B",
    "PRESETS",
    "TINY",
    "TINY_GPT2",
    "DecodeDecomposition",
    "GPT2Model",
    "LlamaModel",
    "TransformerConfig",
    "from_flax_params",
    "make_gpt2",
    "make_llama",
]
