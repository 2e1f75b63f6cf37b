"""Model families as ``nn.Module``s: GPT-2, Llama and T5."""

from .configs import (
    GPT2_125M,
    LLAMA3_8B,
    LLAMA3_70B,
    PRESETS,
    T5_11B,
    TINY,
    TINY_GPT2,
    TINY_T5,
    EncDecConfig,
    TransformerConfig,
)
from .convert import from_flax_params
from .decomposition import DecodeDecomposition
from .gpt2 import GPT2Model, make_gpt2
from .llama import LlamaModel, make_llama
from .t5 import T5Model, make_t5

__all__ = [
    "GPT2_125M",
    "LLAMA3_8B",
    "LLAMA3_70B",
    "PRESETS",
    "T5_11B",
    "TINY",
    "TINY_GPT2",
    "TINY_T5",
    "DecodeDecomposition",
    "EncDecConfig",
    "GPT2Model",
    "LlamaModel",
    "T5Model",
    "TransformerConfig",
    "from_flax_params",
    "make_gpt2",
    "make_llama",
    "make_t5",
]
