"""Model families as ``nn.Module``s: GPT-2, Llama, Mixtral, T5 and ViT."""

from .configs import (
    GPT2_125M,
    LLAMA3_8B,
    LLAMA3_70B,
    MIXTRAL_8X7B,
    PRESETS,
    T5_11B,
    TINY,
    TINY_GPT2,
    TINY_MOE,
    TINY_T5,
    TINY_VIT,
    VIT_B16,
    VIT_L16,
    EncDecConfig,
    MoEConfig,
    TransformerConfig,
    VisionConfig,
)
from .convert import from_flax_params
from .decomposition import DecodeDecomposition
from .gpt2 import GPT2Model, make_gpt2
from .llama import LlamaModel, make_llama
from .mixtral import make_mixtral
from .plans import decoder_lm_plan, t5_plan, vit_plan
from .t5 import T5Model, make_t5
from .vit import ViTModel, make_vit

__all__ = [
    "GPT2_125M",
    "LLAMA3_8B",
    "LLAMA3_70B",
    "MIXTRAL_8X7B",
    "PRESETS",
    "T5_11B",
    "TINY",
    "TINY_GPT2",
    "TINY_MOE",
    "TINY_T5",
    "TINY_VIT",
    "VIT_B16",
    "VIT_L16",
    "DecodeDecomposition",
    "EncDecConfig",
    "GPT2Model",
    "LlamaModel",
    "MoEConfig",
    "T5Model",
    "TransformerConfig",
    "ViTModel",
    "VisionConfig",
    "decoder_lm_plan",
    "from_flax_params",
    "make_gpt2",
    "make_llama",
    "make_mixtral",
    "make_t5",
    "make_vit",
    "t5_plan",
    "vit_plan",
]
