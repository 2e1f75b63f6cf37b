"""Model configurations (counterpart of ``torchdistx_tpu/models/configs.py``).

The same fields and presets as the JAX package, with ``dtype`` (compute)
and ``param_dtype`` (storage) as torch dtypes: the decoder LMs (GPT-2,
Llama, Mixtral with ``moe`` set), T5 and ViT.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    # load-balancing loss weight
    router_aux_weight: float = 0.02


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: Optional[int] = None  # None = MHA; < n_heads = GQA
    d_ff: int = 2048
    max_seq_len: int = 2048
    head_dim: Optional[int] = None

    # flavor
    use_bias: bool = False
    activation: str = "silu"  # "silu" (SwiGLU) | "gelu" (plain MLP)
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    positions: str = "rope"  # "rope" | "learned" | "relative"
    tie_embeddings: bool = False
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    relative_pos_buckets: int = 32  # t5-style
    relative_pos_max_distance: int = 128

    moe: Optional[MoEConfig] = None

    dtype: torch.dtype = torch.bfloat16  # activation/compute dtype
    param_dtype: torch.dtype = torch.float32

    # remat policy for the blocks: "none" | "full" (each block's forward
    # runs again in the backward instead of keeping its activations)
    remat: str = "none"

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_size(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "TransformerConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class EncDecConfig:
    """T5-style encoder-decoder: one TransformerConfig per stack."""

    encoder: TransformerConfig
    decoder: TransformerConfig
    vocab_size: int
    tie_embeddings: bool = True

    def replace(self, **kw) -> "EncDecConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class VisionConfig:
    """ViT-style image encoder: a TransformerConfig stack over patches."""

    encoder: TransformerConfig
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    n_classes: int = 1000
    pool: str = "cls"  # "cls" (class token) | "gap" (mean over patches)

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.n_patches + (1 if self.pool == "cls" else 0)

    def replace(self, **kw) -> "VisionConfig":
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Presets (sizes follow the public model cards)
# ---------------------------------------------------------------------------

GPT2_125M = TransformerConfig(
    use_bias=True,
    vocab_size=50257,
    d_model=768,
    n_layers=12,
    n_heads=12,
    d_ff=3072,
    max_seq_len=1024,
    activation="gelu",
    norm="layernorm",
    positions="learned",
    tie_embeddings=True,
    norm_eps=1e-5,
)

LLAMA3_8B = TransformerConfig(
    vocab_size=128256,
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    max_seq_len=8192,
    rope_theta=500000.0,
)

LLAMA3_70B = TransformerConfig(
    vocab_size=128256,
    d_model=8192,
    n_layers=80,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    max_seq_len=8192,
    rope_theta=500000.0,
    remat="full",
)

MIXTRAL_8X7B = TransformerConfig(
    vocab_size=32000,
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    max_seq_len=32768,
    rope_theta=1000000.0,
    moe=MoEConfig(n_experts=8, top_k=2),
)

_T5_STACK = TransformerConfig(
    vocab_size=32128,
    d_model=1024,
    n_layers=24,
    n_heads=128,
    head_dim=128,
    d_ff=65536,
    max_seq_len=512,
    activation="gelu",
    norm="rmsnorm",
    positions="relative",
    norm_eps=1e-6,
)

T5_11B = EncDecConfig(
    encoder=_T5_STACK,
    decoder=_T5_STACK,
    vocab_size=32128,
    tie_embeddings=True,
)

_VIT_STACK = TransformerConfig(
    vocab_size=1,  # unused by the vision family
    d_model=768,
    n_layers=12,
    n_heads=12,
    d_ff=3072,
    max_seq_len=197,
    use_bias=True,
    activation="gelu",
    norm="layernorm",
    positions="learned",
    norm_eps=1e-6,
)

VIT_B16 = VisionConfig(encoder=_VIT_STACK)

VIT_L16 = VisionConfig(
    encoder=_VIT_STACK.replace(d_model=1024, n_layers=24, n_heads=16, d_ff=4096),
)

# -- tiny variants for tests -------------------------------------------------

TINY = TransformerConfig(
    vocab_size=256,
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    max_seq_len=128,
    dtype=torch.float32,
)

TINY_GPT2 = GPT2_125M.replace(
    vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=128,
    dtype=torch.float32,
)

TINY_MOE = TINY.replace(moe=MoEConfig(n_experts=4, top_k=2))

_TINY_T5_STACK = _T5_STACK.replace(
    vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16, d_ff=128,
    max_seq_len=64, dtype=torch.float32,
)

TINY_T5 = EncDecConfig(
    encoder=_TINY_T5_STACK,
    decoder=_TINY_T5_STACK,
    vocab_size=256,
)

TINY_VIT = VisionConfig(
    encoder=_VIT_STACK.replace(
        d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=17,
        dtype=torch.float32,
    ),
    image_size=32,
    patch_size=8,
    n_classes=10,
)

PRESETS = {
    "gpt2-125m": GPT2_125M,
    "llama3-8b": LLAMA3_8B,
    "llama3-70b": LLAMA3_70B,
    "mixtral-8x7b": MIXTRAL_8X7B,
    "t5-11b": T5_11B,
    "vit-b16": VIT_B16,
    "vit-l16": VIT_L16,
    "tiny": TINY,
    "tiny-gpt2": TINY_GPT2,
    "tiny-moe": TINY_MOE,
    "tiny-t5": TINY_T5,
    "tiny-vit": TINY_VIT,
}
