"""ViT family: a vision transformer image encoder (counterpart of
``torchdistx_tpu/models/vit.py``).

* patch embedding as a strided ``Conv2d`` (kernel and stride the patch
  size) over the channels-first view of ``[B, H, W, C]`` images, the
  JAX layout;
* a class token (``pool="cls"``) and learned positions, then the shared
  pre-norm :class:`~.layers.Block` with ``causal=False``, rematerialized
  in the backward when ``remat == "full"``;
* the final norm, class-token or mean pooling and a linear head: f32
  class logits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .configs import VisionConfig
from .decomposition import PipelineDecomposition, apply_final_norm
from .layers import (
    _TRUNC_STD,
    AttnFn,
    Block,
    Linear,
    default_attention,
    make_norm,
    run_block,
    trunc_normal_,
)


def _check_patch_divisible(cfg: VisionConfig, images: torch.Tensor) -> None:
    """A strided conv would otherwise crop the border without a word."""
    _, H, W, _ = images.shape
    p = cfg.patch_size
    if H % p or W % p:
        raise ValueError(
            f"image dims ({H}x{W}) must be divisible by patch_size={p}."
        )


class PatchEmbed(nn.Conv2d):
    """``Conv2d(C, d, P, stride=P)`` stored in ``param_dtype`` and computed
    in ``dtype``, initialized like flax's ``nn.Conv``: LeCun truncated
    normal over fan_in ``P * P * C``, zero bias."""

    def __init__(self, cfg: VisionConfig, device=None):
        enc = cfg.encoder
        P = cfg.patch_size
        super().__init__(cfg.channels, enc.d_model, P, stride=P, bias=True,
                         device=device, dtype=enc.param_dtype)
        self.compute_dtype = enc.dtype

    def reset_parameters(self) -> None:
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        trunc_normal_(self.weight, math.sqrt(1.0 / fan_in) / _TRUNC_STD)
        nn.init.zeros_(self.bias)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, C] → patches [B, H/P * W/P, d], row-major."""
        dt = self.compute_dtype
        x = F.conv2d(images.to(dt).permute(0, 3, 1, 2), self.weight.to(dt),
                     self.bias.to(dt), stride=self.stride)
        return x.flatten(2).transpose(1, 2)


class ViTModel(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None,
                 attn_fn: AttnFn = default_attention):
        super().__init__()
        self.cfg = cfg
        enc = cfg.encoder
        kw = dict(dtype=enc.param_dtype, device=device)
        self.patch_embed = PatchEmbed(cfg, device)
        if cfg.pool == "cls":
            self.cls = nn.Parameter(torch.zeros(1, 1, enc.d_model, **kw))
        self.pos_embed = nn.Parameter(
            torch.empty(1, cfg.seq_len, enc.d_model, **kw))
        nn.init.normal_(self.pos_embed, std=0.02)
        self.blocks = nn.ModuleList(
            Block(enc, device, attn_fn) for _ in range(enc.n_layers))
        self.final_norm = make_norm(enc, device)
        self.head = Linear(enc.d_model, cfg.n_classes, True, dtype=enc.dtype,
                           param_dtype=enc.param_dtype, device=device)

    def _embed(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, C] → patches with the class token and learned
        positions [B, seq_len, d]."""
        cfg = self.cfg
        _check_patch_divisible(cfg, images)
        x = self.patch_embed(images)
        if cfg.pool == "cls":
            B, _, D = x.shape
            x = torch.cat([self.cls.to(x.dtype).expand(B, 1, D), x], dim=1)
        return x + self.pos_embed.to(x.dtype)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm, pooling and the linear head: f32 logits."""
        x = apply_final_norm(self.final_norm, x)
        x = x[:, 0] if self.cfg.pool == "cls" else x.mean(dim=1)
        return self.head(x).float()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, C] → class logits [B, n_classes] in f32."""
        x = self._embed(images)
        for blk in self.blocks:
            x = run_block(self.cfg.encoder, blk, x, causal=False)
        return self._head(x)

    def pipeline_decomposition(self) -> PipelineDecomposition:
        """For the pipeline runner: the image embed, the non-causal
        blocks, the pooled classifier head."""
        def embed(images, seq_shard=None):
            if seq_shard is not None:
                raise NotImplementedError(
                    "ViT's patches are not split over a sequence axis")
            return self._embed(images)

        return PipelineDecomposition(embed, self.blocks,
                                     lambda S, seq_shard=None: None,
                                     self._head, causal=False,
                                     seq_len=self.cfg.seq_len)


def make_vit(cfg: VisionConfig, attn_fn: AttnFn = default_attention,
             device=None) -> ViTModel:
    return ViTModel(cfg, device=device, attn_fn=attn_fn)
