"""Mixtral-family MoE decoder (counterpart of
``torchdistx_tpu/models/mixtral.py``): the Llama model with ``cfg.moe``
set, so each block's MLP is the capacity-based :class:`~.layers.MoEMLP`.
Its expert weights are ``[E, d, ff]`` stacks whose expert dim the plans
shard over the ``ep`` mesh axis (:func:`.plans.decoder_lm_plan`)."""

from __future__ import annotations

from .configs import TransformerConfig
from .layers import AttnFn, default_attention
from .llama import LlamaModel


def make_mixtral(cfg: TransformerConfig, attn_fn: AttnFn = default_attention,
                 device=None) -> LlamaModel:
    if cfg.moe is None:
        raise ValueError("Mixtral config must have `moe` set.")
    return LlamaModel(cfg, device=device, attn_fn=attn_fn)
