"""Llama-family decoder-only LM (counterpart of ``torchdistx_tpu/models/llama.py``).

One :class:`~.layers.Block` per layer in an ``nn.ModuleList`` (the JAX
package stacks them with ``nn.scan``; :func:`.convert.from_flax_params`
unstacks its weights onto this layout), each rematerialized in the
backward when ``cfg.remat == "full"``.  Also serves Mixtral: a config with
``moe`` set gives blocks with the capacity-based MoE MLP
(:func:`.mixtral.make_mixtral`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .configs import TransformerConfig
from .decomposition import (
    DecodeDecomposition,
    PipelineDecomposition,
    apply_final_norm,
    chunk_positions,
    decoder_head_logits,
    token_embed,
)
from .layers import (
    AttnFn,
    Block,
    Embed,
    Linear,
    default_attention,
    make_norm,
    run_block,
    rope_frequencies,
)


class LlamaModel(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None,
                 attn_fn: AttnFn = default_attention):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype,
                           param_dtype=cfg.param_dtype, device=device)
        self.blocks = nn.ModuleList(
            Block(cfg, device, attn_fn) for _ in range(cfg.n_layers))
        self.final_norm = make_norm(cfg, device)
        self.lm_head = None if cfg.tie_embeddings else Linear(
            cfg.d_model, cfg.vocab_size, False, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, device=device)

    def forward(self, tokens: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None, *,
                seq_shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """tokens [B, S] int → logits [B, S, vocab] in f32.

        ``segment_ids`` [B, S] (optional) mask cross-document attention
        for packed-sequence training.  ``seq_shard = (index, count)``
        says ``tokens`` is chunk ``index`` of ``count`` equal chunks of
        the sequence (a sequence-parallel rank's, with the model's
        ``attn_fn`` over that axis): rope rotates at the chunk's absolute
        positions, gathered as :meth:`decode_decomposition` gathers them.
        ``None``: the whole sequence, from position 0."""
        cfg = self.cfg
        x = self.embed(tokens)
        if seq_shard is None:
            angles = rope_frequencies(cfg.head_size, tokens.shape[1],
                                      cfg.rope_theta, device=tokens.device)
        else:
            angles = self.decode_decomposition().angles_at(chunk_positions(
                seq_shard, tokens.shape[1], tokens.device))
        for blk in self.blocks:
            x = run_block(cfg, blk, x, angles=angles,
                          segment_ids=segment_ids)
        x = self.final_norm(x)
        if self.lm_head is None:
            logits = self.embed.attend(x.to(cfg.param_dtype))
        else:
            logits = self.lm_head(x)
        return logits.float()

    def pipeline_decomposition(self) -> PipelineDecomposition:
        """For the pipeline runner: :meth:`forward`'s embed → blocks →
        final norm and head, the head through
        :func:`.decomposition.decoder_head_logits` as the JAX package's
        decomposition runs it."""
        cfg = self.cfg

        def embed(tokens, seq_shard=None):
            return self.embed(tokens)  # rope: the positions enter in angles

        def angles(S, seq_shard=None):
            dev = self.embed.weight.device
            if seq_shard is None:
                return rope_frequencies(cfg.head_size, S, cfg.rope_theta,
                                        device=dev)
            # Row p of the table is position p's whatever its length.
            return rope_frequencies(cfg.head_size, S * seq_shard[1],
                                    cfg.rope_theta, device=dev)[
                chunk_positions(seq_shard, S, dev)]

        def head(x):
            x = apply_final_norm(self.final_norm, x)
            return decoder_head_logits(cfg, x, self.embed, self.lm_head)

        return PipelineDecomposition(embed, self.blocks, angles, head)

    def decode_decomposition(self) -> DecodeDecomposition:
        """Position-explicit embed and rope, same block/head structure as
        :meth:`forward`.  The angle table is built once at
        ``max_seq_len`` and gathered at the requested positions —
        ``rope_frequencies`` is an outer product, so row ``p`` equals the
        row a full forward at length ``> p`` would use."""
        cfg = self.cfg
        table = rope_frequencies(cfg.head_size, cfg.max_seq_len,
                                 cfg.rope_theta,
                                 device=self.embed.weight.device)

        def embed(tokens, positions):
            return token_embed(cfg, self.embed.weight, tokens)

        def angles_at(positions):
            return table[positions]  # [B, S, head_dim/2]

        def head(x):
            x = apply_final_norm(self.final_norm, x)
            return decoder_head_logits(cfg, x, self.embed, self.lm_head)

        return DecodeDecomposition(embed, self.blocks, angles_at, head)


def make_llama(cfg: TransformerConfig, attn_fn: AttnFn = default_attention,
               device=None) -> LlamaModel:
    return LlamaModel(cfg, device=device, attn_fn=attn_fn)
