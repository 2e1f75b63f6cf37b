"""GPT-2 family: learned positions, LayerNorm, GELU, tied head
(counterpart of ``torchdistx_tpu/models/gpt2.py``)."""

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
    positional_token_embed,
)
from .layers import (
    AttnFn,
    Block,
    Embed,
    Linear,
    default_attention,
    make_norm,
    run_block,
)


class GPT2Model(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None,
                 attn_fn: AttnFn = default_attention):
        super().__init__()
        self.cfg = cfg
        self.wte = Embed(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype,
                         param_dtype=cfg.param_dtype, device=device)
        self.wpe = Embed(cfg.max_seq_len, cfg.d_model, dtype=cfg.dtype,
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
        for packed-sequence training.  ``seq_shard = (index, count)``:
        ``tokens`` is chunk ``index`` of ``count`` equal chunks of the
        sequence, whose ``wpe`` rows are those of its absolute positions
        (``LlamaModel.forward`` has the details)."""
        cfg = self.cfg
        S = tokens.shape[1]
        pos = (torch.arange(S, device=tokens.device) if seq_shard is None
               else chunk_positions(seq_shard, S, tokens.device))
        x = self.wte(tokens) + self.wpe(pos)[None]
        for blk in self.blocks:
            x = run_block(cfg, blk, x, segment_ids=segment_ids)
        x = self.final_norm(x)
        if self.lm_head is None:
            logits = self.wte.attend(x.to(cfg.param_dtype))
        else:
            logits = self.lm_head(x)
        return logits.float()

    def pipeline_decomposition(self) -> PipelineDecomposition:
        """For the pipeline runner: wte + wpe embedding, the blocks, the
        final norm and the tied (or untied) head."""
        cfg = self.cfg

        def embed(tokens, seq_shard=None):
            S = tokens.shape[1]
            pos = (torch.arange(S, device=tokens.device) if seq_shard is None
                   else chunk_positions(seq_shard, S, tokens.device))
            return self.wte(tokens) + self.wpe(pos[None])

        def angles(S, seq_shard=None):
            return None  # learned absolute positions, applied at embed

        def head(x):
            x = apply_final_norm(self.final_norm, x)
            return decoder_head_logits(cfg, x, self.wte, self.lm_head)

        return PipelineDecomposition(embed, self.blocks, angles, head)

    def decode_decomposition(self) -> DecodeDecomposition:
        """Learned positions gathered at the EXPLICIT per-lane offsets (a
        decode token's wpe row is its absolute position), no rope."""
        cfg = self.cfg

        def embed(tokens, positions):
            return positional_token_embed(cfg, self.wte.weight,
                                          self.wpe.weight, tokens, positions)

        def angles_at(positions):
            return None

        def head(x):
            x = apply_final_norm(self.final_norm, x)
            return decoder_head_logits(cfg, x, self.wte, self.lm_head)

        return DecodeDecomposition(embed, self.blocks, angles_at, head)


def make_gpt2(cfg: TransformerConfig, attn_fn: AttnFn = default_attention,
              device=None) -> GPT2Model:
    return GPT2Model(cfg, device=device, attn_fn=attn_fn)
