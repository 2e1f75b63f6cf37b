"""T5-family encoder-decoder (counterpart of ``torchdistx_tpu/models/t5.py``).

A shared token embedding, an encoder and a decoder stack of pre-norm
blocks, and a relative-position bias computed once per stack and shared
by its layers as an additive [H, S, T] logit bias (bidirectional in the
encoder, causal in the decoder).  One block per layer in an
``nn.ModuleList`` (the JAX package stacks them with ``nn.scan``;
:func:`.convert.from_flax_params` unstacks its weights onto this layout).

Attention scales by 1/sqrt(head_dim), as the reference's
``default_attention`` does (the original T5 does not scale); the port
follows the reference.  With the flash ``AttnFn`` every self-attention
layer runs the bias operand of the flash kernels, and the relative
tables get their gradient from the d(bias) kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .configs import EncDecConfig, TransformerConfig
from .decomposition import chunk_positions
from .layers import (
    MLP,
    AttnFn,
    Attention,
    CrossAttention,
    Embed,
    Linear,
    default_attention,
    make_norm,
)


def _relative_buckets(rel_pos: torch.Tensor, *, bidirectional: bool,
                      num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5 relative-position bucketing (log-spaced beyond max_exact), in
    the reference's f32 arithmetic, so both give the same integers."""
    ret = torch.zeros_like(rel_pos)
    n = -rel_pos
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(rel_pos.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = torch.log(torch.tensor(max_distance / max_exact,
                                       dtype=torch.float32, device=n.device))
    val_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6) / log_ratio
        * (num_buckets - max_exact)
    ).to(rel_pos.dtype)
    val_large = val_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


class RelativePositionBias(nn.Module):
    """The [H, qlen, klen] f32 bias from a [buckets, H] f32 table, drawn
    normal(std 1.0) whatever ``param_dtype`` says, as in the JAX module."""

    def __init__(self, cfg: TransformerConfig, bidirectional: bool,
                 device=None):
        super().__init__()
        self.bidirectional = bidirectional
        self.num_buckets = cfg.relative_pos_buckets
        self.max_distance = cfg.relative_pos_max_distance
        self.embedding = nn.Parameter(torch.empty(
            cfg.relative_pos_buckets, cfg.n_heads, dtype=torch.float32,
            device=device))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        nn.init.normal_(self.embedding, std=1.0)

    def forward(self, qlen: int, klen: int,
                seq_shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """[H, qlen, klen] f32; with ``seq_shard = (index, count)`` the
        rows of query chunk ``index`` of ``count`` (``qlen`` and ``klen``
        being the chunks' lengths) against every key column, [H, qlen,
        count * klen], from their relative positions."""
        dev = self.embedding.device
        if seq_shard is None:
            ctx = torch.arange(qlen, device=dev)[:, None]
            mem = torch.arange(klen, device=dev)[None, :]
        else:
            ctx = chunk_positions(seq_shard, qlen, dev)[:, None]
            mem = torch.arange(seq_shard[1] * klen, device=dev)[None, :]
        buckets = _relative_buckets(
            mem - ctx, bidirectional=self.bidirectional,
            num_buckets=self.num_buckets, max_distance=self.max_distance)
        # A gather whose backward scatters in parallel: indexing's backward
        # serializes on the table's 32 rows (66 ms per step at T5-11B's
        # shapes on an H100, PERF.md).
        return F.embedding(buckets, self.embedding).permute(2, 0, 1)  # [H, q, k]


class EncoderBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None,
                 attn_fn: AttnFn = default_attention):
        super().__init__()
        self.norm_0 = make_norm(cfg, device)
        self.attn = Attention(cfg, device, attn_fn)
        self.norm_1 = make_norm(cfg, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, bias, segment_ids=None):
        x = x + self.attn(self.norm_0(x), bias=bias, causal=False,
                          segment_ids=segment_ids)
        return x + self.mlp(self.norm_1(x))


class DecoderBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None,
                 attn_fn: AttnFn = default_attention):
        super().__init__()
        self.norm_0 = make_norm(cfg, device)
        self.attn = Attention(cfg, device, attn_fn)
        self.norm_1 = make_norm(cfg, device)
        self.cross = CrossAttention(cfg, device, attn_fn)
        self.norm_2 = make_norm(cfg, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, enc, bias, dec_segs=None, enc_segs=None):
        x = x + self.attn(self.norm_0(x), bias=bias, causal=True,
                          segment_ids=dec_segs)
        cross_segs = None if dec_segs is None else (dec_segs, enc_segs)
        x = x + self.cross(self.norm_1(x), enc, segment_ids=cross_segs)
        return x + self.mlp(self.norm_2(x))


class T5Model(nn.Module):
    def __init__(self, cfg: EncDecConfig, device=None,
                 attn_fn: AttnFn = default_attention):
        super().__init__()
        self.cfg = cfg
        enc, dec = cfg.encoder, cfg.decoder
        self.shared_embed = Embed(cfg.vocab_size, enc.d_model, dtype=enc.dtype,
                                  param_dtype=enc.param_dtype, device=device)
        self.enc_relpos = RelativePositionBias(enc, True, device)
        self.enc_blocks = nn.ModuleList(
            EncoderBlock(enc, device, attn_fn) for _ in range(enc.n_layers))
        self.enc_norm = make_norm(enc, device)
        self.dec_relpos = RelativePositionBias(dec, False, device)
        self.dec_blocks = nn.ModuleList(
            DecoderBlock(dec, device, attn_fn) for _ in range(dec.n_layers))
        self.dec_norm = make_norm(dec, device)
        self.lm_head = None if cfg.tie_embeddings else Linear(
            dec.d_model, cfg.vocab_size, False, dtype=dec.dtype,
            param_dtype=dec.param_dtype, device=device)

    def forward(self, enc_tokens: torch.Tensor, dec_tokens: torch.Tensor,
                segment_ids=None, *,
                seq_shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """enc_tokens [B, S_enc], dec_tokens [B, S_dec] → logits [B, S_dec,
        vocab] in f32.

        ``segment_ids`` (optional) is an ``(enc_seg [B, S_enc], dec_seg
        [B, S_dec])`` pair for packed batches: encoder self-attention masks
        by enc ids, decoder self-attention by dec ids, and cross-attention
        pairs each decoder position with its own document's encoder span.

        ``seq_shard = (index, count)`` says both token tensors (and the
        segment ids) are chunk ``index`` of ``count`` equal chunks of their
        sequences (a sequence-parallel rank's, with the model's ``attn_fn``
        over that axis): each stack's bias is then its chunk's rows against
        every key column, [H, s, count * s], computed from the relative
        positions.  ``None``: the whole sequences."""
        cfg = self.cfg
        enc_segs = dec_segs = None
        if segment_ids is not None:
            enc_segs, dec_segs = segment_ids
        e = self.shared_embed(enc_tokens)
        ebias = self.enc_relpos(enc_tokens.shape[1], enc_tokens.shape[1],
                                seq_shard)
        for blk in self.enc_blocks:
            e = blk(e, ebias, enc_segs)
        e = self.enc_norm(e)

        d = self.shared_embed(dec_tokens)
        dbias = self.dec_relpos(dec_tokens.shape[1], dec_tokens.shape[1],
                                seq_shard)
        for blk in self.dec_blocks:
            d = blk(d, e, dbias, dec_segs, enc_segs)
        d = self.dec_norm(d)
        if self.lm_head is None:
            # T5 rescales before the tied head
            d = d * (cfg.decoder.d_model ** -0.5)
            logits = self.shared_embed.attend(d.to(cfg.decoder.param_dtype))
        else:
            logits = self.lm_head(d)
        return logits.float()


def make_t5(cfg: EncDecConfig, attn_fn: AttnFn = default_attention,
            device=None) -> T5Model:
    return T5Model(cfg, device=device, attn_fn=attn_fn)
