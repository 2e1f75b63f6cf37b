"""Serving programs: the prefill, chunk, decode, verify and copy-on-write
forwards, and their capture as CUDA graphs (counterpart of
``torchdistx_tpu/serve/programs.py``).

The programs of one replica shape, each named as in the JAX package:

* **prefill-<bucket>**: one prompt, padded to a prefill bucket, through
  the full stack with causal attention, writing its K/V into the paged
  pool and returning the last valid position's logits (the first
  generated token);
* **chunk-<bucket>**: one CHUNK of a prompt (the suffix after a cached
  prefix, or one slice of a long prompt) at an arbitrary start
  position, attending the already-written pool context through the page
  table (:func:`..ops.paged_attention.paged_prefill_attention`);
* **decode**: one token per batch lane through the stack, K/V written
  into each lane's current page/slot, context attended through the page
  table by :func:`..ops.paged_attention` (the CUDA kernel on the GPU),
  logits out;
* **verify-<k>**: the speculative-decoding verify tick: every lane
  scores its last emitted token plus up to ``k`` drafted tokens in one
  batched ragged pass against the paged cache, logits for ALL ``k+1``
  positions;
* **cow**: the copy-on-write page duplication: clone one pool page (all
  layers, K and V) into a fresh page before a grower writes into a
  shared one.

The JAX package compiles each program once per replica shape; here each
becomes a :class:`ServeProgram`, which on the card is one
``torch.cuda.CUDAGraph`` captured once: its int32 operands live in a
static device buffer filled from a pinned host buffer before each
replay, its output in a static tensor, and the pools and the parameters
are read and written in place.  On the CPU, and on the card when asked
for (``cuda_graphs=False``), the same functions run eagerly.

The pools are updated IN PLACE (``index_put_``) where the JAX programs
return new pools functionally (``kp.at[...].set``): no second copy of
the cache ever exists.  Padded prompt positions and idle lanes write
the reserved null page 0, which is never read.

**Over a mesh** (:class:`TensorParallel`, ROADMAP A6.6) each rank runs
the same programs on its own shards of a plan's Megatron layout:
``H/tp`` query heads and ``KV/tp`` kv heads (so its pools hold ``KV/tp``
heads and the paged kernel runs at that local shape), ``d_ff/tp`` MLP
columns, and, where the plan splits the vocabulary, its rows of the
embedding table and of the head.  The collectives are written out: an
all-reduce over ``tp`` after the attention output projection and after
the MLP's down projection, a masked local lookup then an all-reduce for
the embedding, local logits then an all-gather, so every rank holds the
same full logits row.  The JAX package lets GSPMD insert the same
collectives; here they are plain c10d calls on the current stream, which
a CUDA graph captures (NCCL), where DTensor's per-op dispatch is host
work a replay would skip.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import config as tdx_config
from ..models import GPT2Model, LlamaModel, TransformerConfig
from ..models.decomposition import (
    DecodeDecomposition,
    apply_final_norm,
    token_embed,
)
from ..models.layers import apply_rope, default_attention
from ..ops import paged_attention
from ..ops.paged_attention import paged_prefill_attention
from .kv_cache import KVCacheConfig

__all__ = [
    "ResolvedServeConfig",
    "ServeConfig",
    "ServeProgram",
    "ServeProgramSpec",
    "TensorParallel",
    "build_chunk_prefill_fn",
    "build_cow_fn",
    "build_decode_fn",
    "build_prefill_fn",
    "build_serving_functions",
    "build_verify_fn",
    "make_model",
    "model_family",
    "serve_program_specs",
]


@dataclass(frozen=True)
class ServeConfig:
    """Shape of one replica's serving runtime."""

    max_batch: int = 4          # decode lanes (fixed-shape batch)
    page_size: int = 16
    n_pages: int = 64           # pool pages, incl. the reserved null page
    max_pages_per_seq: Optional[int] = None  # default: fits max_seq_len
    prefill_buckets: Tuple[int, ...] = ()    # default: powers of two
    max_new_tokens: int = 16    # default per-request budget
    # Chunked-prefill cap: max prompt tokens computed per engine tick
    # per lane (None -> TDX_PREFILL_CHUNK -> the largest bucket, i.e. one
    # chunk).  A host-side scheduling knob: the program set is the same
    # at every setting.
    prefill_chunk: Optional[int] = None
    # Prefix sharing (serve/prefix.py), host-side too.
    prefix_cache: bool = True
    # Speculative decoding.  ``spec_buckets`` is the verify-<k> program
    # family, a SHAPE knob like prefill_buckets; ``spec_decode`` and
    # ``spec_k`` are host-side scheduling knobs (None -> TDX_SPEC_DECODE /
    # TDX_SPEC_K).
    spec_buckets: Tuple[int, ...] = ()       # default: (2, 4)
    spec_decode: Optional[bool] = None
    spec_k: Optional[int] = None

    def resolve(self, cfg: TransformerConfig) -> "ResolvedServeConfig":
        page = self.page_size
        maxp = self.max_pages_per_seq
        cap = min(cfg.max_seq_len, (self.n_pages - 1) * page)
        if maxp is None:
            maxp = -(-cap // page)
        max_context = min(cap, maxp * page)
        buckets = tuple(self.prefill_buckets)
        if not buckets:
            b, acc = 8, []
            while b < max_context:
                acc.append(b)
                b *= 2
            acc.append(max_context)
            buckets = tuple(sorted(set(acc)))
        else:
            buckets = tuple(sorted({min(b, max_context) for b in buckets}))
        chunk = self.prefill_chunk
        if chunk is None:
            chunk = tdx_config.get().prefill_chunk
        if chunk is None or chunk <= 0:
            chunk = buckets[-1]
        chunk = max(1, min(chunk, buckets[-1]))
        spec_buckets = tuple(self.spec_buckets) or (2, 4)
        # A verify-<k> tick writes k+1 positions; k must leave room for
        # at least one prior context token.
        spec_buckets = tuple(sorted(
            {max(1, min(k, max_context - 2)) for k in spec_buckets}
        ))
        spec_on = self.spec_decode
        if spec_on is None:
            spec_on = tdx_config.get().spec_decode
        spec_k = self.spec_k
        if spec_k is None:
            spec_k = tdx_config.get().spec_k
        spec_k = max(1, min(spec_k, spec_buckets[-1]))
        return ResolvedServeConfig(
            max_batch=self.max_batch, page_size=page, n_pages=self.n_pages,
            max_pages_per_seq=maxp, prefill_buckets=buckets,
            max_new_tokens=self.max_new_tokens, max_context=max_context,
            prefill_chunk=chunk, prefix_cache=self.prefix_cache,
            spec_buckets=spec_buckets, spec_decode=bool(spec_on),
            spec_k=spec_k,
        )


@dataclass(frozen=True)
class ResolvedServeConfig:
    """A :class:`ServeConfig` with every default pinned against one model
    config: the form the engine and the program specs consume."""

    max_batch: int
    page_size: int
    n_pages: int
    max_pages_per_seq: int
    prefill_buckets: Tuple[int, ...]
    max_new_tokens: int
    max_context: int
    prefill_chunk: int = 0      # resolved chunk cap (host-side knob)
    prefix_cache: bool = True   # prefix sharing armed (host-side knob)
    spec_buckets: Tuple[int, ...] = (2, 4)  # the verify-<k> family
    spec_decode: bool = True    # speculation armed (host-side knob)
    spec_k: int = 4             # max draft length (host-side knob)

    def kv_config(self, cfg: TransformerConfig, tp: int = 1) -> KVCacheConfig:
        """The pools' shape; on a rank of a ``{tp t}`` mesh it holds that
        rank's ``KV/t`` kv heads."""
        return KVCacheConfig(
            n_layers=cfg.n_layers, kv_heads=cfg.kv_heads // tp,
            head_dim=cfg.head_size, page_size=self.page_size,
            n_pages=self.n_pages,
        )

    def bucket_for(self, n_tokens: int) -> int:
        for b in self.prefill_buckets:
            if b >= n_tokens:
                return b
        raise ValueError(
            f"prompt of {n_tokens} tokens exceeds the largest prefill "
            f"bucket {self.prefill_buckets[-1]} (max_context="
            f"{self.max_context})"
        )

    def spec_bucket_for(self, n_draft: int) -> int:
        for k in self.spec_buckets:
            if k >= n_draft:
                return k
        raise ValueError(
            f"draft of {n_draft} tokens exceeds the largest verify "
            f"bucket {self.spec_buckets[-1]}"
        )


def model_family(name: str) -> str:
    """The decode family of a zoo preset name: gpt2 presets by name, any
    other dense decoder serves through the llama path."""
    return "gpt2" if "gpt2" in name else "llama"


def make_model(family: str, cfg: TransformerConfig, device=None):
    """The family's ``nn.Module`` for ``cfg``, its tensors created on
    ``device`` (fakes claiming it when called under ``deferred_init``)."""
    if cfg.moe is not None:
        raise NotImplementedError(
            "the serving runtime covers the dense decoder families "
            "(gpt2, llama); MoE decode is future work"
        )
    if family == "gpt2":
        return GPT2Model(cfg, device=device)
    if family == "llama":
        return LlamaModel(cfg, device=device)
    raise ValueError(f"unknown decode family {family!r} (gpt2 | llama)")


# ---------------------------------------------------------------------------
# tensor parallelism: one rank's share of a replica over a mesh
# ---------------------------------------------------------------------------


class TensorParallel:
    """The collectives of one rank's programs over the ``tp`` axis of a
    replica's mesh: ``group`` (None: an axis-free mesh, nothing to
    reduce), this rank's index ``rank`` and the axis ``size``;
    ``vocab_embed`` / ``vocab_head`` say whether the embedding table and
    the head hold this rank's rows of the vocabulary (``Shard(0)`` over
    ``tp``) rather than all of it.

    Every call is a c10d collective on the current stream, the same on
    every rank in the same order, with no host read of a device value,
    so a program that makes them is captured as a CUDA graph (NCCL).  A
    row-parallel projection adds its bias on rank 0 only, inside the
    matmul as the unsharded ``Linear`` does: on one rank the result is
    the unsharded one bit for bit.  Over several ranks in a 16-bit
    compute dtype each rank's partial product is kept in float32 and the
    partials are summed in float32, then rounded once, as the unsharded
    matmul rounds its float32 accumulator once (rounding each partial to
    16 bits first would add two roundings to every element of the
    residual stream)."""

    def __init__(self, group, rank: int, size: int, *, vocab_embed: bool,
                 vocab_head: bool):
        self.group, self.rank, self.size = group, rank, size
        self.vocab_embed, self.vocab_head = vocab_embed, vocab_head

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is not None:
            torch.distributed.all_reduce(x, group=self.group)
        return x

    def row_parallel(self, lin, x: torch.Tensor) -> torch.Tensor:
        """``lin(x)`` for a projection whose input dim is split over
        ``tp`` (``attn.wo``, ``mlp.w_down``): the partial products
        summed over the axis."""
        dt = lin.compute_dtype
        bias = (lin.bias.to(dt) if lin.bias is not None and self.rank == 0
                else None)
        if self.size == 1 or dt.itemsize > 2:
            return self.all_reduce(F.linear(x.to(dt), lin.weight.to(dt), bias))
        # 16-bit values are exact in float32, so are their products.
        y = F.linear(x.to(dt).float(), lin.weight.to(dt).float(),
                     None if bias is None else bias.float())
        return self.all_reduce(y).to(dt)

    def lookup(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """``F.embedding(ids, full_table)`` from this rank's rows: ids
        outside them look up row 0 and are zeroed, and the axis's sum
        leaves each id its one owner's row (adding zeros is exact)."""
        if not self.vocab_embed:
            return F.embedding(ids, table)
        rows = table.shape[0]
        local = ids - self.rank * rows
        hit = (local >= 0) & (local < rows)
        out = F.embedding(torch.where(hit, local, 0), table)
        return self.all_reduce(out.masked_fill(~hit[..., None], 0))

    def head(self, cfg, x: torch.Tensor, embed, lm_head) -> torch.Tensor:
        """:func:`~..models.decomposition.decoder_head_logits` from this
        rank's vocabulary rows: its logits columns, then an all-gather
        in rank order, so every rank holds the same full f32 row."""
        if cfg.tie_embeddings or lm_head is None:
            dt = cfg.param_dtype
            logits = (x.to(dt) @ embed.weight.to(dt).T).float()
        else:
            logits = lm_head(x).float()
        if not self.vocab_head or self.group is None:
            return logits
        cols = logits.movedim(-1, 0).contiguous()
        out = cols.new_empty((self.size * cols.shape[0], *cols.shape[1:]))
        torch.distributed.all_gather_into_tensor(out, cols, group=self.group)
        return out.movedim(0, -1)

    def decomposition(self, model) -> DecodeDecomposition:
        """``model.decode_decomposition()`` with the embedding and the
        head through this rank's rows of the vocabulary (the family's
        own reads ``embed.weight`` whole)."""
        cfg, d = model.cfg, model.decode_decomposition()
        table = model.wte if hasattr(model, "wte") else model.embed
        wpe = getattr(model, "wpe", None)

        def embed(tokens, positions):
            x = self.lookup(table.weight, tokens).to(cfg.dtype)
            if wpe is None:
                return x
            return x + token_embed(cfg, wpe.weight, positions)

        def head(x):
            x = apply_final_norm(model.final_norm, x)
            return self.head(cfg, x, table, model.lm_head)

        return DecodeDecomposition(embed, d.blocks, d.angles_at, head)


def _attn_out_and_mlp(blk, x, attn, tp: Optional[TensorParallel]):
    """The block's tail after its attention ``attn`` [B, S, H, D]: the
    output projection and the MLP, each with its residual; over ``tp``
    both projections are row-parallel (summed over the axis)."""
    if tp is None:
        x = x + blk.attn.out(attn)
        return x + blk.mlp(blk.norm_1(x))
    B, S = attn.shape[:2]
    x = x + tp.row_parallel(blk.attn.wo, attn.reshape(B, S, -1))
    return x + tp.row_parallel(blk.mlp.w_down, blk.mlp.hidden(blk.norm_1(x)))


def _decomposition(model, tp: Optional[TensorParallel]):
    return model.decode_decomposition() if tp is None else tp.decomposition(
        model)


# ---------------------------------------------------------------------------
# decode-mode block forward (shared by prefill and decode)
# ---------------------------------------------------------------------------


def _decode_block(blk, x, kp, vp, *, angles, positions, lengths, page_table,
                  tp=None):
    """One layer of the decode step: x [B, 1, d]; writes this token's
    K/V at (page, slot) in place and attends the whole context through
    the page table."""
    page_size = kp.shape[1]
    B = x.shape[0]
    h = blk.norm_0(x)
    q, k, v = blk.attn.qkv(h)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    page = page_table[torch.arange(B, device=x.device), positions // page_size]
    slot = (positions % page_size).long()
    kp.index_put_((page.long(), slot), k[:, 0])
    vp.index_put_((page.long(), slot), v[:, 0])
    attn = paged_attention(q[:, 0], kp, vp, lengths, page_table)
    return _attn_out_and_mlp(blk, x, attn[:, None], tp)


def _prefill_block(blk, x, kp, vp, *, angles, positions, length, page_table,
                   tp=None):
    """One layer of prefill: x [B, S, d]; causal attention over the
    in-flight K/V (a fresh prompt attends only itself), every valid
    position's K/V written into its page in place; padded positions write
    the null page and are segment-masked out of the valid rows."""
    page_size = kp.shape[1]
    maxp = page_table.shape[1]
    h = blk.norm_0(x)
    q, k, v = blk.attn.qkv(h)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    valid = positions < length[:, None]  # [B, S]
    pidx = torch.clamp(positions // page_size, max=maxp - 1)
    page = torch.where(valid, torch.gather(page_table, 1, pidx.long()), 0)
    slot = torch.where(valid, positions % page_size, 0)
    kp.index_put_((page.long(), slot.long()), k)
    vp.index_put_((page.long(), slot.long()), v)
    attn = default_attention(q, k, v, causal=True,
                             segment_ids=valid.to(torch.int32))
    return _attn_out_and_mlp(blk, x, attn, tp)


def build_decode_fn(model, tp: Optional[TensorParallel] = None) -> Callable:
    """The batched decode step:
    ``(k_pages, v_pages, tokens [B], positions [B], page_table [B, maxp])
    -> logits [B, vocab]``, updating the pools in place.  ``positions[b]``
    is the index the incoming token occupies; idle lanes carry position 0
    and a null page table (their writes land in the null page, their
    logits are ignored).  ``tp``: this rank's share of a replica over a
    mesh (:class:`TensorParallel`)."""
    decomp = _decomposition(model, tp)

    @torch.no_grad()
    def decode_fn(k_pages, v_pages, tokens, positions, page_table):
        x = decomp.embed(tokens[:, None], positions[:, None])
        angles = decomp.angles_at(positions[:, None])
        # Context including the incoming token; idle lanes (position 0 —
        # active lanes always hold at least their non-empty prompt) get
        # length 0, the kernel's idle contract, so the null page is
        # written by their scatters but never READ.
        lengths = torch.where(positions > 0, positions + 1, 0).to(torch.int32)
        for layer, blk in enumerate(decomp.blocks):
            x = _decode_block(
                blk, x, k_pages[layer], v_pages[layer], angles=angles,
                positions=positions, lengths=lengths, page_table=page_table,
                tp=tp,
            )
        return decomp.head(x)[:, 0]  # [B, vocab]

    return decode_fn


def build_prefill_fn(model, tp: Optional[TensorParallel] = None) -> Callable:
    """The single-sequence prefill:
    ``(k_pages, v_pages, tokens [1, bucket], length [1],
    page_table [1, maxp]) -> logits [vocab]``, updating the pools in
    place — logits are the LAST VALID position's (the first generated
    token).  One function serves every bucket; the bucket is the padded
    width of ``tokens``."""
    decomp = _decomposition(model, tp)

    @torch.no_grad()
    def prefill_fn(k_pages, v_pages, tokens, length, page_table):
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None]
        x = decomp.embed(tokens, positions)
        angles = decomp.angles_at(positions)
        for layer, blk in enumerate(decomp.blocks):
            x = _prefill_block(
                blk, x, k_pages[layer], v_pages[layer], angles=angles,
                positions=positions, length=length, page_table=page_table,
                tp=tp,
            )
        last = torch.clamp(length - 1, 0, S - 1).long()
        x_last = x[torch.arange(x.shape[0], device=x.device), last][:, None]
        return decomp.head(x_last)[0, 0]  # [vocab]

    return prefill_fn


def _chunk_block(blk, x, kp, vp, *, angles, positions, end, page_table,
                 tp=None):
    """One layer of CHUNKED prefill: x [B, S, d] holds prompt positions
    ``[start, start+S)``; valid positions' K/V are written into their
    pages in place (the caller already copy-on-wrote any shared first
    page), and attention runs through the page table over the WHOLE
    written context (cached prefix pages, earlier chunks, and this
    chunk's causal self-context), which is what lets a suffix prefill
    skip the prefix's FLOPs."""
    page_size = kp.shape[1]
    maxp = page_table.shape[1]
    h = blk.norm_0(x)
    q, k, v = blk.attn.qkv(h)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    valid = positions < end[:, None]  # [B, S] absolute-position validity
    pidx = torch.clamp(positions // page_size, max=maxp - 1)
    page = torch.where(valid, torch.gather(page_table, 1, pidx.long()), 0)
    slot = torch.where(valid, positions % page_size, 0)
    kp.index_put_((page.long(), slot.long()), k)
    vp.index_put_((page.long(), slot.long()), v)
    attn = paged_prefill_attention(q, kp, vp, positions, end, page_table)
    return _attn_out_and_mlp(blk, x, attn, tp)


def _chunk_forward(decomp, k_pages, v_pages, tokens, start, end, page_table,
                   tp=None):
    """The chunk/verify stack: tokens [B, S] at absolute positions
    ``start[b] + [0, S)`` -> final activations [B, S, d]."""
    S = tokens.shape[1]
    positions = start[:, None] + torch.arange(
        S, dtype=torch.int32, device=tokens.device)[None]
    x = decomp.embed(tokens, positions)
    angles = decomp.angles_at(positions)
    for layer, blk in enumerate(decomp.blocks):
        x = _chunk_block(
            blk, x, k_pages[layer], v_pages[layer], angles=angles,
            positions=positions, end=end, page_table=page_table, tp=tp,
        )
    return x


def build_chunk_prefill_fn(model,
                           tp: Optional[TensorParallel] = None) -> Callable:
    """The single-sequence CHUNK prefill:
    ``(k_pages, v_pages, tokens [1, bucket], start [1], end [1],
    page_table [1, maxp]) -> logits [vocab]``, updating the pools in
    place.  ``tokens`` holds prompt positions ``[start, end)``
    left-aligned (padded past ``end - start``); attention reads the
    whole written context through the page table, so a suffix behind a
    shared prefix costs only its own FLOPs.  Logits are the last valid
    position's: meaningful (the first generated token) only on the
    final chunk."""
    decomp = _decomposition(model, tp)

    @torch.no_grad()
    def chunk_fn(k_pages, v_pages, tokens, start, end, page_table):
        S = tokens.shape[1]
        x = _chunk_forward(decomp, k_pages, v_pages, tokens, start, end,
                           page_table, tp)
        last = torch.clamp(end - 1 - start, 0, S - 1).long()
        x_last = x[torch.arange(x.shape[0], device=x.device), last][:, None]
        return decomp.head(x_last)[0, 0]  # [vocab]

    return chunk_fn


def build_verify_fn(model, tp: Optional[TensorParallel] = None) -> Callable:
    """The batched speculative verify:
    ``(k_pages, v_pages, tokens [B, k+1], start [B], end [B],
    page_table [B, maxp]) -> logits [B, k+1, vocab]``, updating the
    pools in place.  Lane ``b`` feeds its last emitted token plus its
    draft, left-aligned in ``tokens[b]``, at absolute positions
    ``[start[b], end[b])``; padded positions past ``end`` write the null
    page and are masked out of attention, and idle lanes carry
    ``start == end == 0`` with a null table row.  Row ``i`` of the
    logits scores the token AFTER position ``start + i``, so greedy
    accept walks the rows left to right.  The batched sibling of
    :func:`build_chunk_prefill_fn`: the same per-layer write and ragged
    attention, every lane at once, the head at every position."""
    decomp = _decomposition(model, tp)

    @torch.no_grad()
    def verify_fn(k_pages, v_pages, tokens, start, end, page_table):
        x = _chunk_forward(decomp, k_pages, v_pages, tokens, start, end,
                           page_table, tp)
        return decomp.head(x)  # [B, k+1, vocab]

    return verify_fn


def build_cow_fn() -> Callable:
    """The copy-on-write page duplication:
    ``(k_pages, v_pages, src [1], dst [1]) -> None``: clone page ``src``
    into ``dst`` across every layer, K and V, in place, so a grower
    about to write into a shared page writes into its private copy."""

    @torch.no_grad()
    def cow_fn(k_pages, v_pages, src, dst):
        for pool in (k_pages, v_pages):
            pool.index_copy_(1, dst.long(), pool.index_select(1, src.long()))

    return cow_fn


# ---------------------------------------------------------------------------
# program specs and capture
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServeProgramSpec:
    """One program of a replica shape: its name (as in the JAX package),
    the forward it runs, and the shapes of its int32 operands in call
    order (the operands after the two pools)."""

    name: str      # decode | prefill-<S> | chunk-<S> | verify-<k> | cow
    kind: str      # decode | prefill | chunk | verify | cow
    inputs: Tuple[Tuple[int, ...], ...]


def serve_program_specs(scfg: ResolvedServeConfig) -> List[ServeProgramSpec]:
    """Every program a replica of this shape runs, in bring-up order
    (prefill buckets, chunk buckets, cow, decode, verify buckets).  The
    verify family is part of every shape whatever ``spec_decode`` says,
    as in the JAX package: speculation is a host-side switch."""
    B, maxp = scfg.max_batch, scfg.max_pages_per_seq
    specs = [ServeProgramSpec(f"prefill-{b}", "prefill",
                              ((1, b), (1,), (1, maxp)))
             for b in scfg.prefill_buckets]
    specs += [ServeProgramSpec(f"chunk-{b}", "chunk",
                               ((1, b), (1,), (1,), (1, maxp)))
              for b in scfg.prefill_buckets]
    specs.append(ServeProgramSpec("cow", "cow", ((1,), (1,))))
    specs.append(ServeProgramSpec("decode", "decode",
                                  ((B,), (B,), (B, maxp))))
    specs += [ServeProgramSpec(f"verify-{k}", "verify",
                               ((B, k + 1), (B,), (B,), (B, maxp)))
              for k in scfg.spec_buckets]
    return specs


def build_serving_functions(model, tp: Optional[TensorParallel] = None
                            ) -> Dict[str, Callable]:
    """kind -> the forward every program of that kind runs (one function
    serves every bucket: the bucket is its operands' width); ``tp``: this
    rank's share of a replica over a mesh."""
    return {"decode": build_decode_fn(model, tp),
            "prefill": build_prefill_fn(model, tp),
            "chunk": build_chunk_prefill_fn(model, tp),
            "verify": build_verify_fn(model, tp),
            "cow": build_cow_fn()}


class ServeProgram:
    """One program of a replica, bound to its pools: call it with numpy
    int32 operands, get its output (``None`` for ``cow``) as a device
    tensor that stays valid until the program's next call.

    Its operands live in ONE int32 buffer on the device (views of it,
    one per operand), filled before each call by one copy from a pinned
    host buffer; the copy is asynchronous, so the next fill first waits
    for it to have read the host buffer.  :meth:`capture` records the
    forward on those views into a ``torch.cuda.CUDAGraph`` (a warm-up
    run on the capture stream first, as torch requires); after it, a
    call is the copy and one replay.  Uncaptured, a call runs the forward
    eagerly on the same views.  On the CPU the host buffer is the
    operand buffer.

    A replay launches what the capture recorded: the paged-decode
    kernel's calls among it add to ``paged_attention.launches`` and
    ``merge_launches`` at each replay, as the wrapper adds at each eager
    call; the capture itself launches nothing and adds nothing."""

    def __init__(self, spec: ServeProgramSpec, fn: Callable,
                 pools: Tuple[torch.Tensor, torch.Tensor]):
        self.spec = spec
        self._fn = fn
        self._pools = pools
        device = pools[0].device
        sizes = [math.prod(s) for s in spec.inputs]
        on_card = device.type == "cuda"
        self._host = torch.zeros(sum(sizes), dtype=torch.int32,
                                 pin_memory=on_card)
        self._dev = (torch.zeros(sum(sizes), dtype=torch.int32,
                                 device=device) if on_card else self._host)
        self._copied = torch.cuda.Event() if on_card else None
        host_np = self._host.numpy()
        self._host_views: List[np.ndarray] = []
        self._operands: List[torch.Tensor] = []
        off = 0
        for shape, n in zip(spec.inputs, sizes):
            self._host_views.append(host_np[off:off + n].reshape(shape))
            self._operands.append(self._dev[off:off + n].view(shape))
            off += n
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[torch.Tensor] = None
        self._launches = (0, 0)   # paged-decode (calls, merges) per replay

    def capture(self, pool, stream: torch.cuda.Stream) -> None:
        """Record the forward into a CUDA graph drawing on the memory
        ``pool`` (shared by every program of the engine: programs never
        run concurrently).  The operand buffer is still all zeros, so
        every write of the warm-up run lands in the null page."""
        args = (*self._pools, *self._operands)
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            self._fn(*args)  # warm-up: real launches, counted as such
        before = (paged_attention.launches, paged_attention.merge_launches)
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(stream.device)
        try:
            # torch.cuda.graph ends the capture in its exit whatever the
            # forward raised, and the outer scope restores the current
            # stream even if ending it fails: no stream is ever left
            # capturing, which would fail every later call on it.  A
            # failed capture keeps no graph.
            with torch.cuda.stream(current):
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    out = self._fn(*args)
        finally:
            current.wait_stream(stream)
            self._launches = (paged_attention.launches - before[0],
                              paged_attention.merge_launches - before[1])
            paged_attention.launches, paged_attention.merge_launches = before
        self.graph, self._out = graph, out

    def __call__(self, *operands: np.ndarray) -> Optional[torch.Tensor]:
        if self._copied is not None:
            self._copied.synchronize()
        for view, a in zip(self._host_views, operands):
            view[...] = a
        if self._dev is not self._host:
            self._dev.copy_(self._host, non_blocking=True)
            self._copied.record()
        if self.graph is None:
            return self._fn(*self._pools, *self._operands)
        self.graph.replay()
        paged_attention.launches += self._launches[0]
        paged_attention.merge_launches += self._launches[1]
        return self._out

