"""Ragged paged-attention decode: the CUDA kernel's wrapper and its plain
PyTorch version (counterpart of ``torchdistx_tpu/ops/paged_attention.py``).

The serving decode step computes attention for ONE new query token per
sequence over that sequence's whole context, which lives scattered across
fixed-size pages of a preallocated pool (:mod:`..serve.kv_cache`).

Layout contract (the JAX package's, unchanged):

* ``q``: [B, H, D] — one decode token per sequence;
* ``k_pages`` / ``v_pages``: [P, page_size, KV, D] — one layer's pool;
* ``lengths``: [B] int32 — tokens of context per sequence INCLUDING the
  one ``q`` belongs to (its K/V must already be written to its page);
* ``page_table``: [B, max_pages] int32 — pool page ids per sequence, in
  order; entries past ``ceil(lengths[b] / page_size)`` are never read.

A sequence with ``lengths[b] == 0`` (an idle batch slot) produces a zero
output row in the kernel; the plain version softmaxes uniform masked
logits there instead — callers must ignore idle rows.

:func:`paged_attention` runs the hand-written CUDA kernel
(``csrc/paged_decode.cu``) on CUDA tensors and the plain version
:func:`paged_attention_reference` on CPU tensors, because they lie on
the CPU; it never falls back from one to the other.  On the card the
positions are split across CTAs (:func:`split_plan`, from the page
table's width and the card's SM count only) and, with more than one
split, a second kernel merges the splits by their softmax statistics.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from . import _build

_NEG = -1e30
_MAX_HEAD_DIM = 256  # kMaxD in csrc/paged_decode.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The split plan: enough CTAs for _CTAS_PER_SM per SM, each split at
# least _MIN_SPAN positions (shorter ones spend more on their merge than
# they save), spans a multiple of _SPAN_ALIGN (two rounds of the 8 warps'
# blocks of 4 positions).
_CTAS_PER_SM = 4
_MIN_SPAN = 256
_SPAN_ALIGN = 64


def paged_attention_reference(
    q: torch.Tensor,  # [B, H, D]
    k_pages: torch.Tensor,  # [P, page, KV, D]
    v_pages: torch.Tensor,  # [P, page, KV, D]
    lengths: torch.Tensor,  # [B] int32
    page_table: torch.Tensor,  # [B, max_pages] int32
) -> torch.Tensor:
    """Gather the mapped pages, mask past ``lengths``, f32 softmax —
    numerically the same computation as ``default_attention`` on the
    gathered layout."""
    B, H, D = q.shape
    page = k_pages.shape[1]
    KV = k_pages.shape[2]
    groups = H // KV
    maxp = page_table.shape[1]
    T = maxp * page

    table = page_table.long()
    k = k_pages[table].reshape(B, T, KV, D).float()
    v = v_pages[table].reshape(B, T, KV, D).float()
    qf = q.float() * (1.0 / math.sqrt(D))
    qf = qf.reshape(B, KV, groups, D)
    logits = torch.einsum("bkgd,btkd->bkgt", qf, k)
    mask = torch.arange(T, device=q.device)[None, :] < lengths[:, None].long()
    logits = logits.masked_fill(~mask[:, None, None], _NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v)
    return out.reshape(B, H, D).to(q.dtype)


def paged_prefill_attention(
    q: torch.Tensor,  # [B, S, H, D] — a chunk of query tokens per sequence
    k_pages: torch.Tensor,  # [P, page, KV, D]
    v_pages: torch.Tensor,  # [P, page, KV, D]
    q_positions: torch.Tensor,  # [B, S] int32 — absolute positions of q
    lengths: torch.Tensor,  # [B] int32 — valid context INCLUDING the chunk
    page_table: torch.Tensor,  # [B, max_pages] int32
) -> torch.Tensor:
    """Chunked-prefill attention through the page table: each query at
    absolute position ``t`` attends every cached position ``<= t`` below
    ``lengths[b]``.  Rows of positions at or past ``lengths[b]`` are
    padding, garbage the caller ignores."""
    B, S, H, D = q.shape
    page = k_pages.shape[1]
    KV = k_pages.shape[2]
    groups = H // KV
    maxp = page_table.shape[1]
    T = maxp * page

    table = page_table.long()
    k = k_pages[table].reshape(B, T, KV, D).float()
    v = v_pages[table].reshape(B, T, KV, D).float()
    qf = q.float() * (1.0 / math.sqrt(D))
    qf = qf.reshape(B, S, KV, groups, D)
    logits = torch.einsum("bskgd,btkd->bskgt", qf, k)
    tpos = torch.arange(T, device=q.device)[None, None, :]
    mask = (tpos <= q_positions[:, :, None].long()) & (
        tpos < lengths[:, None, None].long()
    )  # [B, S, T]
    logits = logits.masked_fill(~mask[:, :, None, None, :], _NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bskgt,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, D).to(q.dtype)


def _check_shapes(q, k_pages, v_pages, lengths, page_table) -> None:
    B, H, D = q.shape
    _, _, KV, Dk = k_pages.shape
    if Dk != D:
        raise ValueError(f"head_dim mismatch: q has {D}, pages have {Dk}")
    if v_pages.shape != k_pages.shape:
        raise ValueError(
            f"k_pages {tuple(k_pages.shape)} != v_pages {tuple(v_pages.shape)}"
        )
    if H % KV:
        raise ValueError(
            f"Query heads ({H}) must be a multiple of KV heads ({KV})."
        )
    if page_table.shape[0] != B or tuple(lengths.shape) != (B,):
        raise ValueError(
            f"batch mismatch: q {B}, page_table {tuple(page_table.shape)}, "
            f"lengths {tuple(lengths.shape)}"
        )


def _check_cuda(q, k_pages, v_pages, lengths, page_table) -> None:
    tensors = (q, k_pages, v_pages, lengths, page_table)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all operands must be on one device")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"paged_attention kernel takes float32 or bfloat16, got {q.dtype}"
        )
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(
            f"dtype mismatch: q {q.dtype}, pages {k_pages.dtype}/{v_pages.dtype}"
        )
    if lengths.dtype != torch.int32 or page_table.dtype != torch.int32:
        raise TypeError("lengths and page_table must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention kernel takes contiguous operands")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention kernel takes 16-byte aligned pools")
    if q.shape[2] > _MAX_HEAD_DIM:
        raise ValueError(
            f"head_dim {q.shape[2]} > {_MAX_HEAD_DIM} is not supported")


def split_plan(B: int, H: int, KV: int, positions: int,
               sm_count: int) -> Tuple[int, int]:
    """``(splits, span)``: the kernel cuts a table of ``positions`` (its
    width times the page size) into ``splits`` ranges of ``span``
    positions, one CTA each per (kv head, sequence, chunk of query heads:
    the largest of 8, 4, 2, 1 that divides H / KV, as in the kernel), so
    that a few long lanes still fill the card.  Static facts only: it
    never reads ``lengths``, so a launch needs no device value on the host
    and can be captured into a CUDA graph."""
    G = H // KV
    ctas = KV * B * G // next(c for c in (8, 4, 2, 1) if G % c == 0)
    splits = max(1, min(-(-_CTAS_PER_SM * sm_count // ctas),
                        -(-positions // _MIN_SPAN)))
    span = -(-positions // splits)
    span = -(-span // _SPAN_ALIGN) * _SPAN_ALIGN
    return -(-positions // span), span


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_plan(q: torch.Tensor, k_pages: torch.Tensor,
                page_table: torch.Tensor) -> Tuple[int, int]:
    """The ``(splits, span)`` that :func:`paged_attention` launches with
    for these operands on their card; one CUDA launch per call with one
    split, two (the split kernel and the merge) with more."""
    B, H, _ = q.shape
    _, page, KV, _ = k_pages.shape
    return split_plan(B, H, KV, page_table.shape[1] * page,
                      _sm_count(q.device.index))


_kernel_fn = None


def _kernel():
    global _kernel_fn
    if _kernel_fn is None:
        lib = _build.load("paged_decode.cu")
        fn = lib.tdx_paged_decode
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        lib.tdx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tdx_cuda_error_string.restype = ctypes.c_char_p
        _kernel_fn = fn
    return _kernel_fn


def build_kernel() -> None:
    """Build and load the CUDA kernel now (a replica's warm-up), instead
    of at its first launch."""
    _kernel()


def paged_attention(
    q: torch.Tensor,  # [B, H, D]
    k_pages: torch.Tensor,  # [P, page, KV, D]
    v_pages: torch.Tensor,  # [P, page, KV, D]
    lengths: torch.Tensor,  # [B] int32
    page_table: torch.Tensor,  # [B, max_pages] int32
) -> torch.Tensor:
    """Ragged paged-attention decode; output [B, H, D] in ``q``'s dtype.

    CUDA tensors launch the kernel on the current stream (or raise); CPU
    tensors run :func:`paged_attention_reference`.  Each call adds one to
    ``paged_attention.launches`` (one launch of the split kernel), and one
    to ``paged_attention.merge_launches`` where it also launched the merge
    kernel (with more than one split: :func:`kernel_plan`)."""
    _check_shapes(q, k_pages, v_pages, lengths, page_table)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, lengths,
                                         page_table)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not {q.device}")
    _check_cuda(q, k_pages, v_pages, lengths, page_table)
    fn = _kernel()
    B, H, D = q.shape
    _, page, KV, _ = k_pages.shape
    splits, span = kernel_plan(q, k_pages, page_table)
    out = torch.empty_like(q)
    merged = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        # The splits' partial rows, maxima and sums, from the caching
        # allocator on the current stream.
        part = None if splits == 1 else torch.empty(
            B * H * splits * (D + 2), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 lengths.data_ptr(), page_table.data_ptr(), out.data_ptr(),
                 None if part is None else part.data_ptr(),
                 B, H, KV, D, page, page_table.shape[1], splits, span,
                 _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(D), stream,
                 ctypes.byref(merged))
    if err != 0:
        msg = _build.load("paged_decode.cu").tdx_cuda_error_string(err)
        raise RuntimeError(
            f"paged_decode launch failed: CUDA error {err} ({msg.decode()})"
        )
    paged_attention.launches += 1
    paged_attention.merge_launches += merged.value
    return out


paged_attention.launches = 0
paged_attention.merge_launches = 0
