"""Blockwise (flash) attention, forward and backward: the CUDA kernels'
wrappers and their plain PyTorch versions (counterpart of
``torchdistx_tpu/ops/flash_attention.py``).

Layout contract (the JAX package's, unchanged):

* the raw entry points :func:`flash_forward` / :func:`flash_backward` take
  q, o, do, dq as [B·H, S, D] and k, v, dk, dv as [B·KV, T, D] (query head
  row ``bh`` reads kv row ``bh // G``, G = H / KV), with ``lse`` and
  ``delta`` as [B·H, S] float32;
* :func:`flash_attention` has the model ``AttnFn`` signature, q
  [B, S, H, D] and k, v [B, T, KV, D], and is differentiable through a
  ``torch.autograd.Function`` whose backward runs the dq and dk/dv
  kernels.

Masks follow ``default_attention``'s convention: causal query i sees key
j <= i + T - S (the last query aligned with the last key), and with
``segment_ids`` only keys of its own segment.  A query that sees no key
gets a zero output row, lse = -1e30 and zero gradients — in the kernels
and in the plain versions alike (``default_attention`` softmaxes uniform
masked logits there instead; don't build packings with empty segments).

CUDA tensors launch the hand-written kernels (``csrc/flash_attention.cu``)
on the current stream, or raise; CPU tensors run the plain versions
:func:`flash_forward_reference` / :func:`flash_backward_reference`,
because they lie on the CPU.  Nothing falls back from one to the other.
Each kernel launch adds one to its entry of :data:`launches`.

The additive ``bias`` operand and its gradient kernel are not ported yet
(ROADMAP A9 / B5): passing one raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build
from .segments import normalize_segment_ids

_NEG = -1e30
_HEAD_DIMS = (16, 32, 64, 128)  # the kernels' head dims
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "flash_attention.cu"

#: Kernel launches since the last reset, by kernel.
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

Segments = Optional[Tuple[torch.Tensor, torch.Tensor]]  # ([B, S], [B, T])


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _visible(BH, S, T, causal, seg: Segments, device) -> torch.Tensor:
    """[BH or 1, S, T] bool: which keys each query sees."""
    mask = torch.ones(1, S, T, dtype=torch.bool, device=device)
    if causal:
        mask = mask.tril(T - S)
    if seg is not None:
        q_seg, kv_seg = seg
        same = q_seg[:, :, None] == kv_seg[:, None, :]  # [B, S, T]
        mask = mask & same.repeat_interleave(BH // q_seg.shape[0], dim=0)
    return mask


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The plain versions compute in f32, or in f64 for f64 inputs (an
    exact answer to hold an f32 kernel against)."""
    return t if t.dtype == torch.float64 else t.float()


def _dense_probs(q, k, causal, seg: Segments):
    """Masked logits [BH, S, T], the mask, and k broadcast to q heads."""
    BH, S, D = q.shape
    BKV, T, _ = k.shape
    kf = _wide(k).repeat_interleave(BH // BKV, dim=0)
    s = torch.bmm(_wide(q) * (1.0 / math.sqrt(D)), kf.transpose(1, 2))
    mask = _visible(BH, S, T, causal, seg, q.device)
    return s.masked_fill(~mask, _NEG), mask, kf


def flash_forward_reference(q, k, v, causal: bool = True, seg: Segments = None):
    """The forward kernel's function, dense in f32: ``(out [BH, S, D] in
    q's dtype, lse [BH, S] f32)``."""
    BH, BKV = q.shape[0], k.shape[0]
    s, mask, _ = _dense_probs(q, k, causal, seg)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    vf = _wide(v).repeat_interleave(BH // BKV, dim=0)
    out = torch.bmm(p, vf) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return out.to(q.dtype), lse


def flash_backward_reference(q, k, v, do, lse, delta, causal: bool = True,
                             seg: Segments = None):
    """The dq and dk/dv kernels' function, dense in f32 (the TPU kernels'
    ``_block_p_ds``): p = exp(s - lse), ds = p (do vᵀ - delta) / sqrt(D);
    dk and dv summed over each kv head's group of query heads."""
    BH, S, D = q.shape
    BKV, T, _ = k.shape
    G = BH // BKV
    s, mask, kf = _dense_probs(q, k, causal, seg)
    p = torch.where(mask, torch.exp(s - lse[:, :, None]), 0.0)
    vf = _wide(v).repeat_interleave(G, dim=0)
    dof = _wide(do)
    dp = torch.bmm(dof, vf.transpose(1, 2))
    ds = p * (dp - delta[:, :, None]) * (1.0 / math.sqrt(D))
    dq = torch.bmm(ds, kf)
    dk = torch.bmm(ds.transpose(1, 2), _wide(q)).view(BKV, G, T, D).sum(1)
    dv = torch.bmm(p.transpose(1, 2), dof).view(BKV, G, T, D).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check_shapes(q, k, v, seg: Segments) -> None:
    BH, S, D = q.shape
    BKV, T, Dk = k.shape
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} != v {tuple(v.shape)}")
    if Dk != D:
        raise ValueError(f"head_dim mismatch: q has {D}, k has {Dk}")
    if BH % BKV:
        raise ValueError(
            f"Query heads ({BH} rows) must be a multiple of KV heads "
            f"({BKV} rows).")
    if D not in _HEAD_DIMS:
        raise ValueError(
            f"flash attention takes head_dim in {_HEAD_DIMS}, got {D}")
    if seg is not None:
        B = seg[0].shape[0]
        if BH % B or BKV % B or tuple(seg[0].shape) != (B, S) \
                or tuple(seg[1].shape) != (B, T):
            raise ValueError(
                f"segment ids {tuple(seg[0].shape)} / {tuple(seg[1].shape)} "
                f"do not fit q rows {BH} x {S} and kv rows {BKV} x {T}")


def _check_cuda(operands, rows=(), seg: Segments = None) -> None:
    """``operands`` share q's dtype (f32 or bf16) and are 16-byte aligned
    (the kernels load them in 16-byte vectors), ``rows`` are f32, the
    segment ids int32; all contiguous and on q's device."""
    q = operands[0]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"flash attention kernels take float32 or bfloat16, got {q.dtype}")
    groups = ((operands, q.dtype), (rows, torch.float32), (seg or (), torch.int32))
    for tensors, dtype in groups:
        for t in tensors:
            if t.device != q.device:
                raise ValueError(
                    "flash attention: all operands must be on one device")
            if t.dtype != dtype:
                raise TypeError(f"flash attention: {t.dtype} where {dtype}")
            if not t.is_contiguous() or (tensors is operands
                                         and t.data_ptr() % 16):
                raise ValueError(
                    "flash attention kernels take contiguous operands, "
                    "q/k/v/do 16-byte aligned")


def _dims(q, k, seg: Segments):
    """(B, H, KV) for the kernels: without segment ids the batch split is
    irrelevant, so rows count as heads of one batch item."""
    B = 1 if seg is None else seg[0].shape[0]
    return B, q.shape[0] // B, k.shape[0] // B


_fns = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = _build.load(_SOURCE)
        fn = getattr(lib, f"tdx_{name}")
        n_ptr = {"flash_fwd": 7, "flash_bwd_dq": 9, "flash_bwd_dkv": 10}[name]
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.tdx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tdx_cuda_error_string.restype = ctypes.c_char_p
        _fns[name] = fn
    return fn


def _seg_ptrs(seg: Segments):
    return [None, None] if seg is None else [s.data_ptr() for s in seg]


def _launch(name: str, ptrs, q, k, seg: Segments, causal: bool) -> None:
    """Launch kernel ``name`` on the current stream with its operand
    pointers ``ptrs`` (in the C signature's order) and raise on a refused
    launch."""
    B, H, KV = _dims(q, k, seg)
    S, D = q.shape[1], q.shape[2]
    T = k.shape[1]
    fn = _kernel(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, B, H, KV, S, T, D, int(causal), _DTYPE_CODE[q.dtype],
                 1.0 / math.sqrt(D), stream)
    if err != 0:
        msg = _build.load(_SOURCE).tdx_cuda_error_string(err)
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} ({msg.decode()})")
    launches[name] += 1


def _cuda_segments(seg: Segments) -> Segments:
    if seg is None:
        return None
    return tuple(s.to(torch.int32).contiguous() for s in seg)


def flash_forward(q, k, v, *, causal: bool = True, segment_ids: Segments = None):
    """``(out [BH, S, D], lse [BH, S] f32)`` at the raw layout;
    ``segment_ids`` is ``None`` or a ``(q_seg [B, S], kv_seg [B, T])``
    pair."""
    _check_shapes(q, k, v, segment_ids)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, causal, segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    seg = _cuda_segments(segment_ids)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _check_cuda((q, k, v, out), (lse,), seg)
    _launch("flash_fwd", [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          *_seg_ptrs(seg), out.data_ptr(), lse.data_ptr()],
            q, k, seg, causal)
    return out, lse


def _backward_operands(q, k, v, do, lse, delta, segment_ids: Segments):
    """Checks for the backward kernels; the segment ids as int32."""
    _check_shapes(q, k, v, segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernels run on cuda, not {q.device}")
    if do.shape != q.shape or lse.shape != q.shape[:2] \
            or delta.shape != q.shape[:2]:
        raise ValueError("do, lse or delta do not match q")
    seg = _cuda_segments(segment_ids)
    _check_cuda((q, k, v, do), (lse, delta), seg)
    return seg


def flash_backward_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                      segment_ids: Segments = None):
    """The dq kernel alone, on CUDA tensors."""
    seg = _backward_operands(q, k, v, do, lse, delta, segment_ids)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), *_seg_ptrs(seg), dq.data_ptr()],
            q, k, seg, causal)
    return dq


def flash_backward_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                       segment_ids: Segments = None):
    """The dk/dv kernel alone, on CUDA tensors: ``(dk, dv)``."""
    seg = _backward_operands(q, k, v, do, lse, delta, segment_ids)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), *_seg_ptrs(seg), dk.data_ptr(),
             dv.data_ptr()],
            q, k, seg, causal)
    return dk, dv


def flash_backward(q, k, v, do, lse, delta, *, causal: bool = True,
                   segment_ids: Segments = None):
    """``(dq, dk, dv)`` at the raw layout from the forward's ``lse`` and
    ``delta = rowsum(do * out)`` (both [BH, S] f32)."""
    if q.device.type == "cpu":
        _check_shapes(q, k, v, segment_ids)
        return flash_backward_reference(q, k, v, do, lse, delta, causal,
                                        segment_ids)
    kw = dict(causal=causal, segment_ids=segment_ids)
    dq = flash_backward_dq(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_backward_dkv(q, k, v, do, lse, delta, **kw))


class _FlashCore(torch.autograd.Function):
    """The custom VJP of the JAX ``_flash_core``: the forward kernel saves
    (out, lse); the backward computes delta = rowsum(do * out) (plain
    torch, outside the kernels as in the JAX package) and runs the dq and
    dk/dv kernels."""

    @staticmethod
    def forward(ctx, qh, kh, vh, causal, q_seg, kv_seg):
        seg = None if q_seg is None else (q_seg, kv_seg)
        out, lse = flash_forward(qh, kh, vh, causal=causal, segment_ids=seg)
        ctx.save_for_backward(qh, kh, vh, out, lse, q_seg, kv_seg)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        qh, kh, vh, out, lse, q_seg, kv_seg = ctx.saved_tensors
        seg = None if q_seg is None else (q_seg, kv_seg)
        delta = (do.float() * out.float()).sum(-1)
        dq, dk, dv = flash_backward(qh, kh, vh, do.contiguous(), lse, delta,
                                    causal=ctx.causal, segment_ids=seg)
        return dq, dk, dv, None, None, None


# ---------------------------------------------------------------------------
# public API (model AttnFn layout [B, S, H, D])
# ---------------------------------------------------------------------------


def flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, KV, D]
    v: torch.Tensor,  # [B, T, KV, D]
    *,
    causal: bool = True,
    bias: Optional[torch.Tensor] = None,
    segment_ids=None,  # [B, S] or ([B, S], [B, T]): packed sequences
    block_q: int = 1024,
    block_k: int = 1024,
) -> torch.Tensor:
    """Flash attention with the model ``AttnFn`` signature (GQA-aware,
    differentiable through the backward kernels).

    ``block_q`` / ``block_k`` are accepted for the JAX signature's sake;
    the CUDA kernels choose their own tiles."""
    del block_q, block_k
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(
            f"Query heads ({H}) must be a multiple of KV heads ({KV})."
        )
    if bias is not None:
        raise NotImplementedError(
            "flash_attention's additive bias (the bias operand of the "
            "forward and backward kernels and the d(bias) kernel) is not "
            "ported yet: ROADMAP A9 / B5")
    q_seg = kv_seg = None
    if segment_ids is not None:
        q_seg, kv_seg = normalize_segment_ids(segment_ids, B, S, T)
    qh = q.transpose(1, 2).reshape(B * H, S, D).contiguous()
    kh = k.transpose(1, 2).reshape(B * KV, T, D).contiguous()
    vh = v.transpose(1, 2).reshape(B * KV, T, D).contiguous()
    out = _FlashCore.apply(qh, kh, vh, causal, q_seg, kv_seg)
    return out.reshape(B, H, S, D).transpose(1, 2)


def make_flash_attention(*, block_q: int = 1024, block_k: int = 1024):
    """An ``AttnFn`` for model constructors."""

    def attn_fn(q, k, v, *, causal=True, bias=None, segment_ids=None):
        return flash_attention(
            q, k, v, causal=causal, bias=bias, segment_ids=segment_ids,
            block_q=block_q, block_k=block_k,
        )

    return attn_fn
