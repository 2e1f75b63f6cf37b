"""Blockwise (flash) attention, forward and backward: the CUDA kernels'
wrappers and their plain PyTorch versions (counterpart of
``torchdistx_tpu/ops/flash_attention.py``).

Layout contract (the JAX package's, unchanged):

* the raw entry points :func:`flash_forward` / :func:`flash_backward` take
  q, o, do, dq as [B·H, S, D] and k, v, dk, dv as [B·KV, T, D] (query head
  row ``bh`` reads kv row ``bh // G``, G = H / KV), with ``lse`` and
  ``delta`` as [B·H, S] float32;
* an additive ``bias`` is f32 [Hb, S, T], Hb = H or 1: row ``bh`` adds
  plane ``(bh % H) % Hb`` to its scaled scores, so the raw entry points
  take ``heads`` = H (the query heads of one batch item) beside it, and
  :func:`flash_backward_dbias` computes its gradient, the sum of
  ``p * (dp - delta)`` over the rows of each plane;
* :func:`flash_attention` has the model ``AttnFn`` signature, q
  [B, S, H, D] and k, v [B, T, KV, D], and is differentiable through a
  ``torch.autograd.Function`` whose backward runs the dq, dk/dv and (with
  a bias) d(bias) kernels.

Masks follow ``default_attention``'s convention: causal query i sees key
j <= i + T - S (the last query aligned with the last key), and with
``segment_ids`` only keys of its own segment.  A query that sees no key
gets a zero output row, lse = -1e30 and zero gradients — in the kernels
and in the plain versions alike (``default_attention`` softmaxes uniform
masked logits there instead; don't build packings with empty segments).

The backward's ``delta = rowsum(do * o)`` is taken from the forward's
output before its rounding to q's dtype (the forward kernel writes an f32
copy on request), not from the rounded output as the JAX package's
``_delta_carrier`` does.  In exact arithmetic ``sum_j dS_ij = 0``, so the
component of the keys shared by every position drops out of dq; with
delta off by the output's bf16 rounding it does not, and when attention
is near-uniform over keys with a large shared component (T5-11B's
cross-attention after one training step: shared / deviation ~ 18) that
error is larger than dq itself.

CUDA tensors launch the hand-written kernels (``csrc/flash_attention.cu``)
on the current stream, or raise; CPU tensors run the plain versions
:func:`flash_forward_reference` / :func:`flash_backward_reference`,
because they lie on the CPU.  Nothing falls back from one to the other.
Each kernel launch adds one to its entry of :data:`launches`, and a
launch with a bias also to its entry of :data:`bias_launches`.

Launch shapes (the JAX package's ``block_q`` / ``block_k``): the bf16
forward and dq kernels run W warps a CTA, 16 query rows each, over
64-key tiles, so a block is ``(16·W, 64)``; :func:`built_blocks` lists
the shapes the library has (W = 4 at every head dim, W = 8 at D = 128).
``None`` or the JAX default 1024 keeps the default rule (W = 4, W = 8
at D = 128 with a bias).  Any other shape raises :class:`BlockConfigError`
naming the built ones, as does a launch the card refuses at a requested
shape; nothing falls back to another shape.  The dk/dv and d(bias)
kernels and the f32 kernels have fixed shapes (an explicit block on f32
operands raises).  On CPU tensors blocks mean nothing and are ignored.
:mod:`.autotune` picks a block by timing the built ones.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .segments import normalize_segment_ids

_NEG = -1e30
_HEAD_DIMS = (16, 32, 64, 128)  # the kernels' head dims
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "flash_attention.cu"

#: Kernel launches since the last reset, by kernel.
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_dbias": 0}
#: The same, counting only launches with a bias operand.
bias_launches = dict(launches)

Segments = Optional[Tuple[torch.Tensor, torch.Tensor]]  # ([B, S], [B, T])


class BlockConfigError(RuntimeError):
    """A launch shape the library does not build, or that the card
    refused (shared memory, registers) at this call's operands."""


_DEFAULT_BLOCK = 1024  # the JAX package's default: keep the default rule
_BLOCK_K = 64  # the key tile of the bf16 forward / dq kernels


def built_blocks(dtype, head_dim: int) -> Tuple[Tuple[int, int], ...]:
    """The ``(block_q, block_k)`` launch shapes the library builds for
    the forward and dq kernels at ``dtype`` and ``head_dim``."""
    if dtype != torch.bfloat16 or head_dim not in _HEAD_DIMS:
        return ()
    warps = (4, 8) if head_dim == 128 else (4,)
    return tuple((16 * w, _BLOCK_K) for w in warps)


def launch_warps(block_q, block_k, dtype, head_dim: int) -> int:
    """W for a requested block (0: the default rule); raises
    :class:`BlockConfigError` for a shape the library does not build."""
    default_q = block_q in (None, _DEFAULT_BLOCK)
    default_k = block_k in (None, _DEFAULT_BLOCK)
    if default_q and default_k:
        return 0
    built = built_blocks(dtype, head_dim)
    want = (block_q, _BLOCK_K if default_k else block_k)
    if default_q and want[1] == _BLOCK_K and built:
        return 0
    if want not in built:
        raise BlockConfigError(
            f"block (block_q={block_q}, block_k={block_k}) is not built for "
            f"{dtype} at head_dim {head_dim}; the built blocks are "
            f"{list(built) or 'none (fixed tiles)'}, or None / "
            f"{_DEFAULT_BLOCK} for the default rule")
    return want[0] // 16


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        bias_launches[name] = 0


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


def _heads(bias, heads):
    """H for the bias planes: ``heads`` if given, else a per-head bias's
    plane count (a head-broadcast bias reads plane 0 whatever H is)."""
    if heads is None and bias is not None and bias.shape[0] > 1:
        return bias.shape[0]
    return heads


def _per_plane(x: torch.Tensor, Hb: int, heads) -> torch.Tensor:
    """[BH, S, T] rows as [BH / Hb', Hb', S, T] groups of bias planes (Hb'
    = Hb = H, or 1 with every row reading the one plane)."""
    BH, S, T = x.shape
    n = heads if Hb > 1 else 1
    return x.view(BH // n, n, S, T)


def _dense_probs(q, k, causal, seg: Segments, bias=None, heads=None):
    """Masked logits [BH, S, T], the mask, and k broadcast to q heads."""
    BH, S, D = q.shape
    BKV, T, _ = k.shape
    kf = _wide(k).repeat_interleave(BH // BKV, dim=0)
    s = torch.bmm(_wide(q) * (1.0 / math.sqrt(D)), kf.transpose(1, 2))
    if bias is not None:
        s = (_per_plane(s, bias.shape[0], _heads(bias, heads))
             + bias.to(s.dtype)).view(BH, S, T)
    mask = _visible(BH, S, T, causal, seg, q.device)
    return s.masked_fill(~mask, _NEG), mask, kf


def flash_forward_reference(q, k, v, causal: bool = True, seg: Segments = None,
                            bias=None, heads=None):
    """The forward kernel's function, dense in f32: ``(out [BH, S, D] in
    q's dtype, lse [BH, S] f32)``; ``bias`` [Hb, S, T] is added to the
    scaled scores of each row's plane."""
    out, lse = _forward_wide(q, k, v, causal, seg, bias, heads)
    return out.to(q.dtype), lse


def _forward_wide(q, k, v, causal, seg, bias, heads):
    """The forward's output before its rounding to q's dtype (f32, or f64
    for f64 inputs), and lse."""
    BH, BKV = q.shape[0], k.shape[0]
    s, mask, _ = _dense_probs(q, k, causal, seg, bias, heads)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    vf = _wide(v).repeat_interleave(BH // BKV, dim=0)
    out = torch.bmm(p, vf) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return out, lse


def flash_backward_reference(q, k, v, do, lse, delta, causal: bool = True,
                             seg: Segments = None, bias=None, heads=None):
    """The dq, dk/dv and d(bias) kernels' function, dense in f32 (the TPU
    kernels' ``_block_p_ds``): p = exp(s [+ bias] - lse), ds = p (do vᵀ -
    delta) / sqrt(D); dk and dv summed over each kv head's group of query
    heads.  ``(dq, dk, dv)``, and with a bias also d(bias) [Hb, S, T] =
    p (do vᵀ - delta) summed over the rows of each plane, in f32 (f64 for
    f64 inputs)."""
    BH, S, D = q.shape
    BKV, T, _ = k.shape
    G = BH // BKV
    s, mask, kf = _dense_probs(q, k, causal, seg, bias, heads)
    p = torch.where(mask, torch.exp(s - lse[:, :, None]), 0.0)
    vf = _wide(v).repeat_interleave(G, dim=0)
    dof = _wide(do)
    dp = torch.bmm(dof, vf.transpose(1, 2))
    dlogits = p * (dp - delta[:, :, None])
    ds = dlogits * (1.0 / math.sqrt(D))
    dq = torch.bmm(ds, kf)
    dk = torch.bmm(ds.transpose(1, 2), _wide(q)).view(BKV, G, T, D).sum(1)
    dv = torch.bmm(p.transpose(1, 2), dof).view(BKV, G, T, D).sum(1)
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    if bias is None:
        return grads
    Hb = bias.shape[0]
    return (*grads, _per_plane(dlogits, Hb, _heads(bias, heads)).sum(0))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check_shapes(q, k, v, seg: Segments, bias=None, heads=None) -> None:
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
    heads = _heads(bias, heads)
    if heads is not None:
        B = BH // heads if BH % heads == 0 else 0
        if not B or BKV % B or (seg is not None and seg[0].shape[0] != B):
            raise ValueError(
                f"heads={heads} does not divide q rows {BH} into batch items "
                f"that also split kv rows {BKV} and the segment ids")
    if bias is not None and (bias.dim() != 3 or tuple(bias.shape[1:]) != (S, T)
                             or bias.shape[0] not in (1, heads)):
        raise ValueError(
            f"bias must be [H or 1, S, T] = [{heads} or 1, {S}, {T}] at the "
            f"raw layout, got {tuple(bias.shape)}")


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


def _dims(q, k, seg: Segments, heads):
    """(B, H, KV) for the kernels: the true split when ``heads`` is known
    (a per-head bias indexes its plane by the head, bh % H) or segment ids
    give B; otherwise the split is irrelevant, so rows count as heads of
    one batch item."""
    if heads is not None:
        B = q.shape[0] // heads
    else:
        B = 1 if seg is None else seg[0].shape[0]
    return B, q.shape[0] // B, k.shape[0] // B


_fns = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = _build.load(_SOURCE)
        fn = getattr(lib, f"tdx_{name}")
        n_ptr = {"flash_fwd": 9, "flash_bwd_dq": 10, "flash_bwd_dkv": 11,
                 "flash_dbias": 10}[name]
        # B, H, KV, Hb, S, T, D, causal, dtype (and warps for the two
        # kernels with a launch-shape choice).
        n_int = 10 if name in ("flash_fwd", "flash_bwd_dq") else 9
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.tdx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tdx_cuda_error_string.restype = ctypes.c_char_p
        _fns[name] = fn
    return fn


def _extra_ptrs(bias, seg: Segments):
    """The bias and segment-id pointers (null where absent)."""
    segs = [None, None] if seg is None else [s.data_ptr() for s in seg]
    return [_opt_ptr(bias), *segs]


# cudaErrorInvalidValue (a shared-memory request over the card's limit),
# cudaErrorInvalidConfiguration, cudaErrorLaunchOutOfResources (registers).
_REFUSED = (1, 9, 701)


def _launch(name: str, ptrs, q, k, seg: Segments, causal: bool, bias,
            heads, warps: int = 0) -> None:
    """Launch kernel ``name`` on the current stream with its operand
    pointers ``ptrs`` (in the C signature's order) and raise on a refused
    launch (:class:`BlockConfigError` where a requested ``warps`` was
    refused)."""
    B, H, KV = _dims(q, k, seg, _heads(bias, heads))
    S, D = q.shape[1], q.shape[2]
    T = k.shape[1]
    Hb = 0 if bias is None else bias.shape[0]
    fn = _kernel(name)
    shape = (warps,) if name in ("flash_fwd", "flash_bwd_dq") else ()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, B, H, KV, Hb, S, T, D, int(causal),
                 _DTYPE_CODE[q.dtype], *shape, 1.0 / math.sqrt(D), stream)
    if err != 0:
        msg = _build.load(_SOURCE).tdx_cuda_error_string(err).decode()
        if warps and err in _REFUSED:
            raise BlockConfigError(
                f"{name} refused the launch shape of {warps} warps "
                f"(block_q={16 * warps}): CUDA error {err} ({msg})")
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} ({msg})")
    launches[name] += 1
    if bias is not None:
        bias_launches[name] += 1


def _cuda_segments(seg: Segments) -> Segments:
    if seg is None:
        return None
    return tuple(s.to(torch.int32).contiguous() for s in seg)


def flash_forward(q, k, v, *, causal: bool = True, segment_ids: Segments = None,
                  bias=None, heads=None, block_q=None, block_k=None):
    """``(out [BH, S, D], lse [BH, S] f32)`` at the raw layout;
    ``segment_ids`` is ``None`` or a ``(q_seg [B, S], kv_seg [B, T])``
    pair; ``bias`` is ``None`` or f32 [H or 1, S, T] with ``heads`` = H
    (taken from a per-head bias when omitted); ``block_q`` / ``block_k``
    a built launch shape (module docstring)."""
    out, lse, _ = _flash_forward(q, k, v, causal, segment_ids, bias, heads,
                                 False, block_q, block_k)
    return out, lse


def _flash_forward(q, k, v, causal, segment_ids: Segments, bias, heads,
                   want_f32: bool, block_q=None, block_k=None):
    """:func:`flash_forward`'s ``(out, lse)`` and, with ``want_f32``, the
    output before its rounding to q's dtype (``out`` itself for f32 q),
    else ``None``: the backward's delta is taken from it."""
    _check_shapes(q, k, v, segment_ids, bias, heads)
    if q.device.type == "cpu":
        wide, lse = _forward_wide(q, k, v, causal, segment_ids, bias, heads)
        return wide.to(q.dtype), lse, wide if want_f32 else None
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    warps = launch_warps(block_q, block_k, q.dtype, q.shape[-1])
    seg = _cuda_segments(segment_ids)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    out32 = None
    if want_f32 and q.dtype != torch.float32:
        out32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _check_cuda((q, k, v, out), (lse,) + _opt(bias) + _opt(out32), seg)
    _launch("flash_fwd", [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          *_extra_ptrs(bias, seg), out.data_ptr(),
                          lse.data_ptr(), _opt_ptr(out32)],
            q, k, seg, causal, bias, heads, warps)
    if not want_f32:
        return out, lse, None
    return out, lse, out if out32 is None else out32


def _opt_ptr(t):
    return None if t is None else t.data_ptr()


def _opt(t) -> tuple:
    return () if t is None else (t,)


def _backward_operands(q, k, v, do, lse, delta, segment_ids: Segments, bias,
                       heads):
    """Checks for the backward kernels; the segment ids as int32."""
    _check_shapes(q, k, v, segment_ids, bias, heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernels run on cuda, not {q.device}")
    if do.shape != q.shape or lse.shape != q.shape[:2] \
            or delta.shape != q.shape[:2]:
        raise ValueError("do, lse or delta do not match q")
    seg = _cuda_segments(segment_ids)
    _check_cuda((q, k, v, do), (lse, delta) + _opt(bias), seg)
    return seg


def flash_backward_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                      segment_ids: Segments = None, bias=None, heads=None,
                      block_q=None, block_k=None):
    """The dq kernel alone, on CUDA tensors, at the launch shape
    ``block_q`` / ``block_k``."""
    seg = _backward_operands(q, k, v, do, lse, delta, segment_ids, bias, heads)
    warps = launch_warps(block_q, block_k, q.dtype, q.shape[-1])
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), *_extra_ptrs(bias, seg),
             dq.data_ptr()],
            q, k, seg, causal, bias, heads, warps)
    return dq


def flash_backward_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                       segment_ids: Segments = None, bias=None, heads=None):
    """The dk/dv kernel alone, on CUDA tensors: ``(dk, dv)``."""
    seg = _backward_operands(q, k, v, do, lse, delta, segment_ids, bias, heads)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), *_extra_ptrs(bias, seg),
             dk.data_ptr(), dv.data_ptr()],
            q, k, seg, causal, bias, heads)
    return dk, dv


def flash_backward_dbias(q, k, v, do, lse, delta, bias, *, causal: bool = True,
                         segment_ids: Segments = None, heads=None):
    """The d(bias) kernel alone, on CUDA tensors: f32 [Hb, S, T], the sum
    of p * (do vᵀ - delta) over the rows that read each bias plane."""
    seg = _backward_operands(q, k, v, do, lse, delta, segment_ids, bias, heads)
    dbias = torch.empty_like(bias)
    _launch("flash_dbias",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), *_extra_ptrs(bias, seg),
             dbias.data_ptr()],
            q, k, seg, causal, bias, heads)
    return dbias


def flash_backward(q, k, v, do, lse, delta, *, causal: bool = True,
                   segment_ids: Segments = None, bias=None, heads=None,
                   want_dbias: bool = False, block_q=None, block_k=None):
    """``(dq, dk, dv)`` at the raw layout from the forward's ``lse`` and
    ``delta = rowsum(do * out)`` (both [BH, S] f32), recomputing the
    probabilities with ``bias`` when one is given; with ``want_dbias``
    also the bias's gradient, f32 [Hb, S, T].  ``block_q`` / ``block_k``
    set the dq kernel's launch shape."""
    if want_dbias and bias is None:
        raise ValueError("want_dbias needs the bias")
    if q.device.type == "cpu":
        _check_shapes(q, k, v, segment_ids, bias, heads)
        grads = flash_backward_reference(q, k, v, do, lse, delta, causal,
                                         segment_ids, bias, heads)
        return grads if want_dbias else grads[:3]
    kw = dict(causal=causal, segment_ids=segment_ids, bias=bias, heads=heads)
    grads = (flash_backward_dq(q, k, v, do, lse, delta, block_q=block_q,
                               block_k=block_k, **kw),
             *flash_backward_dkv(q, k, v, do, lse, delta, **kw))
    if not want_dbias:
        return grads
    kw.pop("bias")
    return (*grads, flash_backward_dbias(q, k, v, do, lse, delta, bias, **kw))


# The kernels' entry points as custom ops, so a dispatch mode sees each
# call as one op: ``torch.utils.flop_counter`` counts them by the
# formulas below (it sees nothing inside a kernel).  On CPU tensors they
# run the plain versions, as the functions they wrap do.
@torch.library.custom_op(
    "tdx_torch::flash_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor? bias, Tensor? q_seg, "
           "Tensor? kv_seg, bool causal, int? heads, bool want_f32, "
           "int? block_q=None, int? block_k=None) -> (Tensor, Tensor, Tensor)")
def _fwd_op(q, k, v, bias, q_seg, kv_seg, causal, heads, want_f32,
            block_q=None, block_k=None):
    """:func:`_flash_forward`; the f32 output is empty where it would be
    the output itself (an op's outputs may not alias)."""
    seg = None if q_seg is None else (q_seg, kv_seg)
    out, lse, out32 = _flash_forward(q, k, v, causal, seg, bias, heads,
                                     want_f32, block_q, block_k)
    if out32 is None or out32 is out:
        out32 = q.new_empty(0, dtype=torch.float32)
    return out, lse, out32


@torch.library.custom_op(
    "tdx_torch::flash_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor do, Tensor lse, "
           "Tensor delta, Tensor? bias, Tensor? q_seg, Tensor? kv_seg, "
           "bool causal, int? heads, bool want_dbias, int? block_q=None, "
           "int? block_k=None) -> (Tensor, Tensor, Tensor, Tensor)")
def _bwd_op(q, k, v, do, lse, delta, bias, q_seg, kv_seg, causal, heads,
            want_dbias, block_q=None, block_k=None):
    """:func:`flash_backward`; d(bias) is empty unless asked for."""
    seg = None if q_seg is None else (q_seg, kv_seg)
    grads = flash_backward(q, k, v, do, lse, delta, causal=causal,
                           segment_ids=seg, bias=bias, heads=heads,
                           want_dbias=want_dbias, block_q=block_q,
                           block_k=block_k)
    dbias = grads[3] if want_dbias else q.new_empty(0, dtype=torch.float32)
    return (*grads[:3], dbias)


def visible_pairs(q, k, causal: bool, q_seg=None, kv_seg=None) -> int:
    """The (query row, key) pairs the kernels compute at the raw layout:
    q [BH, S, D], k [BKV, T, D]; causal keeps key j <= i + T - S, segment
    ids keep equal ids (reading them synchronizes with the device)."""
    BH, S = q.shape[:2]
    T = k.shape[1]
    if q_seg is None:
        if not causal:
            return BH * S * T
        return BH * sum(min(T, max(0, i + T - S + 1)) for i in range(S))
    mask = q_seg[:, :, None] == kv_seg[:, None, :]
    if causal:
        mask = mask & torch.ones(S, T, dtype=torch.bool,
                                 device=mask.device).tril(T - S)
    return BH // q_seg.shape[0] * int(mask.sum())


# Model FLOPs per visible pair and head-dim element: forward QKᵀ and PV
# (2 each); backward dP = dO·Vᵀ, dV = Pᵀ·dO, dQ = dS·K and dK = dSᵀ·Q (2
# each).  The backward kernels' recomputation of QKᵀ (and of dP in dk/dv)
# is not model work and is not counted, as MFU's convention has it.
@register_flop_formula(torch.ops.tdx_torch.flash_fwd, get_raw=True)
def _fwd_flops(q, k, v, bias, q_seg, kv_seg, causal, *_, out_val=None,
               **kwargs) -> int:
    return 4 * q.shape[2] * visible_pairs(q, k, causal, q_seg, kv_seg)


@register_flop_formula(torch.ops.tdx_torch.flash_bwd, get_raw=True)
def _bwd_flops(q, k, v, do, lse, delta, bias, q_seg, kv_seg, causal, *_,
               out_val=None, **kwargs) -> int:
    return 8 * q.shape[2] * visible_pairs(q, k, causal, q_seg, kv_seg)


class _FlashCore(torch.autograd.Function):
    """The custom VJP of the JAX ``_flash_core``: the forward kernel saves
    (its f32 output, lse); the backward computes delta = rowsum(do * out)
    from the f32 output (plain torch, outside the kernels as in the JAX
    package; why f32: the module docstring) and runs the dq and dk/dv
    kernels, and the d(bias) kernel when the bias needs a gradient
    (returned in the bias's dtype).  The kernels read the bias in f32."""

    @staticmethod
    def forward(ctx, qh, kh, vh, bias, causal, heads, q_seg, kv_seg,
                blocks=(None, None)):
        b32 = None if bias is None else bias.float().contiguous()
        out, lse, out32 = _fwd_op(qh, kh, vh, b32, q_seg, kv_seg, causal,
                                  heads, True, *blocks)
        if out32.numel() == 0:
            out32 = out
        ctx.save_for_backward(qh, kh, vh, b32, out32, lse, q_seg, kv_seg)
        ctx.causal, ctx.heads, ctx.blocks = causal, heads, blocks
        ctx.bias_dtype = None if bias is None else bias.dtype
        return out

    @staticmethod
    def backward(ctx, do):
        qh, kh, vh, b32, out32, lse, q_seg, kv_seg = ctx.saved_tensors
        delta = (do.float() * out32.float()).sum(-1)
        want_dbias = b32 is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = _bwd_op(qh, kh, vh, do.contiguous(), lse, delta,
                                    b32, q_seg, kv_seg, ctx.causal,
                                    ctx.heads, want_dbias, *ctx.blocks)
        dbias = dbias.to(ctx.bias_dtype) if want_dbias else None
        return dq, dk, dv, dbias, None, None, None, None, None


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
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention with the model ``AttnFn`` signature (GQA-aware,
    differentiable through the backward kernels).

    ``bias`` is additive on the scaled logits in ``default_attention``'s
    convention, ``[H or 1, S or 1, T or 1]``, and runs in the kernels
    (forward, the dq and dk/dv recompute, and the d(bias) kernel).  A row-
    or column-broadcast bias is expanded to a full contiguous [Hb, S, T]
    plane before the kernels (autograd sums its gradient back), which
    costs that plane in device memory; T5 passes the full plane.

    ``block_q`` / ``block_k`` pick the forward's and dq's launch shape on
    CUDA operands: a built shape (:func:`built_blocks`), or ``None`` /
    1024 for the default rule; any other raises :class:`BlockConfigError`
    (module docstring).  On CPU operands they are ignored."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(
            f"Query heads ({H}) must be a multiple of KV heads ({KV})."
        )
    if bias is not None:
        if (bias.dim() != 3 or bias.shape[0] not in (1, H)
                or bias.shape[1] not in (1, S) or bias.shape[2] not in (1, T)):
            raise ValueError(
                f"bias must be [H or 1, S or 1, T or 1] broadcastable to "
                f"[{H}, {S}, {T}], got {tuple(bias.shape)}.")
        if tuple(bias.shape[1:]) != (S, T):
            bias = bias.expand(bias.shape[0], S, T)
    q_seg = kv_seg = None
    if segment_ids is not None:
        q_seg, kv_seg = normalize_segment_ids(segment_ids, B, S, T)
    qh = q.transpose(1, 2).reshape(B * H, S, D).contiguous()
    kh = k.transpose(1, 2).reshape(B * KV, T, D).contiguous()
    vh = v.transpose(1, 2).reshape(B * KV, T, D).contiguous()
    out = _FlashCore.apply(qh, kh, vh, bias, causal, H, q_seg, kv_seg,
                           (block_q, block_k))
    return out.reshape(B, H, S, D).transpose(1, 2)


def make_flash_attention(*, block_q: Optional[int] = None,
                         block_k: Optional[int] = None):
    """An ``AttnFn`` for model constructors, at the launch shape
    ``block_q`` / ``block_k`` (:func:`flash_attention`)."""

    def attn_fn(q, k, v, *, causal=True, bias=None, segment_ids=None):
        return flash_attention(
            q, k, v, causal=causal, bias=bias, segment_ids=segment_ids,
            block_q=block_q, block_k=block_k,
        )

    return attn_fn
