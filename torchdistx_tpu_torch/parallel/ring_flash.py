"""Ring attention through the hand-written flash kernels (counterpart of
``torchdistx_tpu/parallel/ring_flash.py``).

The dense ring (:mod:`.ring_attention`) forms each [s, t] block of
logits in plain PyTorch.  This one runs every ring step through the
flash kernels (``ops/flash_attention.py``): the ring splits the sequence
across ranks, the kernels tile it on the card.

Per rank (local q [B, s, H, D], k / v [B, t, KV, D], ``n`` ranks on the
``sp`` ring, this rank at ``idx``):

* forward: step ``i`` holds key block ``src = (idx - i) % n``.  Under
  causal masking a block is *past* (``src < idx``: the forward kernel
  without a mask), *diagonal* (``src == idx``: causal) or *future*
  (skipped: no launch; it would merge as zeros with lse -1e30).  The
  kernel's f32 output of each block (its output before the rounding to
  q's dtype) and lse merge pairwise (:func:`_merge`), so the result is
  the global softmax, rounded to q's dtype once at the end.  K and V
  rotate to the next rank between steps, n - 1 times.
* backward: a second ring.  The dq, dk/dv and d(bias) kernels recompute
  each block's probabilities from the GLOBAL lse, with the global
  ``delta = rowsum(do * o)`` taken from the merged f32 output (the
  port's rule for delta, ``ops/flash_attention.py``'s docstring).  dq
  accumulates here in f32; the f32 dk / dv accumulators rotate with
  their k / v blocks and arrive home after n steps; each step writes
  (does not add) the strip of d(bias) columns of its block.

A bias ``[Hb, s, T_total]`` is cut into one contiguous ``[Hb, s, t]``
strip per step (the kernels take a contiguous plane).  Segment ids come
as ``(q_seg [B, s], kv_seg [B, T_total])`` and are column-sliced the
same way.

On CPU tensors the kernels' plain versions run, as everywhere in the
port; on CUDA tensors each launched block adds one to its kernel's
count in ``ops.flash_attention.launches``: under causal masking rank r
launches the forward (and dq, dk/dv) r + 1 times per call, otherwise n
times.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention import _bwd_op, _fwd_op
from ._attn_wrap import wrap_seq_parallel_attn
from .collectives import _shift, axis_group, axis_index, axis_size

_NEG = -1e30


def _merge(o, lse, o_i, lse_i):
    """Pairwise softmax merge of two normalized block outputs: ``o`` /
    ``o_i`` [BH, s, D] f32, ``lse`` / ``lse_i`` [BH, s]; two blocks where
    a row sees no key (lse -1e30, output 0) merge to the same."""
    m = torch.maximum(lse, lse_i)
    w = torch.exp(lse - m)
    w_i = torch.exp(lse_i - m)
    denom = w + w_i
    o = (o * w[..., None] + o_i * w_i[..., None]) / denom[..., None]
    return o, m + torch.log(denom)


class Ring:
    """This rank's place on the ``axis`` ring of ``mesh``."""

    def __init__(self, mesh, axis: str):
        self.n = axis_size(mesh, axis)
        self.idx = axis_index(mesh, axis)
        self.group = axis_group(mesh, axis) if self.n > 1 else None

    def rotate(self, *tensors):
        """Each tensor one step forward along the ring (i -> i + 1)."""
        if self.n == 1:
            return tensors
        return tuple(_shift(tensors, self.group, self.n, self.idx, 1, True))

    def kind(self, src: int, causal: bool) -> Optional[bool]:
        """The flash mask of key block ``src`` for this rank's queries:
        causal on the diagonal, none in the past, None (skip) in the
        future."""
        if not causal or src < self.idx:
            return False
        return True if src == self.idx else None


def _strip(x, src: int, t: int):
    return None if x is None else x[..., src * t:(src + 1) * t].contiguous()


def _flash_block(qh, k_cur, v_cur, causal, bias, heads, q_seg, kv_seg, src):
    """One forward block through the kernels' custom op (so a FLOP
    counter sees it): its output before the rounding to q's dtype, and
    lse."""
    t = k_cur.shape[1]
    out, lse, out32 = _fwd_op(qh, k_cur, v_cur, _strip(bias, src, t), q_seg,
                              _strip(kv_seg, src, t), causal, heads, True)
    return (out if out32.numel() == 0 else out32), lse


def ring_flash_forward(qh, kh, vh, ring: Ring, causal: bool, *, bias=None,
                       heads=None, q_seg=None, kv_seg=None):
    """The forward ring at the raw layout (q [BH, s, D], k / v [BKV, t,
    D]): ``(o, lse)``, the merged output and the global lse [BH, s], both
    f32."""
    BH, s, D = qh.shape
    o = torch.zeros(BH, s, D, dtype=torch.float32, device=qh.device)
    lse = torch.full((BH, s), _NEG, dtype=torch.float32, device=qh.device)
    k_cur, v_cur = kh, vh
    for i in range(ring.n):
        src = (ring.idx - i) % ring.n
        blk_causal = ring.kind(src, causal)
        if blk_causal is not None:
            o_i, lse_i = _flash_block(qh, k_cur, v_cur, blk_causal, bias,
                                      heads, q_seg, kv_seg, src)
            o, lse = _merge(o, lse, o_i.float(), lse_i)
        if i < ring.n - 1:
            k_cur, v_cur = ring.rotate(k_cur, v_cur)
    return o, lse


def ring_flash_backward(qh, kh, vh, do, lse, delta, ring: Ring, causal: bool,
                        *, bias=None, heads=None, q_seg=None, kv_seg=None,
                        want_dbias: bool = False):
    """The backward ring from the global ``lse`` and ``delta`` ([BH, s]
    f32): ``(dq, dk, dv)`` in f32 and, with ``want_dbias``, d(bias) f32
    [Hb, s, T_total]."""
    t = kh.shape[1]
    # A row that sees no key at all has lse -1e30; a large positive lse
    # keeps p = exp(s - lse) at 0 there.
    lse = torch.where(lse <= _NEG / 2, -_NEG, lse)
    dq = torch.zeros(qh.shape, dtype=torch.float32, device=qh.device)
    dk = torch.zeros(kh.shape, dtype=torch.float32, device=qh.device)
    dv = torch.zeros_like(dk)
    dbias = None
    if want_dbias:
        dbias = torch.zeros(bias.shape, dtype=torch.float32, device=qh.device)
    k_cur, v_cur = kh, vh
    for i in range(ring.n):
        src = (ring.idx - i) % ring.n
        blk_causal = ring.kind(src, causal)
        if blk_causal is not None:
            grads = _bwd_op(qh, k_cur, v_cur, do, lse, delta,
                            _strip(bias, src, t), q_seg,
                            _strip(kv_seg, src, t), blk_causal, heads,
                            want_dbias)
            dq += grads[0]
            dk += grads[1]
            dv += grads[2]
            if want_dbias:
                dbias[..., src * t:(src + 1) * t] = grads[3]
        # dk / dv travel with their block: after n steps each is home.
        if i < ring.n - 1:
            k_cur, v_cur, dk, dv = ring.rotate(k_cur, v_cur, dk, dv)
        else:
            dk, dv = ring.rotate(dk, dv)
    return dq, dk, dv, dbias


class _RingFlash(torch.autograd.Function):
    """One differentiable ring: the forward saves the merged f32 output
    and the global lse; the backward takes delta from that output and
    runs the second ring."""

    @staticmethod
    def forward(ctx, qh, kh, vh, bias, q_seg, kv_seg, ring, heads, causal):
        b32 = None if bias is None else bias.float().contiguous()
        o, lse = ring_flash_forward(qh, kh, vh, ring, causal, bias=b32,
                                    heads=heads, q_seg=q_seg, kv_seg=kv_seg)
        ctx.save_for_backward(qh, kh, vh, b32, o, lse, q_seg, kv_seg)
        ctx.ring, ctx.heads, ctx.causal = ring, heads, causal
        ctx.bias_dtype = None if bias is None else bias.dtype
        return o.to(qh.dtype)

    @staticmethod
    def backward(ctx, do):
        qh, kh, vh, b32, o, lse, q_seg, kv_seg = ctx.saved_tensors
        delta = (do.float() * o).sum(-1)
        want_dbias = b32 is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = ring_flash_backward(
            qh, kh, vh, do.contiguous(), lse, delta, ctx.ring, ctx.causal,
            bias=b32, heads=ctx.heads, q_seg=q_seg, kv_seg=kv_seg,
            want_dbias=want_dbias)
        dbias = dbias.to(ctx.bias_dtype) if want_dbias else None
        return (dq.to(qh.dtype), dk.to(kh.dtype), dv.to(vh.dtype), dbias,
                None, None, None, None, None)


def ring_flash_attention(
    q: torch.Tensor,  # [B, s, H, D] this rank's chunk
    k: torch.Tensor,  # [B, t, KV, D]
    v: torch.Tensor,  # [B, t, KV, D]
    *,
    mesh,
    axis_name: str = "sp",
    causal: bool = True,
    bias: Optional[torch.Tensor] = None,  # [H or 1, s, T_total] row-sharded
    segment_ids=None,  # (q_seg [B, s], kv_seg [B, T_total])
) -> torch.Tensor:
    """Flash-kernel ring attention over ``axis_name`` of ``mesh``: this
    rank's chunk of the output, [B, s, H, D].

    Causal masking requires equal local query and key chunks
    (self-attention); causal cross-attention goes to the dense ring
    (:func:`.ring_attention.ring_attention`), which handles the
    bottom-right offset.  ``bias`` is this rank's query rows against every
    key column; ``segment_ids`` the local query ids and every key's."""
    B, s, H, D = q.shape
    t, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(
            f"Query heads ({H}) must be a multiple of KV heads ({KV}).")
    if causal and s != t:
        raise NotImplementedError(
            "causal ring_flash_attention requires equal q/k chunk lengths; "
            "use the dense ring for causal cross-attention.")
    ring = Ring(mesh, axis_name)
    n = ring.n
    if bias is not None and (bias.dim() != 3 or bias.shape[0] not in (1, H)
                             or tuple(bias.shape[1:]) != (s, n * t)):
        raise ValueError(
            f"ring bias must be row-sharded [H or 1, s, T_total] = "
            f"[{H} or 1, {s}, {n * t}], got {tuple(bias.shape)}.")
    q_seg = kv_seg = None
    if segment_ids is not None:
        q_seg, kv_seg = segment_ids
        if tuple(q_seg.shape) != (B, s) or tuple(kv_seg.shape) != (B, n * t):
            raise ValueError(
                f"ring segment_ids must be (q_seg [B, s]=[{B}, {s}] local, "
                f"kv_seg [B, T_total]=[{B}, {n * t}] resident), got "
                f"{tuple(q_seg.shape)} / {tuple(kv_seg.shape)}.")
        if q.is_cuda:
            q_seg, kv_seg = (x.to(torch.int32).contiguous()
                             for x in (q_seg, kv_seg))
    qh = q.transpose(1, 2).reshape(B * H, s, D).contiguous()
    kh = k.transpose(1, 2).reshape(B * KV, t, D).contiguous()
    vh = v.transpose(1, 2).reshape(B * KV, t, D).contiguous()
    out = _RingFlash.apply(qh, kh, vh, bias, q_seg, kv_seg, ring, H, causal)
    return out.reshape(B, H, s, D).transpose(1, 2)


def make_ring_flash_attention(mesh, *, seq_axis: str = "sp"):
    """An ``AttnFn`` running flash-kernel ring attention over ``mesh``'s
    ``seq_axis`` with the local-chunk contract of :mod:`._attn_wrap`; the
    model's default attention where the mesh has no such axis.

    Causal cross-attention goes to the dense ring, so a model passes one
    ``attn_fn`` and every call pattern works.  The kernels choose their
    own tiles (the JAX ``block_q`` / ``block_k`` have no counterpart)."""
    from .ring_attention import ring_attention

    if seq_axis not in (mesh.mesh_dim_names or ()):
        from ..models.layers import default_attention

        return default_attention

    def per_device(q, k, v, causal, bias, segs):
        if causal and q.shape[1] != k.shape[1]:
            return ring_attention(q, k, v, mesh=mesh, axis_name=seq_axis,
                                  causal=causal, bias=bias, segment_ids=segs)
        return ring_flash_attention(q, k, v, mesh=mesh, axis_name=seq_axis,
                                    causal=causal, bias=bias,
                                    segment_ids=segs)

    return wrap_seq_parallel_attn(mesh, name="ring flash attention",
                                  per_device=per_device, seq_axis=seq_axis)
