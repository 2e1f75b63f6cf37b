"""Ring attention in plain PyTorch: exact sequence-parallel attention
over the ``sp`` axis (counterpart of
``torchdistx_tpu/parallel/ring_attention.py``).

The sequence is split across the ranks of the ring; K/V blocks rotate
one rank forward per step while each rank accumulates its queries'
attention with an online softmax — O(S/n) memory per rank, exact
results.  Each [s, t] block of logits is formed densely in f32 (no
kernel: the flash-kernel ring is :mod:`.ring_flash`); autograd
differentiates through the loop, the rotation's backward sending the
gradients the other way.  This ring handles what the flash one does
not: causal cross-attention, with the bottom-right offset.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ._attn_wrap import wrap_seq_parallel_attn
from .collectives import axis_index, axis_size, ppermute_next

_NEG = -1e30


def ring_attention(
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
    """Exact attention over the ring: this rank's chunk of the output.

    ``bias`` is this rank's query rows against every key column; each
    step slices its key block's columns out of it.  ``segment_ids``
    likewise: the query ids local, the key ids resident and
    column-sliced.  Causal masking aligns the last query with the last
    key (``tril(k=T-S)`` of the whole sequences)."""
    n = axis_size(mesh, axis_name)
    idx = axis_index(mesh, axis_name)
    B, s, H, D = q.shape
    t, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device

    qf = (q.float() * (1.0 / math.sqrt(D))).reshape(B, s, KV, G, D)
    q_pos = idx * s + torch.arange(s, device=dev)
    o = torch.zeros(B, KV, G, s, D, device=dev)
    m = torch.full((B, KV, G, s), _NEG, device=dev)
    l = torch.zeros(B, KV, G, s, device=dev)
    k_cur, v_cur = k, v
    for i in range(n):
        src = (idx - i) % n
        logits = torch.einsum("bskgd,btkd->bkgst", qf, k_cur.float())
        cols = slice(src * t, (src + 1) * t)
        if bias is not None:
            blk = bias[:, :, cols].float()
            logits = logits + (blk[None, :, None] if blk.shape[0] == 1
                               else blk.reshape(1, KV, G, s, t))
        mask = torch.ones(B, s, t, dtype=torch.bool, device=dev)
        if causal:
            k_pos = src * t + torch.arange(t, device=dev)
            mask = mask & (q_pos[:, None] + (t - s) * n >= k_pos[None, :])
        if segment_ids is not None:
            q_seg, kv_seg = segment_ids
            mask = mask & (q_seg[:, :, None] == kv_seg[:, None, cols])
        mask = mask[:, None, None]
        logits = torch.where(mask, logits, _NEG)
        new_m = torch.maximum(m, logits.amax(-1))
        corr = torch.exp(m - new_m)
        p = torch.exp(logits - new_m[..., None]) * mask
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", p,
                                               v_cur.float())
        m = new_m
        if i < n - 1:
            k_cur, v_cur = ppermute_next((k_cur, v_cur), mesh, axis_name)
    out = o / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, s, H, D).to(q.dtype)


def make_ring_attention(mesh, *, seq_axis: str = "sp"):
    """An ``AttnFn`` running the dense ring over ``mesh``'s ``seq_axis``
    with the local-chunk contract of :mod:`._attn_wrap`; the model's
    default attention where the mesh has no such axis."""
    if seq_axis not in (mesh.mesh_dim_names or ()):
        from ..models.layers import default_attention

        return default_attention
    return wrap_seq_parallel_attn(
        mesh, name="ring attention", seq_axis=seq_axis,
        per_device=lambda q, k, v, causal, bias, segs: ring_attention(
            q, k, v, mesh=mesh, axis_name=seq_axis, causal=causal,
            bias=bias, segment_ids=segs))
