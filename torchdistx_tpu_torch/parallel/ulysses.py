"""Ulysses attention: all-to-all sequence parallelism over the ``sp``
axis (counterpart of ``torchdistx_tpu/parallel/ulysses.py``).

DeepSpeed-Ulysses: activations arrive sequence-split [B, s, H, D]; one
all-to-all re-splits them by heads to [B, S, H/n, D], each rank runs
full-sequence attention over its heads with any local ``AttnFn`` (the
flash kernels' ``make_flash_attention()`` on the card), and a second
all-to-all restores the sequence split.

Against the ring (why both exist): Ulysses runs unmodified attention
locally, at the cost of four all-to-alls (~4·B·S·H·D/n per rank per
call); the ring rotates K/V (~2·B·S·KV·D per rank), so the ring moves
less only when H/KV exceeds n/2.  Ulysses's width is capped by the head
count (n must divide H); the ring's only by the sequence.

The local-chunk contract of :mod:`._attn_wrap` holds here too: a bias
arrives row-sharded [H or 1, s, T] and is re-split by heads (one
all-to-all; a one-plane bias is gathered), segment ids arrive as this
rank's query ids and are gathered to the full sequence the inner
attention sees.
"""

from __future__ import annotations

import math
import warnings

import torch

from ._attn_wrap import wrap_seq_parallel_attn
from .collectives import all_gather, all_to_all, axis_index, axis_size


def ulysses_attention(
    q: torch.Tensor,  # [B, s, H, D] this rank's chunk
    k: torch.Tensor,  # [B, t, KV, D]
    v: torch.Tensor,  # [B, t, KV, D]
    *,
    mesh,
    axis_name: str = "sp",
    causal: bool = True,
    bias=None,  # [H or 1, s, T_total] row-sharded
    segment_ids=None,  # (q_seg [B, s], kv_seg [B, T_total])
    inner_attn=None,
) -> torch.Tensor:
    """Sequence-split -> head-split -> full local attention -> back: this
    rank's chunk of the output.  ``inner_attn`` is any ``AttnFn``
    (default: ``default_attention``)."""
    if inner_attn is None:
        from ..models.layers import default_attention

        inner_attn = default_attention
    n = axis_size(mesh, axis_name)
    H, KV = q.shape[2], k.shape[2]

    # Head counts must split across the axis.  KV heads that do not are
    # regrouped, not broadcast to the H query heads:
    #
    # * ``KV % n == 0``: kv heads split across ranks like q heads;
    # * ``n % KV == 0`` (MQA included): each kv head repeated to its
    #   group's ``n/KV`` rank slots, so every rank receives exactly the
    #   one kv head its contiguous query heads read;
    # * ragged (neither divides): gcd grouping, ``g = gcd(n, KV)``, each
    #   kv head filling ``n/g`` consecutive slots (``KV·n/g`` in all,
    #   ``kv' = KV/g`` received per rank).  H is a common multiple of n
    #   and KV, so the slot map ``slot -> head slot·g//n`` tiles the
    #   query map ``query h -> head h·KV//H``: every rank receives all
    #   the kv heads its queries read, expanded locally afterwards.
    ragged = False
    if KV % n:
        if n % KV == 0:
            reps = n // KV
        else:
            g = math.gcd(n, KV)
            ragged = True
            reps = n // g
            if H == n * (KV // g):
                # H == lcm(n, KV): every slot is read by one query head,
                # so no grouping moves less than the broadcast.
                warnings.warn(
                    f"ulysses: KV heads ({KV}) and sequence axis size "
                    f"({n}) divide neither way and H == lcm == {H}: K/V "
                    f"all-to-all volume equals the per-query broadcast. "
                    f"Consider ring attention "
                    f"(parallel/ring_attention.py).")
        k = k.repeat_interleave(reps, dim=2)
        v = v.repeat_interleave(reps, dim=2)

    # [B, s, H, D] -> [B, S, H/n, D]: split heads, gather the sequence.
    def gather(x):
        return all_to_all(x, mesh, axis_name, split_dim=2, concat_dim=1)

    qg, kg, vg = gather(q), gather(k), gather(v)
    if ragged:
        # Query j on rank d reads kv head c = (d·H/n + j)·KV//H, held by
        # received slot c·n' - d·kv'.
        g = math.gcd(n, KV)
        kv_p, n_p = KV // g, n // g
        d = axis_index(mesh, axis_name)
        j = torch.arange(H // n, device=q.device)
        c = ((d * (H // n) + j) * KV) // H
        slot = (c * n_p - d * kv_p).clamp(0, kv_p - 1)
        kg = kg.index_select(2, slot)
        vg = vg.index_select(2, slot)
    kwargs = {}
    if bias is not None:
        # [Hb, s, T] rows -> [Hb/n, S, T]: this rank's heads, every row.
        kwargs["bias"] = (all_gather(bias, mesh, axis_name, dim=1)
                          if bias.shape[0] == 1 else
                          all_to_all(bias, mesh, axis_name, split_dim=0,
                                     concat_dim=1))
    if segment_ids is not None:
        q_seg, kv_seg = segment_ids
        kwargs["segment_ids"] = (all_gather(q_seg, mesh, axis_name, dim=1),
                                 kv_seg)
    out = inner_attn(qg, kg, vg, causal=causal, **kwargs)
    # [B, S, H/n, D] -> [B, s, H, D]: split the sequence, gather heads.
    return all_to_all(out, mesh, axis_name, split_dim=1, concat_dim=2)


def make_ulysses_attention(mesh, *, seq_axis: str = "sp", inner_attn=None):
    """An ``AttnFn`` running Ulysses attention over ``mesh``'s
    ``seq_axis`` with the local-chunk contract of :mod:`._attn_wrap`;
    ``inner_attn`` (or ``default_attention``) where the mesh has no such
    axis."""
    if seq_axis not in (mesh.mesh_dim_names or ()):
        from ..models.layers import default_attention

        return inner_attn or default_attention
    n = axis_size(mesh, seq_axis)

    def validate(q, k, v):
        if q.shape[2] % n:
            raise ValueError(
                f"Ulysses needs the sp axis ({n}) to divide query heads "
                f"({q.shape[2]}).")

    return wrap_seq_parallel_attn(
        mesh, name="ulysses attention", seq_axis=seq_axis, validate=validate,
        per_device=lambda q, k, v, causal, bias, segs: ulysses_attention(
            q, k, v, mesh=mesh, axis_name=seq_axis, causal=causal,
            bias=bias, segment_ids=segs, inner_attn=inner_attn))
