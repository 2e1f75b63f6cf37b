"""Packed-sequence segment-id convention shared by the attention functions
(counterpart of ``torchdistx_tpu/ops/segments.py``; shape plumbing only)."""

from __future__ import annotations


def normalize_segment_ids(segment_ids, B, S, T):
    """Normalize the ``segment_ids`` argument of the attention functions
    to an ``(q_seg [B, S], kv_seg [B, T])`` pair.

    A single [B, S] tensor serves self-attention (q and k share
    positions); cross-attention passes an explicit ``(q_seg, kv_seg)``
    tuple."""
    if isinstance(segment_ids, (tuple, list)):
        q_seg, kv_seg = segment_ids
    else:
        q_seg = kv_seg = segment_ids
    if tuple(q_seg.shape) != (B, S) or tuple(kv_seg.shape) != (B, T):
        raise ValueError(
            f"segment_ids must be [B, S]=[{B}, {S}] (self-attention) or a "
            f"([B, S], [B, T]=[{B}, {T}]) pair, got "
            f"{tuple(q_seg.shape)} / {tuple(kv_seg.shape)}."
        )
    return q_seg, kv_seg
