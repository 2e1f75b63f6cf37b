"""The model-facing ``AttnFn`` shared by the sequence-parallel attention
strategies (counterpart of ``torchdistx_tpu/parallel/_attn_wrap.py``).

The JAX ``AttnFn``s are global-in, global-out: ``shard_map`` splits the
arrays inside them.  Eager PyTorch has no GSPMD, so the port's contract
is the ``per_device`` one of that ``shard_map``, as torch's own context
parallelism has it: each rank passes ITS chunks and gets back its chunk
of the output.

* ``q`` [B_local, s, H_local, D], ``k`` / ``v`` [B_local, t, KV_local,
  D]: this rank's chunks, the sequence split over the ``sp`` axis in
  rank order (rank r holds positions ``r*s .. r*s+s-1``), the batch
  over the data axes and the heads over ``tp`` as the model's
  projections give them;
* ``bias``: row-sharded ``[H or 1, s, T_total]``, this rank's query rows
  against every key column (the JAX ``bias_spec=P(h, sp, None)``);
* ``segment_ids``: a single [B, s] tensor (self-attention: this rank's
  ids, the key ids gathered over ``sp`` here) or a ``(q_seg [B, s],
  kv_seg)`` pair whose ``kv_seg`` is this rank's [B, t] chunk (gathered
  here) or already every key's [B, T_total] ids.

The strategy's ``per_device(q, k, v, causal, bias, segs)`` receives the
segment ids as a ``(q_seg [B, s], kv_seg [B, T_total])`` pair.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .collectives import all_gather, axis_size


def resident_segments(segment_ids, q: torch.Tensor, k: torch.Tensor, mesh,
                      axis: str):
    """``segment_ids`` as ``(q_seg [B, s], kv_seg [B, T_total])``: the key
    ids gathered over ``axis`` when only this rank's [B, t] are given."""
    B, s, t = q.shape[0], q.shape[1], k.shape[1]
    n = axis_size(mesh, axis)
    if isinstance(segment_ids, (tuple, list)):
        q_seg, kv_seg = segment_ids
    else:
        q_seg = kv_seg = segment_ids
    if tuple(q_seg.shape) != (B, s) or kv_seg.dim() != 2 \
            or kv_seg.shape[0] != B or kv_seg.shape[1] not in (t, n * t):
        raise ValueError(
            f"sequence-parallel segment_ids must be this rank's [B, s]=[{B}, "
            f"{s}] (self-attention) or a ([B, s], [B, t or T_total]=[{B}, "
            f"{t} or {n * t}]) pair, got {tuple(q_seg.shape)} / "
            f"{tuple(kv_seg.shape)}.")
    if kv_seg.shape[1] != n * t:
        kv_seg = all_gather(kv_seg, mesh, axis, dim=1)
    return q_seg, kv_seg


def wrap_seq_parallel_attn(
    mesh,
    *,
    name: str,
    per_device: Callable,  # (q, k, v, causal, bias, segs) -> this rank's out
    seq_axis: str = "sp",
    validate: Optional[Callable] = None,  # (q, k, v) -> None, raises on misuse
):
    """Build a model-facing ``AttnFn`` around ``per_device`` (the module
    docstring has the contract): validates the operands, brings the
    segment ids to the ``(q_seg, kv_seg)`` pair and hands both on."""

    def attn_fn(q, k, v, *, causal=True, bias=None, segment_ids=None):
        if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape) \
                or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
            raise ValueError(
                f"{name}: q must be [B, s, H, D] and k, v [B, t, KV, D], got "
                f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
        if validate is not None:
            validate(q, k, v)
        segs = None
        if segment_ids is not None:
            segs = resident_segments(segment_ids, q, k, mesh, seq_axis)
        return per_device(q, k, v, causal, bias, segs)

    attn_fn.seq_parallel = (mesh, seq_axis)
    return attn_fn
