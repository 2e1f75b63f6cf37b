"""How materialized bytes move and are re-typed after their replay (the
port's own copy of ``torchdistx_tpu/jax_bridge/transport.py``'s
contract).

* :func:`resolve_init_dtype` / :func:`plan_transport` — the
  ``TDX_MATERIALIZE_INIT_DTYPE`` contract: a slot the parameter cast mask
  permits, whose contract dtype is floating and wider than the init
  dtype, is stored in the init dtype and delivered in its contract dtype.
  Where the contract dtype already is the init dtype (a bf16 recording,
  or ``param_dtype=bf16``) nothing changes, bit for bit; an f32 contract
  under a bf16 init dtype delivers the bf16-rounded values.  The resume
  payload (:mod:`.materialize`) is stored in the init dtype, so it takes
  the narrower bytes on disk.
* :func:`batched_load` — a resumed group's payloads come back through ONE
  pinned host staging buffer and ONE host→device copy, then are cut into
  their values on the device.
* :class:`OverlapTracker` — the ``overlap`` of the ``materialize`` span:
  commit time hidden behind the next group's replay, over the wall.

Donation has no counterpart: the JAX commit program donates its inputs so
XLA can reuse their buffers, while the port's replay frees each value
after its last consumer (``materialize._replay_full``), so no staging buffer
outlives its group.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

__all__ = [
    "OverlapTracker",
    "batched_load",
    "plan_transport",
    "resolve_init_dtype",
]

_INIT_DTYPE_ALIASES = {
    "bf16": "bfloat16",
    "f16": "float16",
    "fp16": "float16",
    "f32": "float32",
    "fp32": "float32",
}


def resolve_init_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """The torch dtype named by ``TDX_MATERIALIZE_INIT_DTYPE`` (aliases
    ``bf16``/``f16``/``fp16`` accepted), or None when unset.  A name that
    is not a floating dtype is a configuration error."""
    if not name:
        return None
    dt = getattr(torch, _INIT_DTYPE_ALIASES.get(name.lower(), name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"TDX_MATERIALIZE_INIT_DTYPE={name!r} is not a "
                         f"dtype name (expected e.g. 'bf16')")
    if not dt.is_floating_point:
        raise ValueError(f"TDX_MATERIALIZE_INIT_DTYPE={name!r}: the init "
                         f"fast path only applies to floating dtypes")
    return dt


def plan_transport(final_dtypes: Sequence[torch.dtype], cast_mask,
                   init_dtype: Optional[torch.dtype]
                   ) -> List[Optional[torch.dtype]]:
    """Per slot, the dtype it is stored in on its way to its contract
    dtype ``final_dtypes[i]`` (what the default path delivers), or None
    to keep the contract dtype: the init dtype only where the mask
    permits it (parameters, never buffers), the contract dtype is
    floating and the init dtype is narrower."""
    return [
        init_dtype if (init_dtype is not None and m and d.is_floating_point
                       and d.itemsize > init_dtype.itemsize) else None
        for d, m in zip(final_dtypes, cast_mask)
    ]


def batched_load(payloads: Sequence[Tuple[bytes, Sequence[int], torch.dtype]],
                 device: torch.device) -> List[torch.Tensor]:
    """``(raw bytes, shape, dtype)`` payloads as tensors on ``device``,
    each in its own compact storage: one staging buffer (pinned where
    ``device`` is a GPU) and one host→device copy for the lot."""
    offsets, total = [], 0
    for data, _, _ in payloads:
        offsets.append(total)
        total += -(-len(data) // 16) * 16  # each payload 16-byte aligned
    pin = device.type == "cuda"
    staging = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
    view = staging.numpy()
    for (data, _, _), off in zip(payloads, offsets):
        view[off:off + len(data)] = memoryview(data)
    flat = staging.to(device, non_blocking=True) if pin else staging
    return [flat[off:off + len(data)].view(dtype).reshape(tuple(shape)).clone()
            for (data, shape, dtype), off in zip(payloads, offsets)]


class OverlapTracker:
    """Per committed group: the dispatch→written duration and how long the
    engine actually waited for it; the difference is commit time hidden
    behind other groups' replay.  :meth:`overlap` is that hidden time
    over the wall (per-group durations sum, so over 1 means several
    commits overlapped); a run with nothing to commit reports 0."""

    __slots__ = ("hidden_s",)

    def __init__(self):
        self.hidden_s = 0.0

    def note(self, dur_s: float, wait_s: float) -> float:
        hidden = max(0.0, dur_s - wait_s)
        self.hidden_s += hidden
        return hidden

    def overlap(self, wall_s: float) -> float:
        if wall_s <= 0:
            return 0.0
        return round(self.hidden_s / wall_s, 3)
