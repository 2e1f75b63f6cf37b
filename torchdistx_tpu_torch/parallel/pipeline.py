"""Pipeline parallelism (counterpart of ``torchdistx_tpu/parallel/pipeline.py``).

Only the packed-sequence target mask that every cross-entropy path shares
is here so far; the GPipe and fused 1F1B / interleaved schedules wait for
ROADMAP A11.
"""

from __future__ import annotations

import torch


def valid_next_token_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """[B, S-1] f32 mask of valid next-token targets for packed ids:
    positions whose next token crosses a document boundary are excluded,
    and a NEGATIVE id marks the padded tail (also excluded)."""
    return ((segment_ids[:, :-1] == segment_ids[:, 1:])
            & (segment_ids[:, 1:] >= 0)).float()
