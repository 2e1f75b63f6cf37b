"""How a model maps onto the pipeline runner and the serving runtime
(counterpart of ``torchdistx_tpu/models/decomposition.py``).

Both cut the model into embed, the per-layer blocks, the positional side
input and the head.  The pipeline runner (:mod:`..parallel.pipeline`)
runs the embed on the first stage, each stage's own blocks, and the head
on the last: :class:`PipelineDecomposition`.  Decode feeds ONE token per
batch lane at that lane's own absolute offset, so the serving programs
need position-explicit pieces: :class:`DecodeDecomposition`.  Each
family exports its own; the runners consume them blindly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "DecodeDecomposition",
    "PipelineDecomposition",
    "apply_final_norm",
    "chunk_positions",
    "decoder_head_logits",
    "positional_token_embed",
    "token_embed",
]


def chunk_positions(seq_shard, length: int, device=None) -> torch.Tensor:
    """[length] absolute positions of a sequence chunk: ``seq_shard =
    (index, count)`` says the input is chunk ``index`` of ``count`` equal
    chunks of the sequence (a sequence-parallel rank's), so it starts at
    ``index * length``."""
    index, count = seq_shard
    if not 0 <= index < count:
        raise ValueError(f"seq_shard {tuple(seq_shard)}: index outside "
                         f"[0, count)")
    return torch.arange(index * length, (index + 1) * length, device=device)


def token_embed(cfg, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Look ``tokens`` up in an embedding ``table``, in the compute dtype."""
    return F.embedding(tokens, table).to(cfg.dtype)


def positional_token_embed(cfg, wte: torch.Tensor, wpe: torch.Tensor,
                           tokens: torch.Tensor,
                           positions: torch.Tensor) -> torch.Tensor:
    """Learned-position embed at EXPLICIT positions (GPT-2 decode: one
    new token per lane sits at that lane's own absolute offset)."""
    return token_embed(cfg, wte, tokens) + token_embed(cfg, wpe, positions)


def apply_final_norm(final_norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return final_norm(x)


def decoder_head_logits(cfg, x: torch.Tensor, embed: nn.Module,
                        lm_head: Optional[nn.Module] = None) -> torch.Tensor:
    """Tied (``x @ E^T``, through the ``Embed`` module's ``attend``) or
    untied dense head, f32 logits.  Both go through the modules, so a
    tensor-parallel or FSDP2 layout of the table or the head runs its
    hooks (a pipeline stage calls the head outside the model's forward).

    The asymmetry is the JAX package's: the tied head casts ``x`` to
    ``param_dtype`` and multiplies in it, the untied head runs in the
    compute dtype (the model's full forward instead attends the tied
    embedding in the compute dtype, as flax's ``Embed.attend`` does)."""
    if cfg.tie_embeddings or lm_head is None:
        logits = embed.attend(x, dtype=cfg.param_dtype)
    else:
        logits = lm_head(x)
    return logits.float()


@dataclass(frozen=True)
class DecodeDecomposition:
    """A decoder LM cut into the pieces the serving programs run."""

    # tokens [B, S], positions [B, S] -> [B, S, d_model]
    embed: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    # the per-layer blocks, in order
    blocks: nn.ModuleList
    # positions [B, S] -> rope angles [B, S, head_dim/2], or None for
    # families with learned positions (applied in embed)
    angles_at: Callable[[torch.Tensor], Optional[torch.Tensor]]
    # activations [B, S, d_model] -> f32 logits [B, S, vocab]
    head: Callable[[torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class PipelineDecomposition:
    """A model cut into the pieces the pipeline runner runs.

    The JAX package's ``block_params`` (a scan-stacked parameter tree the
    plan shards over ``pp``) is ``blocks`` here, the model's own
    ``nn.ModuleList``: a stage runs the blocks it owns
    (:func:`..parallel.sharding.stage_layers`), in order."""

    # (inputs (tokens [B, S] or images [B, H, W, C]), seq_shard) ->
    # [B, S, d_model]; ``seq_shard = (index, count)`` says the tokens are
    # chunk ``index`` of ``count`` equal chunks of the sequence (a
    # sequence-parallel rank's), None the whole sequence.  Through the
    # modules, so a tensor-parallel or FSDP2 table runs its hooks.
    embed: Callable[..., torch.Tensor]
    # the per-layer blocks, in order
    blocks: nn.ModuleList
    # (sequence length, seq_shard) -> rope angles [S, head_dim/2] at the
    # chunk's absolute positions, threaded to every block, or None for
    # families with learned positions
    angles: Callable[..., Optional[torch.Tensor]]
    # activations [B, S, d_model] -> f32 logits ([B, S, vocab] or
    # [B, n_classes])
    head: Callable[[torch.Tensor], torch.Tensor]
    # block attention masking (False for encoders, e.g. ViT)
    causal: bool = True
    # the activations' length where the model fixes it (ViT's patches and
    # class token); None: the input's sequence length
    seq_len: Optional[int] = None
