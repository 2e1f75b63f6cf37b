"""The training step: loss, optimizer wiring and the update (counterpart
of ``torchdistx_tpu/parallel/train.py``), on one device.

PyTorch runs eagerly, so the step is a plain function: forward, the
loss, ``backward`` (through the flash kernels' backward when the model's
``attn_fn`` is ``make_flash_attention()``), the global gradient norm, and
an AdamW update in place.  Sharding over a device mesh (FSDP2, ROADMAP
A5), the pipeline schedules (A11) and mixture-of-experts losses (A9) are
not ported yet and raise; so do the JAX package's telemetry wrapper
``_instrument_step`` and ``train_elastic`` (A5, A12), which have no
counterpart here yet.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..fake import is_fake
from ..models.configs import TransformerConfig
from ..models.layers import AttnFn, Linear
from .pipeline import valid_next_token_mask

# Dense peak FLOP/s of one NVIDIA H100 SXM by compute dtype (NVIDIA's data
# sheet, at the 700 W power limit; f32 on the CUDA cores, no TF32): the
# denominator of MFU.
H100_PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

OptimizerFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]


def default_optimizer(params: Iterable[nn.Parameter]) -> torch.optim.Optimizer:
    """``optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1)`` of the JAX
    package: decoupled weight decay on every parameter.  On the GPU the
    update is PyTorch's fused AdamW (one pass over parameters, gradients
    and both moments, as XLA fuses optax's update)."""
    params = list(params)
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                             weight_decay=0.1,
                             fused=all(p.is_cuda for p in params))


def lm_cross_entropy(logits: torch.Tensor, tokens: torch.Tensor,
                     segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token CE over [B, S, V] logits and [B, S] tokens (shifted),
    log-softmax in f32.

    With ``segment_ids`` (packed sequences), positions whose next token
    belongs to another document, or to the padded tail (a NEGATIVE id),
    are excluded from the mean."""
    V = logits.shape[-1]
    nll = F.cross_entropy(logits[:, :-1].float().reshape(-1, V),
                          tokens[:, 1:].long().reshape(-1),
                          reduction="none").view(tokens.shape[0], -1)
    if segment_ids is None:
        return nll.mean()
    valid = valid_next_token_mask(segment_ids)
    return (nll * valid).sum() / valid.sum().clamp_min(1.0)


def train_step_flops(model: nn.Module, cfg: TransformerConfig, batch: int,
                     seq: int) -> float:
    """Model FLOPs of one step on [batch, seq] tokens: 6 per weight of
    every matrix product per token (2 forward, 4 backward; a tied head
    counts its embedding), plus causal attention's 6·L·B·H·S²·D (QKᵀ and
    PV over half the square, forward and backward)."""
    n = sum(m.weight.numel() for m in model.modules() if isinstance(m, Linear))
    if cfg.tie_embeddings:
        n += cfg.vocab_size * cfg.d_model
    attn = 6.0 * cfg.n_layers * batch * cfg.n_heads * seq * seq * cfg.head_size
    return 6.0 * n * batch * seq + attn


def make_train_step(
    model: nn.Module,
    cfg: TransformerConfig,
    *,
    optimizer: Optional[OptimizerFactory] = None,
    attn_fn: Optional[AttnFn] = None,
    device="cuda",
    mesh=None,
    pipeline: bool = False,
):
    """Build ``(init_state, train_step, shard_batch)`` for a decoder LM.

    * ``init_state(model)`` takes the materialized module (the one passed
      here: ``materialize_module`` works in place) and returns the state
      ``{"model", "params", "opt", "step"}``; ``optimizer`` is a factory
      over the parameters (default: :func:`default_optimizer`);
    * ``train_step(state, tokens, segment_ids=None) -> (state, metrics)``
      updates the state in place; ``metrics`` holds ``loss``, ``ce``,
      ``aux`` (0: no MoE yet) and ``grad_norm`` (the global L2 norm of
      the gradients, unclipped, as ``optax.global_norm``) as 0-d device
      tensors, so the loop stays asynchronous until a value is read;
    * ``shard_batch(tokens)`` puts a [B, S] batch on the device.

    A model's attention is set by its constructor (``make_llama(cfg,
    attn_fn=...)``).  ``attn_fn`` here is the JAX signature's attention
    of the pipelined path, which is not ported yet, and raises."""
    if attn_fn is not None:
        raise NotImplementedError(
            "make_train_step(attn_fn=) feeds the pipeline schedules, not "
            "ported yet (ROADMAP A11); pass attn_fn to the model's "
            "constructor")
    if mesh is not None:
        raise NotImplementedError(
            "training over a device mesh is not ported yet: ROADMAP A5 "
            "(FSDP2 over the A2 mesh)")
    if pipeline:
        raise NotImplementedError(
            "pipeline schedules are not ported yet: ROADMAP A11")
    if cfg.moe is not None:
        raise NotImplementedError(
            "mixture-of-experts training is not ported yet: ROADMAP A9")
    dev = resolve_device(device)
    make_opt = optimizer or default_optimizer

    def init_state(module: nn.Module) -> dict:
        params = list(module.parameters())
        if any(is_fake(p) for p in params):
            raise ValueError(
                "init_state needs materialized parameters; call "
                "materialize_module first")
        off = {str(p.device) for p in params if p.device != dev}
        if off:
            raise ValueError(f"parameters on {sorted(off)}, not on {dev}")
        return {"model": module, "params": params, "opt": make_opt(params),
                "step": 0}

    def train_step(state: dict, tokens: torch.Tensor,
                   segment_ids: Optional[torch.Tensor] = None):
        module, opt = state["model"], state["opt"]
        opt.zero_grad(set_to_none=True)
        args = (tokens,) if segment_ids is None else (tokens, segment_ids)
        ce = lm_cross_entropy(module(*args), tokens, segment_ids)
        aux = torch.zeros((), device=ce.device)
        loss = ce + aux
        loss.backward()
        grad_norm = torch.nn.utils.get_total_norm(
            [p.grad for p in state["params"] if p.grad is not None])
        opt.step()
        state["step"] += 1
        return state, {"loss": loss.detach(), "ce": ce.detach(), "aux": aux,
                       "grad_norm": grad_norm}

    def shard_batch(tokens) -> torch.Tensor:
        return torch.as_tensor(tokens).to(dev, torch.long)

    return init_state, train_step, shard_batch
