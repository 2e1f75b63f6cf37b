"""The training step: loss, optimizer wiring and the update (counterpart
of ``torchdistx_tpu/parallel/train.py``), on one device or over a mesh.

PyTorch runs eagerly, so the step is a plain function: forward, the
loss, ``backward`` (through the flash kernels' backward when the model's
``attn_fn`` is ``make_flash_attention()``), the global gradient norm, and
an AdamW update in place.  Over a ``DeviceMesh`` the module takes the
keyed values' layout with tensor parallelism, FSDP2 and expert
parallelism (:mod:`.spmd`), the batch is split over the data axes, and
the metrics are reduced to the global ones on every rank.  An ``sp``
axis splits the sequence: each rank runs the model on its chunk (with a
sequence-parallel ``attn_fn`` such as ``make_ring_flash_attention``),
its loss is its share of the global mean and the gradients are summed
over ``sp``.  A ``pp`` axis with ``pipeline=True`` runs the blocks as
pipeline stages (:mod:`.pipeline`: GPipe, 1F1B or interleaved 1F1B),
each rank updating its own layers and the replicated embed and head,
laid out over the mesh's other axes as the dense step lays out the
whole model.  A
mixture-of-experts model adds its router's load-balancing loss to the
cross-entropy.  :func:`train_elastic` runs the step under the elastic
loop (:func:`..utils.run_elastic`: checkpoints, restarts, the watchdog,
preemption drain, resume onto another mesh).  With telemetry on
(:func:`..observe.enabled`) the step is wrapped by
:func:`_instrument_step`.
"""

from __future__ import annotations

import warnings
from typing import Callable, Iterable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import observe
from .._device import resolve_device
from ..fake import is_fake
from ..models.configs import TransformerConfig
from ..models.layers import AttnFn, Linear, moe_capacity, router_aux_loss
from ..observe.step import H100_PEAK_FLOPS  # noqa: F401 — re-exported
from .pipeline import SCHEDULES, valid_next_token_mask

OptimizerFactory = Callable[[Iterable], torch.optim.Optimizer]


def default_optimizer(params: Iterable) -> torch.optim.Optimizer:
    """``optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1)`` of the JAX
    package: decoupled weight decay on every parameter.  ``params`` are
    parameters or param groups (the mesh path groups its parameters by
    their DTensor mesh).  On the GPU the update is PyTorch's fused AdamW
    (one pass over parameters, gradients and both moments, as XLA fuses
    optax's update), DTensor parameters included."""
    groups = list(params)
    flat = [p for g in groups for p in g["params"]] \
        if groups and isinstance(groups[0], dict) else groups
    return torch.optim.AdamW(groups, lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                             weight_decay=0.1,
                             fused=all(p.is_cuda for p in flat))


def _token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """[B, S-1] next-token negative log-likelihoods, log-softmax in f32."""
    V = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].float().reshape(-1, V),
                           tokens[:, 1:].long().reshape(-1),
                           reduction="none").view(tokens.shape[0], -1)


def lm_cross_entropy(logits: torch.Tensor, tokens: torch.Tensor,
                     segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token CE over [B, S, V] logits and [B, S] tokens (shifted),
    log-softmax in f32.

    With ``segment_ids`` (packed sequences), positions whose next token
    belongs to another document, or to the padded tail (a NEGATIVE id),
    are excluded from the mean."""
    nll = _token_nll(logits, tokens)
    if segment_ids is None:
        return nll.mean()
    valid = valid_next_token_mask(segment_ids)
    return (nll * valid).sum() / valid.sum().clamp_min(1.0)


def train_step_flops(model: nn.Module, cfg: TransformerConfig, batch: int,
                     seq: int) -> float:
    """Model FLOPs of one step on [batch, seq] tokens: 6 per weight of
    every matrix product per token (2 forward, 4 backward; a tied head
    counts its embedding; a MoE router is one), plus causal attention's
    6·L·B·H·S²·D (QKᵀ and PV over half the square, forward and backward).

    A mixture of experts adds, per layer with T tokens, E experts of C
    rows (:func:`moe_capacity`) and top-k routing: the expert products,
    6 per expert weight per row (``3·E·d·ff`` weights over ``C`` rows,
    empty rows included, as the products run over them); the dispatch
    einsum, 2·T·E·C·d forward and 2·T·E·C·d for the input's gradient; the
    combine einsum, 2·T·E·C·d forward and twice that backward (the gates'
    and the expert outputs' gradients); and the one-hot products that
    build the dispatch and combine tensors, 2·T·E·C·k each and 2·T·E·C·k
    for the gates' gradient.  Rematerialized forwards are not model
    FLOPs and are not counted."""
    n = sum(m.weight.numel() for m in model.modules() if isinstance(m, Linear))
    if cfg.tie_embeddings:
        n += cfg.vocab_size * cfg.d_model
    attn = 6.0 * cfg.n_layers * batch * cfg.n_heads * seq * seq * cfg.head_size
    flops = 6.0 * n * batch * seq + attn
    if cfg.moe is not None:
        T, E, k = batch * seq, cfg.moe.n_experts, cfg.moe.top_k
        C = moe_capacity(cfg.moe, T)
        per_layer = (6.0 * 3 * E * cfg.d_model * cfg.d_ff * C
                     + 10.0 * T * E * C * cfg.d_model + 6.0 * T * E * C * k)
        flops += cfg.n_layers * per_layer
    return flops


def make_train_step(
    model: nn.Module,
    cfg: TransformerConfig,
    *,
    optimizer: Optional[OptimizerFactory] = None,
    attn_fn: Optional[AttnFn] = None,
    device="cuda",
    mesh=None,
    batch_axes=("dp", "fsdp"),
    pipeline: bool = False,
    pipeline_axis: str = "pp",
    pipeline_schedule: str = "gpipe",
    n_microbatches: int = 4,
    n_chunks: int = 2,
):
    """Build ``(init_state, train_step, shard_batch)`` for a decoder LM.

    * ``init_state(model)`` takes the materialized module (the one passed
      here: ``materialize_module`` works in place, and
      ``cuda_bridge.bind_values`` binds the keyed values) and returns the
      state ``{"model", "params", "opt", "step"}``; ``optimizer`` is a
      factory over the parameters (default: :func:`default_optimizer`);
    * ``train_step(state, tokens, segment_ids=None) -> (state, metrics)``
      updates the state in place; ``metrics`` holds ``loss`` (``ce +
      aux``), ``ce``, ``aux`` (the MoE router's load-balancing loss,
      :func:`..models.layers.router_aux_loss`; 0 without experts) and
      ``grad_norm`` (the global L2 norm of the gradients, unclipped, as
      ``optax.global_norm``) as 0-d device tensors, so the loop stays
      asynchronous until a value is read;
    * ``shard_batch(tokens)`` puts a [B, S] batch on the device.

    With ``mesh`` (a ``DeviceMesh`` of ``dp``, ``fsdp``, ``ep``, ``sp``
    and ``tp`` axes), ``init_state`` takes a module bound to the keyed values
    ``materialize_module_cuda(mesh=mesh, plan=...)`` gave and lays it out
    as they are placed, with tensor parallelism, FSDP2 and the experts
    split over ``ep`` and ``tp`` (:func:`.spmd.shard_module`);
    ``shard_batch`` gives this rank its rows of the global batch over
    ``batch_axes`` (replicated over ``ep`` and ``tp``); the MoE routing
    is global over the whole batch, as on one device; the metrics are the
    global ones, equal on every rank.  The device is the mesh's.

    With an ``sp`` axis, ``shard_batch`` also cuts each row into ``sp``
    equal chunks and gives this rank its chunk plus the next position's
    token ([B_local, S/sp + 1]; -1 past the sequence's end), so a
    chunk's last position is scored against the next chunk's first
    token; the same for ``segment_ids``.  The model runs on the chunk
    with ``seq_shard=(index, sp)`` (its positions) and must be built with
    a sequence-parallel ``attn_fn`` over the mesh (``sp`` > 1); the loss
    is the sum of every rank's valid targets over their global count and
    the gradients are summed over ``sp`` (the parameters are replicated
    there).  A mixture of experts is not split over ``sp``.

    With ``pipeline=True`` and a mesh of a ``pipeline_axis`` (``pp``)
    and any of ``dp``, ``fsdp``, ``ep``, ``sp`` and ``tp``, the blocks
    run as pipeline stages under ``pipeline_schedule``: ``"gpipe"``
    (every microbatch forward, then every backward), ``"1f1b"`` (one
    forward and one backward per tick) or ``"interleaved"``
    (``n_chunks`` chunks of layers per stage), over ``n_microbatches``
    microbatches (:mod:`.pipeline`).  ``init_state`` takes a module bound
    to this stage's values (``materialize_module_cuda(mesh=mesh,
    plan=pipeline_plan_overrides(plan, n_layers, n_chunks=...))`` and
    ``bind_values(strict=False)``: the other stages' layers stay fake),
    lays the stage's layers and the replicated embed, final norm and head
    out on the mesh of the other axes as the dense step lays out the
    whole (:func:`.spmd.shard_module`), and updates them; the embed's and
    head's gradients are summed over ``pp``.  ``shard_batch`` gives data
    shard ``r`` the ``r``-th share of each global microbatch (so a
    mixture of experts routes over the global microbatch, as the
    reference does) and, over ``sp``, its chunk with the next token.  The
    metrics are the global ones, equal on every rank.  The JAX
    signature's ``pipeline_executor`` has no counterpart: eager torch has
    no second program to pick.  A mixture of experts over ``sp`` routes
    each microbatch as one device routes it whole, as the dense step
    does (:class:`.spmd.ExpertParallel`).

    A model's attention is set by its constructor (``make_llama(cfg,
    attn_fn=...)``).  ``attn_fn`` here sets the pipelined stages'
    attention, as the JAX package's does; without ``pipeline`` it
    raises."""
    if pipeline_schedule not in SCHEDULES:
        raise ValueError(f"pipeline_schedule must be 'gpipe', '1f1b' or "
                         f"'interleaved', got {pipeline_schedule!r}")
    if pipeline_schedule != "gpipe" and not pipeline:
        # Training the dense path while the caller believes they asked
        # for 1F1B would invalidate whatever they measure.
        raise ValueError(f"pipeline_schedule={pipeline_schedule!r} requires "
                         f"pipeline=True (got pipeline=False).")
    if attn_fn is not None and not pipeline:
        raise ValueError(
            "make_train_step(attn_fn=) sets the pipelined stages' attention "
            "(pipeline=True); without a pipeline the attention is the "
            "model's: pass attn_fn to its constructor")
    make_opt = optimizer or default_optimizer
    seq = None
    if pipeline:
        if mesh is None or pipeline_axis not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"pipeline=True needs a mesh with a "
                             f"{pipeline_axis!r} axis (make_mesh)")
        dev, n_batch, seq, stages, (init_state, train_step, shard_batch) = \
            _over_pipeline(model, cfg, mesh, device, batch_axes, make_opt,
                           pipeline_axis, pipeline_schedule, n_microbatches,
                           n_chunks if pipeline_schedule == "interleaved"
                           else 1, attn_fn)
    elif mesh is None:
        dev, n_batch = resolve_device(device), 1
        init_state, train_step, shard_batch = _single_device(dev, make_opt)
    else:
        dev, n_batch, seq, (init_state, train_step, shard_batch) = \
            _over_mesh(mesh, device, batch_axes, make_opt)
    if observe.enabled():
        # Decided at build time: with telemetry off the raw step is
        # returned and the loop stays asynchronous.
        train_step = _instrument_step(train_step, cfg, dev,
                                      1 if mesh is None else mesh.size(),
                                      n_batch, seq,
                                      stages if pipeline else None)
    return init_state, train_step, shard_batch


def train_elastic(
    model: nn.Module,
    cfg: TransformerConfig,
    batches,
    *,
    mesh=None,
    device="cuda",
    optimizer: Optional[OptimizerFactory] = None,
    step_options: Optional[dict] = None,
    **elastic_kw,
):
    """:func:`make_train_step` wired into the chaos-hardened elastic loop
    (counterpart of the JAX package's ``train_elastic``).

    Builds the train step for ``model`` (materialized, or bound to its
    keyed values on ``mesh``), takes its state with ``init_state`` and
    runs :func:`..utils.failures.run_elastic` over ``batches`` (each a
    ``[B, S]`` token array, put on the device by ``shard_batch`` before
    the step).  All of ``run_elastic``'s hardening rides along — periodic
    integrity-manifested checkpoints of the module, the optimizer (its
    step counters included) and the step count, in-place restore on a
    failure with quarantine fallback, the step watchdog, SIGTERM drain,
    resume onto another mesh, and :mod:`..chaos` fault plans — as does
    the telemetry both layers emit.

    ``step_options`` forwards to :func:`make_train_step` (``batch_axes``,
    the pipeline options, ...); ``elastic_kw`` forwards to
    ``run_elastic`` (``checkpoint_dir``, ``checkpoint_every``,
    ``step_deadline``, ``resume``, ``on_metrics``, ...).  Packed
    ``segment_ids`` are not threaded through: call ``make_train_step``
    directly for packed batches.

    Returns ``(state, steps_completed, restarts_used)``."""
    from ..utils.failures import run_elastic

    init_state, train_step, shard_batch = make_train_step(
        model, cfg, optimizer=optimizer, device=device, mesh=mesh,
        **(step_options or {}))
    state = init_state(model)

    def step(state_now, tokens):
        return train_step(state_now, shard_batch(tokens))

    return run_elastic(step, state, batches, **elastic_kw)


def _single_device(dev: torch.device, make_opt):
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
        aux = router_aux_loss(module)
        loss = ce + aux
        loss.backward()
        grad_norm = torch.nn.utils.get_total_norm(
            [p.grad for p in state["params"] if p.grad is not None])
        opt.step()
        state["step"] += 1
        return state, {"loss": loss.detach(), "ce": ce.detach(),
                       "aux": aux.detach(), "grad_norm": grad_norm}

    def shard_batch(tokens) -> torch.Tensor:
        return torch.as_tensor(tokens).to(dev, torch.long)

    return init_state, train_step, shard_batch


def _over_mesh(mesh, device, batch_axes, make_opt):
    """The mesh path of :func:`make_train_step`."""
    from .collectives import all_reduce_
    from .sharding import mesh_shape
    from .spmd import (
        data_axes,
        data_index,
        global_grad_norm,
        reduce_replicated_grads,
        shard_module,
        sum_grads,
    )

    names = tuple(mesh.mesh_dim_names or ())
    if "pp" in names:
        raise ValueError("a 'pp' mesh axis runs the blocks as pipeline "
                         "stages: pass pipeline=True")
    if not names or any(a not in ("dp", "fsdp", "ep", "sp", "tp")
                        for a in names):
        raise ValueError(f"make_train_step takes a mesh of named dp, fsdp, "
                         f"ep, sp and tp axes, not {mesh}")
    if torch.device(device).type != mesh.device_type:
        raise ValueError(f"device {device!r} differs from the mesh's "
                         f"device type {mesh.device_type!r}")
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    shape = mesh_shape(mesh)
    baxes = data_axes(mesh, batch_axes)
    seq = "sp" in names
    n_sp = shape.get("sp", 1)
    sp_idx = mesh.get_local_rank("sp") if seq else 0
    if not baxes and mesh.size() // n_sp > 1:
        warnings.warn(
            f"make_train_step: none of batch_axes={tuple(batch_axes)} is on "
            f"the mesh (axes: {names}); the batch will be REPLICATED on "
            f"every device. Pass batch_axes matching your mesh's data axes "
            f"if this is not intended.")
    n_batch = 1
    for a in baxes:
        n_batch *= shape[a]
    batch_groups = [mesh.get_group(a) for a in baxes if shape[a] > 1]
    sp_group = mesh.get_group("sp") if n_sp > 1 else None
    # The groups a metric sums over: the data shards and the chunks.
    sum_groups = batch_groups + ([sp_group] if sp_group else [])

    def all_sum(t: torch.Tensor) -> torch.Tensor:
        for group in sum_groups:
            all_reduce_(t, group)
        return t

    def init_state(module: nn.Module) -> dict:
        if seq:
            _check_seq_parallel(module, n_sp)
        sharded = shard_module(module, mesh, batch_axes)
        named = list(module.named_parameters())
        params = [p for _, p in named]
        by_mesh: dict = {}
        for p in params:
            by_mesh.setdefault(getattr(p, "device_mesh", None), []).append(p)
        return {"model": module, "params": params,
                "opt": make_opt([{"params": ps} for ps in by_mesh.values()]),
                "step": 0, "sharded": sharded, "mesh": mesh,
                "split": [sharded.split.get(n, 1) for n, _ in named]}

    def train_step(state: dict, tokens: torch.Tensor,
                   segment_ids: Optional[torch.Tensor] = None):
        module, opt = state["model"], state["opt"]
        opt.zero_grad(set_to_none=True)
        if seq:
            nll_sum, total = _chunk_nll(module, tokens, segment_ids,
                                        (sp_idx, n_sp), all_sum)
        else:
            args = (tokens,) if segment_ids is None else (tokens, segment_ids)
            nll = _token_nll(module(*args), tokens)
            if segment_ids is None:
                total = float(nll.numel() * n_batch)
                nll_sum = nll.sum()
            else:
                valid = valid_next_token_mask(segment_ids)
                nll_sum = (nll * valid).sum()
                total = all_sum(valid.sum()).clamp_min(1.0)
        # FSDP2 and reduce_replicated_grads average the gradients over
        # the data ranks; this rank's share of the global mean, times the
        # number of batch shards, averages to the global mean's gradient.
        # The router loss is global already: its mean's all-reduce sums
        # the gradient over the data ranks in the backward, which the
        # average takes back out.
        aux = router_aux_loss(module)
        (nll_sum * (n_batch / total) + aux).backward()
        reduce_replicated_grads(state["sharded"])
        if sp_group is not None:
            # Each chunk's backward gives its share of every gradient.
            sum_grads(state["params"], sp_group)
        grad_norm = global_grad_norm(state["params"], mesh, state["split"])
        opt.step()
        state["step"] += 1
        ce = all_sum(nll_sum.detach()) / total
        aux = aux.detach()
        return state, {"loss": ce + aux, "ce": ce, "aux": aux,
                       "grad_norm": grad_norm}

    def shard_batch(tokens) -> torch.Tensor:
        t = torch.as_tensor(tokens)
        if t.shape[0] % n_batch:
            raise ValueError(f"batch of {t.shape[0]} rows does not divide "
                             f"over {baxes} ({n_batch} shards)")
        idx = data_index(mesh, baxes)
        rows = t.shape[0] // n_batch
        t = t[idx * rows:(idx + 1) * rows]
        if seq:
            t = _chunk_with_next(t, sp_idx, n_sp)
        return t.to(dev, torch.long)

    def sp_sum(x: float) -> float:
        t = torch.tensor([x], dtype=torch.float64, device=dev)
        return float(all_reduce_(t, sp_group)) if sp_group else x

    return (dev, n_batch, (n_sp, sp_sum) if seq else None,
            (init_state, train_step, shard_batch))


def _over_pipeline(model, cfg, mesh, device, batch_axes, make_opt, axis,
                   schedule, n_microbatches, n_chunks, attn_fn):
    """The pipeline path of :func:`make_train_step`.

    Each stage lays its part of the model (its blocks, the embed, the
    final norm and the head) out on the mesh of the other axes as the
    dense step lays out the whole (:func:`.spmd.shard_module`: tensor
    parallelism over ``tp``, FSDP2 over the data axes, the experts over
    ``ep``/``tp``), walks the schedule over ``pp`` and reduces what the
    dense step reduces: the data axes' gradients averaged (the CE's
    backward weighted by the number of data shards), the sequence
    chunks' summed, and the replicated parameters' summed over ``pp``."""
    import math

    from .collectives import all_reduce_
    from .pipeline import (
        StageSchedule,
        default_decomposition,
        light_params,
        stage_params,
    )
    from .sharding import mesh_shape
    from .spmd import (
        data_axes,
        data_index,
        global_grad_norm,
        reduce_replicated_grads,
        shard_module,
        sum_grads,
    )

    names = tuple(mesh.mesh_dim_names)
    for a in names:
        if a not in (axis, "dp", "fsdp", "ep", "sp", "tp"):
            raise ValueError(f"a pipelined step takes a mesh of {axis!r} "
                             f"and dp, fsdp, ep, sp and tp axes, not {mesh}")
    if torch.device(device).type != mesh.device_type:
        raise ValueError(f"device {device!r} differs from the mesh's "
                         f"device type {mesh.device_type!r}")
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    shape = mesh_shape(mesh)
    seq = "sp" in names
    n_sp = shape.get("sp", 1)
    sp_idx = mesh.get_local_rank("sp") if seq else 0
    baxes = data_axes(mesh, batch_axes)
    n_batch = math.prod(shape[a] for a in baxes)
    sum_groups = [mesh.get_group(a) for a in baxes if shape[a] > 1]
    sp_group = mesh.get_group("sp") if n_sp > 1 else None
    if sp_group is not None:
        sum_groups.append(sp_group)
    n_pp = shape[axis]
    pp_group = mesh.get_group(axis) if n_pp > 1 else None
    # The stage's own mesh: every axis but pp.
    rest = tuple(a for a in names if a != axis)
    stage_mesh = mesh[rest if len(rest) > 1 else rest[0]] if rest else None
    decomp = default_decomposition(model)
    sched = StageSchedule(cfg, decomp, mesh, schedule=schedule,
                          n_microbatches=n_microbatches, n_chunks=n_chunks,
                          axis_name=axis,
                          seq_shard=(sp_idx, n_sp) if seq else None)

    def all_sum(t: torch.Tensor) -> torch.Tensor:
        for group in sum_groups:
            all_reduce_(t, group)
        return t

    def init_state(module: nn.Module) -> dict:
        if module is not model:
            raise ValueError("init_state takes the module make_train_step "
                             "was built for")
        if seq:
            _check_seq_parallel(module, n_sp, attn_fn)
        own = {id(b) for c in sched.chunks for b in c}
        sharded = None
        _stage_values(module, mesh, axis, stage_mesh)
        if stage_mesh is not None:
            sharded = shard_module(
                module, stage_mesh, batch_axes, pipelined=True,
                skip=[b for b in decomp.blocks if id(b) not in own])
            sched.sync_units(module)
        params = stage_params(module, decomp, mesh, axis, n_chunks)
        if any(is_fake(p) for p in params):
            raise ValueError(
                "init_state needs this stage's layers and the replicated "
                "parameters materialized; bind them first")
        off = {str(p.device) for p in params if p.device != dev}
        if off:
            raise ValueError(f"parameters on {sorted(off)}, not on {dev}")
        # stage_params lists this stage's layers' parameters first.
        n_own = len(params) - len(light_params(module, decomp))
        name_of = {id(p): n for n, p in module.named_parameters()}
        split = [1 if sharded is None else sharded.split.get(name_of[id(p)], 1)
                 for p in params]
        holders = [mesh.size() // n_pp] * n_own \
            + [mesh.size()] * (len(params) - n_own)
        by_mesh: dict = {}
        for p in params:
            by_mesh.setdefault(getattr(p, "device_mesh", None), []).append(p)
        return {"model": module, "params": params,
                "opt": make_opt([{"params": ps} for ps in by_mesh.values()]),
                "step": 0, "sharded": sharded, "split": split,
                "holders": holders}

    def train_step(state: dict, tokens: torch.Tensor,
                   segment_ids: Optional[torch.Tensor] = None):
        module, opt = state["model"], state["opt"]
        opt.zero_grad(set_to_none=True)
        # The global count of valid targets, before any backward.
        if seq:
            valid = (tokens[:, 1:] >= 0).float()
            if segment_ids is not None:
                valid = valid * valid_next_token_mask(segment_ids)
            denom = all_sum(valid.sum()).clamp_min(1.0)
        elif segment_ids is None:
            denom = float(tokens.shape[0] * n_batch * (tokens.shape[1] - 1))
        else:
            denom = all_sum(valid_next_token_mask(segment_ids).sum()
                            ).clamp_min(1.0)
        # Each rank's CE is its share of the global sum; weighted by the
        # data shards, the average over them gives the global gradient.
        metrics = sched.train(module, tokens, attn_fn=attn_fn,
                              segment_ids=segment_ids, denom=denom,
                              loss_scale=float(n_batch))
        params = state["params"]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if state["sharded"] is not None:
            reduce_replicated_grads(state["sharded"])
        if sp_group is not None:
            # Each chunk's backward gives its share of every gradient.
            sum_grads(params, sp_group)
        # This stage's layers counted on its ranks, the replicated
        # parameters (equal on every stage) once.
        grad_norm = global_grad_norm(params, mesh, state["split"],
                                     state["holders"])
        opt.step()
        state["step"] += 1
        ce = all_sum(metrics["ce"])
        return state, {"loss": ce + metrics["aux"], "ce": ce,
                       "aux": metrics["aux"], "grad_norm": grad_norm}

    def shard_batch(tokens) -> torch.Tensor:
        """This rank's rows: microbatch ``i`` of the global batch is its
        rows ``[i B / n_mb, (i + 1) B / n_mb)``, and data shard ``r`` takes
        the ``r``-th share of each, so the MoE routing over the data
        shards sees the global microbatch; then this rank's sequence
        chunk with the next token over ``sp``."""
        t = torch.as_tensor(tokens)
        if t.shape[0] % (n_batch * n_microbatches):
            raise ValueError(
                f"batch of {t.shape[0]} rows does not divide into "
                f"{n_microbatches} microbatches over {baxes} ({n_batch} "
                f"shards)")
        rows = t.shape[0] // (n_batch * n_microbatches)
        t = t.reshape(n_microbatches, n_batch, rows, *t.shape[1:])
        t = t[:, data_index(mesh, baxes)].reshape(-1, *t.shape[3:])
        if seq:
            t = _chunk_with_next(t, sp_idx, n_sp)
        return t.to(dev, torch.long)

    def split_sum(x: float) -> float:
        """A count summed over the stages and the sequence chunks."""
        t = torch.tensor([x], dtype=torch.float64, device=dev)
        for group in (pp_group, sp_group):
            if group is not None:
                all_reduce_(t, group)
        return float(t)

    # The FLOP counts are summed by split_sum; seq gives the tokens' chunks.
    return (dev, n_batch, (n_sp, None) if seq else None,
            (n_pp * n_sp, split_sum), (init_state, train_step, shard_batch))


def _stage_values(module: nn.Module, mesh, axis: str, stage_mesh) -> None:
    """Put each value bound to ``module`` on the stage's layout: a DTensor
    on the whole mesh (an entry every stage holds, replicated over
    ``axis``) becomes the same local tensor on ``stage_mesh`` (the other
    axes), or a plain tensor where there is none; a stage-owned entry is
    on ``stage_mesh`` already.  Buffers become plain local tensors."""
    from torch.distributed.tensor import DTensor, Replicate

    made: dict = {}
    for mod in module.modules():
        for d, is_param in ((mod._parameters, True), (mod._buffers, False)):
            for k, t in d.items():
                if not isinstance(t, DTensor) or t.device_mesh != mesh:
                    continue
                if id(t) not in made:
                    where = dict(zip(mesh.mesh_dim_names, t.placements))
                    if not isinstance(where[axis], Replicate):
                        raise ValueError(
                            f"`{k}` is placed {tuple(t.placements)} on "
                            f"{mesh}: a pipeline stage takes the entries "
                            f"every stage holds replicated over {axis!r}")
                    local = t.to_local().detach()
                    if is_param and stage_mesh is not None:
                        local = DTensor.from_local(
                            local, stage_mesh,
                            [where[a] for a in stage_mesh.mesh_dim_names],
                            run_check=False, shape=t.shape, stride=t.stride())
                    made[id(t)] = nn.Parameter(
                        local, requires_grad=t.requires_grad) \
                        if is_param else local
                d[k] = made[id(t)]


def _chunk_with_next(t: torch.Tensor, index: int, count: int) -> torch.Tensor:
    """Chunk ``index`` of ``count`` of each row of ``t`` [B, S], followed by
    the next position's entry (-1 past the row's end): [B, S/count + 1]."""
    B, S = t.shape
    if S % count:
        raise ValueError(f"sequence of {S} tokens does not split into "
                         f"{count} equal chunks over sp")
    s = S // count
    nxt = t[:, (index + 1) * s:(index + 1) * s + 1]
    if nxt.shape[1] == 0:
        nxt = torch.full((B, 1), -1, dtype=t.dtype)
    return torch.cat([t[:, index * s:(index + 1) * s], nxt], 1)


def _chunk_nll(module: nn.Module, tokens: torch.Tensor, segment_ids,
               seq_shard, all_sum):
    """``(sum of this chunk's valid next-token NLLs, the global count of
    valid targets)`` for ``shard_batch``'s [B, s + 1] chunks: the model
    runs on the first s columns at the chunk's positions; a target is
    valid where it exists (>= 0) and, with packed ids, stays inside its
    document (:func:`valid_next_token_mask` on the chunk and the next
    id)."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    args = (inputs,) if segment_ids is None else (inputs, segment_ids[:, :-1])
    logits = module(*args, seq_shard=seq_shard)
    V = logits.shape[-1]
    nll = F.cross_entropy(logits.float().reshape(-1, V),
                          targets.clamp_min(0).reshape(-1),
                          reduction="none").view(targets.shape)
    valid = (targets >= 0).float()
    if segment_ids is not None:
        valid = valid * valid_next_token_mask(segment_ids)
    return (nll * valid).sum(), all_sum(valid.sum()).clamp_min(1.0)


def _check_seq_parallel(module: nn.Module, n_sp: int, attn_fn=None) -> None:
    """An ``sp`` mesh needs every attention layer to attend across the
    chunks (``attn_fn``, where given, attends for every layer).  A
    mixture of experts routes over the chunks by itself
    (:class:`.spmd.ExpertParallel`)."""
    from ..models.layers import Attention, CrossAttention

    if n_sp == 1:
        return
    for name, m in module.named_modules():
        if isinstance(m, (Attention, CrossAttention)) \
                and getattr(attn_fn or m.attn_fn, "seq_parallel",
                            None) is None:
            raise ValueError(
                f"`{name}`: the mesh splits the sequence over sp ({n_sp}), "
                f"but this layer's attn_fn sees only its chunk; build the "
                f"model with make_ring_flash_attention(mesh) (or the ring or "
                f"Ulysses attention)")


# Batch shapes whose FLOPs are counted; past this, new shapes use the
# 6·N·D estimate (the JAX package's AOT cache has the same bound).
_COUNTED_SHAPES_MAX = 8


def _instrument_step(step_fn, cfg: TransformerConfig, dev: torch.device,
                     n_ranks: int, n_batch: int, seq=None, stages=None):
    """Per-step telemetry around a train step: a ``train.step`` span plus
    ``tdx.train.tokens_per_s`` and MFU gauges, via
    :class:`..observe.StepMeter`.  Each step synchronizes the device so
    the span covers its work — which is why this wrapper exists only
    when telemetry is enabled.

    FLOPs are counted: the first call of each batch shape runs under
    ``FlopCounterMode`` (:func:`..observe.costmodel.program_costs`; that
    step is metered like any other and its span carries the count as
    ``flops_counted``), and the gauge is ``tdx.train.mfu``, counted work
    over measured time.  Shapes past the first 8 use the 6·N·D estimate
    under the ``tdx.train.mfu_est`` name.

    The peak is the card's peak times the ranks, and the FLOPs are this
    rank's count times the ranks (each rank counts its own shards;
    ``n_batch`` data shards carry the global batch): whole-mesh work over
    the whole mesh's peak.  ``seq = (n_sp, sp_sum)`` on a mesh with an
    ``sp`` axis: the batch holds this rank's chunks plus the next token
    (``shard_batch``), so the tokens are ``n_sp`` chunks' worth, and the
    chunks' counts differ (causal attention sees more keys late in the
    sequence), so they are summed over ``sp`` (``sp_sum``) before the
    other axes multiply them.  ``stages = (n_pp, pp_sum)`` on a pipeline:
    each stage counts its own layers (the first its embed, the last its
    head), so the counts are summed over ``pp`` the same way.  On a card
    whose peak is unknown (and on the CPU) MFU is left out."""
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    chip_peak = observe.peak_tflops_for(kind, cfg.dtype)
    meter = observe.StepMeter(
        peak_tflops=chip_peak * n_ranks if chip_peak else None)
    counted: dict = {}
    n_params = None

    def wrapped(state, tokens, segment_ids=None):
        if not observe.enabled():
            # Telemetry was turned off after build: skip the meter (it
            # would record nothing but still synchronize every step).
            return step_fn(state, tokens, segment_ids)
        nonlocal n_params
        if n_params is None:
            n_params = sum(p.numel() for p in state["params"])
        if seq is None:
            ntok = tokens.numel() * n_batch
        else:
            ntok = tokens.shape[0] * (tokens.shape[1] - 1) * seq[0] * n_batch
        meter.tokens_per_step = ntok
        shape = (tuple(tokens.shape), str(tokens.dtype), segment_ids is None)
        count = shape not in counted and len(counted) < _COUNTED_SHAPES_MAX
        flops = counted.get(shape)
        meter.flops_per_step = flops or 6.0 * n_params * ntok
        meter.flops_source = "counted" if flops else "estimate"
        meter.start()
        if count:
            out, costs = observe.costmodel.program_costs(
                step_fn, state, tokens, segment_ids)
            split = stages or seq
            if split is None:
                flops = costs["flops"] * n_ranks
            else:
                flops = split[1](costs["flops"]) * n_ranks / split[0]
            counted[shape] = flops
            observe.costmodel.note_program_memory(costs)
            meter.flops_per_step, meter.flops_source = flops, "counted"
            if meter._span is not None:
                meter._span.set(flops_counted=flops)
        else:
            out = step_fn(state, tokens, segment_ids)
        meter.stop(out[1])
        return out

    return wrapped
