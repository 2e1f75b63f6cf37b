"""Pipeline parallelism over the ``pp`` mesh axis (counterpart of
``torchdistx_tpu/parallel/pipeline.py``).

Each rank along ``pp`` is a stage that owns a run of the model's blocks
(:func:`.sharding.stage_layers`; with ``n_chunks`` > 1, chunk ``k`` of
``pp * n_chunks`` lives on stage ``k % pp``).  Microbatches go from
stage to stage tick by tick: activations to the next stage, cotangents
to the previous one, each a point-to-point transfer
(:func:`.collectives.stage_exchange`) made only on the ticks where the
schedule has an arrival, which both sides read from the same table.
The schedules:

* GPipe (:func:`pipeline_train_gpipe`, and :func:`pipelined_decoder_apply`
  for the forward alone): every microbatch's forward, then every
  backward in reverse;
* flat 1F1B (:func:`pipeline_train_1f1b`): one forward and one backward
  per tick, over the warmup / steady / cooldown segments of
  :func:`.interleave.flat_1f1b_segments`;
* interleaved 1F1B (:func:`pipeline_train_interleaved`): the per-(stage,
  tick) tables of :func:`.interleave.interleaved_schedule`, with their
  inbox and stash slots.

What a step on a stage is fixed by (its chunks of blocks, its ticks and
tables, the activations' shape) is built once, in a
:class:`StageSchedule`; ``make_train_step`` keeps one for every step.

The backward.  The JAX package stashes each stage's input and recomputes
the stage interior under ``jax.vjp`` in the backward.  Here a forward
keeps its microbatch's autograd graph (the stage input as a leaf, the
output, the router's aux), and its backward is ``torch.autograd.backward``
of that graph with the cotangent that arrived: no recompute, so each
flash kernel launches once per layer and microbatch in each direction.
Within a tick the backward runs before the forward unless it is the
last chunk's seed, which needs that forward's loss: the 1F1B orders then
bound the graphs alive on stage ``s`` of the flat schedule to ``2(pp - 1
- s)`` (one on the last stage), where GPipe keeps all
``n_microbatches`` (ROADMAP C6).

The embed and the head.  Their parameters are replicated on every stage,
as in the reference; the first stage runs the embed of each microbatch,
the last the head and the loss (the reference computes them on every
stage; eager torch runs them where they are used), and their gradients
are summed over ``pp`` so every stage holds the same ones and takes the
same update.  A tied head's table gets the embed's gradient from the
first stage and the head's from the last.

The loss is the exact full-batch mean cross-entropy, in sum form: each
microbatch's valid next-token NLLs over the GLOBAL count of valid
targets, fixed before any backward (from packed ``segment_ids`` through
:func:`valid_next_token_mask`).  A mixture of experts adds each
microbatch's router loss with weight ``1 / n_microbatches``.

The other mesh axes.  A stage's blocks, embed, final norm and head run
under the dense step's layout on the mesh of the other axes
(``spmd.shard_module(pipelined=True)``: tensor parallelism over ``tp``,
FSDP2 units over the data axes, the experts over ``ep``/``tp``); what
goes over ``pp`` is always the tp-replicated local activation ``[mb,
S / sp, d]`` (or its cotangent), on one ``pp`` group per coordinate of
the other axes.  Each FSDP2 unit is told before every backward whether
it is its chunk's last of the step, so it is gathered once a step, its
gradients accumulate unsharded, and it is reduced and resharded once.  Over ``sp`` each microbatch is the
rank's sequence chunk plus the next token, attended by the stages'
sequence-parallel ``attn_fn``.

The JAX package's ``executor`` knob (``TDX_PP_EXECUTOR``) picks between
two compiled programs of a schedule; eager torch runs the segments'
ticks as they come and has nothing to pick, so the port has no such
knob (ROADMAP C7).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
from torch import nn

from .. import observe
from ..models.layers import MoEMLP, run_block
from .collectives import all_reduce_, axis_group, axis_index, axis_size, stage_exchange
from .sharding import StageShardingPlan, stage_layers
from .spmd import _local

SCHEDULES = ("gpipe", "1f1b", "interleaved")


def _note_schedule_segments(segs, label: str) -> None:
    """Publish the segment layout as ``tdx.pp.*`` gauges."""
    if not observe.enabled():
        return
    roles = {"warmup": 0, "steady": 0, "cooldown": 0}
    for s in segs:
        roles[s.role] = roles.get(s.role, 0) + s.ticks
    g = observe.counters().gauge
    g("tdx.pp.warmup_ticks", schedule=label).set(roles["warmup"])
    g("tdx.pp.steady_ticks", schedule=label).set(roles["steady"])
    g("tdx.pp.cooldown_ticks", schedule=label).set(roles["cooldown"])
    g("tdx.pp.segments", schedule=label).set(len(segs))


def valid_next_token_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """[B, S-1] f32 mask of valid next-token targets for packed ids:
    positions whose next token crosses a document boundary are excluded,
    and a NEGATIVE id marks the padded tail (also excluded)."""
    return ((segment_ids[:, :-1] == segment_ids[:, 1:])
            & (segment_ids[:, 1:] >= 0)).float()


def default_decomposition(model: nn.Module):
    """The model's own :class:`..models.decomposition.PipelineDecomposition`
    (Llama and Mixtral, GPT-2 and ViT export one).  The JAX package
    builds a stock family from the config here; the port's blocks are
    the model's modules, so the decomposition must come from it."""
    export = getattr(model, "pipeline_decomposition", None)
    if export is None:
        raise ValueError(f"{type(model).__name__} exports no "
                         f"pipeline_decomposition(); pass decomp=")
    return export()


def pipeline_plan_overrides(plan, n_layers: int, axis_name: str = "pp",
                            n_chunks: int = 1) -> StageShardingPlan:
    """``plan`` with each block layer owned whole by one stage over
    ``axis_name`` (the layout of ``n_chunks`` chunks per stage), so the
    keyed materializer draws each layer only on its own stage."""
    return StageShardingPlan(plan, n_layers, axis=axis_name,
                             n_chunks=n_chunks)


def _mb_ce_sum(logits, tokens, segment_ids, denom, chunked: bool = False):
    """Next-token CE of ONE microbatch in SUM form over the GLOBAL valid
    count ``denom``: the microbatches' terms add up to the full-batch
    mean, so each one's backward can start as soon as its forward ends.

    ``chunked``: ``tokens`` [B, s + 1] is a sequence-parallel rank's chunk
    and the next position's token (-1 past the sequence's end), the
    logits the chunk's: position j is scored against token j + 1 where
    it exists (and, with packed ids, stays inside its document)."""
    V = logits.shape[-1]
    if chunked:
        targets = tokens[:, 1:]
        nll = nn.functional.cross_entropy(
            logits.float().reshape(-1, V),
            targets.clamp_min(0).long().reshape(-1), reduction="none")
        valid = (targets >= 0).float()
        if segment_ids is not None:
            valid = valid * valid_next_token_mask(segment_ids)
        return (nll * valid.reshape(-1)).sum() / denom
    nll = nn.functional.cross_entropy(
        logits[:, :-1].float().reshape(-1, V),
        tokens[:, 1:].long().reshape(-1), reduction="none")
    if segment_ids is None:
        return nll.sum() / denom
    return (nll * valid_next_token_mask(segment_ids).reshape(-1)).sum() / denom


@contextlib.contextmanager
def _stage_attention(chunks, attn_fn):
    """The stage's blocks attend with ``attn_fn`` for one step (the JAX
    argument is per call), then with their own again."""
    if attn_fn is None:
        yield
        return
    attns = [blk.attn for c in chunks for blk in c]
    own = [a.attn_fn for a in attns]
    for a in attns:
        a.attn_fn = attn_fn
    try:
        yield
    finally:
        for a, fn in zip(attns, own):
            a.attn_fn = fn


class StageSchedule:
    """One stage's part of a schedule, built once: its chunks of blocks,
    its ticks (and, interleaved, its rows of the tables), what it knows
    of the activations that arrive.  :meth:`train` runs a step on it.

    ``schedule`` is ``"gpipe"``, ``"1f1b"`` or ``"interleaved"``
    (``n_chunks`` chunks a stage; the others take one).  ``seq_shard =
    (index, count)`` says each microbatch is this rank's chunk of the
    sequence plus the next position's token (``make_train_step``'s
    ``shard_batch`` on an ``sp`` mesh): the embed, the rope angles and
    the loss take the chunk's positions, and the activations exchanged
    are ``[mb, S / count, d]``.

    On a mesh whose other axes lay the stage's blocks out with FSDP2
    (``spmd.shard_module(pipelined=True)``), :meth:`sync_units` names the
    FSDP2 units each chunk's backward runs through; each backward then
    tells them whether it is the chunk's last of the step, so each unit
    stays gathered and its gradients accumulate unsharded over the
    microbatches, and it is reduced and resharded once, whatever the
    order of the forwards and backwards."""

    def __init__(self, cfg, decomp, mesh, *, schedule: str = "gpipe",
                 n_microbatches: int = 4, n_chunks: int = 1,
                 axis_name: str = "pp", seq_shard=None):
        if schedule not in SCHEDULES:
            raise ValueError(f"pipeline_schedule must be 'gpipe', '1f1b' or "
                             f"'interleaved', got {schedule!r}")
        v = n_chunks if schedule == "interleaved" else 1
        self.cfg, self.decomp, self.mesh, self.axis = cfg, decomp, mesh, axis_name
        self.schedule, self.n_mb = schedule, n_microbatches
        self.pp = pp = axis_size(mesh, axis_name)
        self.s = s = axis_index(mesh, axis_name)
        self.K = pp * v
        self.chunks = [[decomp.blocks[i] for i in ls]
                       for ls in stage_layers(len(decomp.blocks), pp, s, v)]
        self.moe = any(isinstance(m, MoEMLP)
                       for c in self.chunks for b in c for m in b.modules())
        self.seq_shard = None if seq_shard is None else tuple(seq_shard)
        self.units: Optional[List[list]] = None
        self._angles: Dict[int, Optional[torch.Tensor]] = {}
        n = n_microbatches
        if schedule == "gpipe":
            self.T = n + pp - 1
        elif schedule == "1f1b":
            from .interleave import flat_1f1b_segments

            segs = flat_1f1b_segments(pp, n)
            _note_schedule_segments(segs, schedule)
            self.ticks = [(t, g.has_f, g.has_b) for g in segs
                          for t in range(g.t0, g.t1)]
        else:
            from .interleave import interleaved_schedule

            sched = interleaved_schedule(pp, v, n)
            segs = sched.segments()
            _note_schedule_segments(segs, schedule)
            self.ticks = [(t, g.has_f, g.has_b) for g in segs
                          for t in range(g.t0, g.t1)]
            self.T = sched.T
            self.tab = {k: a[s].tolist() for k, a in sched.tables().items()}
            self.slots = (sched.n_f_slots, sched.n_b_slots,
                          sched.n_stash_slots)

    def angles(self, S: int):
        if S not in self._angles:
            self._angles[S] = self.decomp.angles(S, self.seq_shard)
        return self._angles[S]

    def sync_units(self, model: nn.Module) -> None:
        """Find the FSDP2 units of each local chunk: its blocks, and on the
        chunks that hold the embed (global chunk 0) or the head (the last)
        the units outside the blocks."""
        from torch.distributed.fsdp import FSDPModule

        in_blocks = {id(m) for b in self.decomp.blocks for m in b.modules()}
        light = [m for m in model.modules()
                 if isinstance(m, FSDPModule) and id(m) not in in_blocks]
        self.units = []
        for j, chunk in enumerate(self.chunks):
            k = j * self.pp + self.s
            units = [b for b in chunk if isinstance(b, FSDPModule)]
            if k in (0, self.K - 1):
                units += light
            self.units.append(units)

    def train(self, model: nn.Module, tokens, *, attn_fn=None,
              segment_ids=None, denom=None, loss_scale: float = 1.0) -> dict:
        """One step's gradients on this stage, into its parameters'
        ``.grad`` (the replicated ones summed over ``pp``); returns
        ``{"loss", "ce", "aux"}``, equal on every stage.  ``denom`` is
        the global count of valid targets when the batch is split
        further (over the data axes or ``sp``), and ``loss_scale`` the
        weight of the CE's backward (the number of data shards, whose
        gradients the reductions then average).  Call on every rank of
        the mesh."""
        st = _Step(self, tokens, segment_ids, denom, with_loss=True,
                   loss_scale=loss_scale)
        with _stage_attention(self.chunks, attn_fn):
            _WALKERS[self.schedule](st)
        return st.finish(model)


class _InFlight:
    """One microbatch's state on local chunk ``j`` between its forward and
    its backward: the chunk's input, output, router loss and (on the last
    chunk) its cross-entropy term."""

    __slots__ = ("x", "y", "aux", "ce", "j")

    def __init__(self, x, y, aux, ce, j):
        self.x, self.y, self.aux, self.ce, self.j = x, y, aux, ce, j


class _Step:
    """One step on a :class:`StageSchedule`: its microbatches, the
    transfers and the sums of the metrics."""

    def __init__(self, sched: StageSchedule, inputs, segment_ids, denom, *,
                 with_loss: bool, loss_scale: float = 1.0):
        self.sched = sched
        self.pp, self.s, self.K = sched.pp, sched.s, sched.K
        n, B = sched.n_mb, inputs.shape[0]
        if B % n:
            raise ValueError(f"n_microbatches ({n}) must divide the batch "
                             f"size ({B})")
        self.n_mb = n
        self.in_mb = inputs.chunk(n)
        self.seg_mb = None if segment_ids is None else segment_ids.chunk(n)
        chunked = sched.seq_shard is not None
        if with_loss and denom is None:
            if chunked:
                valid = (inputs[:, 1:] >= 0).float()
                if segment_ids is not None:
                    valid = valid * valid_next_token_mask(segment_ids)
                denom = valid.sum().clamp_min(1.0)
            elif segment_ids is not None:
                denom = valid_next_token_mask(segment_ids).sum().clamp_min(1.0)
            else:
                denom = float(B * (inputs.shape[1] - 1))
        self.denom, self.with_loss = denom, with_loss
        self.scale = loss_scale
        # Backwards run per local chunk: the last one reduces its units.
        self.b_count = [0] * len(sched.chunks)
        cfg, decomp = sched.cfg, sched.decomp
        S = decomp.seq_len or inputs.shape[1] - (1 if chunked else 0)
        # What arrives: a zero-stride view with the activations' shape,
        # dtype and device, holding no memory.
        self.act = torch.empty((), dtype=cfg.dtype, device=inputs.device
                               ).expand(B // n, S, cfg.d_model)
        self.angles = sched.angles(S)
        self.ce = torch.zeros((), device=inputs.device)
        self.aux = torch.zeros((), device=inputs.device)
        self.outs: List[Optional[torch.Tensor]] = [None] * n

    # -- one chunk of one microbatch ------------------------------------

    def forward(self, j: int, i: int, inp: Optional[torch.Tensor]) -> _InFlight:
        """Local chunk ``j`` of microbatch ``i``: its input is the embed
        (global chunk 0, ``inp`` None) or the activation that arrived;
        the last chunk adds the head and the loss."""
        sched = self.sched
        seq = sched.seq_shard
        if inp is None:
            toks = self.in_mb[i] if seq is None else self.in_mb[i][:, :-1]
            x = sched.decomp.embed(toks, seq)
            # A DTensor here would be a layout the stages do not exchange
            # (a tensor-parallel embed hands on a replicated local tensor).
            if hasattr(x, "placements") or x.shape != self.act.shape \
                    or x.dtype != self.act.dtype:
                raise ValueError(f"the embed gives {type(x).__name__} "
                                 f"{tuple(x.shape)} {x.dtype}; the stages "
                                 f"exchange local tensors "
                                 f"{tuple(self.act.shape)} {self.act.dtype}")
        else:
            x = inp.detach().requires_grad_(torch.is_grad_enabled())
        y, aux = x, None
        segs = None if self.seg_mb is None else self.seg_mb[i]
        blk_segs = segs if segs is None or seq is None else segs[:, :-1]
        for blk in sched.chunks[j]:
            y = run_block(sched.cfg, blk, y, angles=self.angles,
                          causal=sched.decomp.causal, segment_ids=blk_segs)
            if sched.moe:
                a = blk.moe.aux.float()
                aux = a if aux is None else aux + a
        if aux is not None:
            self.aux += aux.detach()
        ce = None
        if j * self.pp + self.s == self.K - 1:
            if self.with_loss:
                ce = _mb_ce_sum(sched.decomp.head(y), self.in_mb[i], segs,
                                self.denom, chunked=seq is not None)
                self.ce += ce.detach()
            else:
                self.outs[i] = sched.decomp.head(y)
        return _InFlight(x, y, aux, ce, j)

    def backward(self, rec: _InFlight, dy: Optional[torch.Tensor]):
        """The backward of ``rec``'s graph: from its loss (the last chunk's
        seed) or from the cotangent ``dy`` that arrived; the router loss
        with weight 1 / n_microbatches.  Returns the cotangent of the
        chunk's input, None for the embed's (it flows into the embed's
        parameters)."""
        if self.sched.units is not None:
            self.b_count[rec.j] += 1
            last = self.b_count[rec.j] == self.n_mb
            for unit in self.sched.units[rec.j]:
                unit.set_requires_gradient_sync(last)
                unit.set_reshard_after_backward(last)
                unit.set_is_last_backward(last)
        outs, grads = [], []
        if rec.ce is not None:
            outs.append(rec.ce)
            grads.append(torch.full_like(rec.ce, self.scale))
        else:
            outs.append(rec.y)
            grads.append(dy)
        if rec.aux is not None:
            outs.append(rec.aux)
            grads.append(torch.full_like(rec.aux, 1.0 / self.n_mb))
        torch.autograd.backward(outs, grads)
        return rec.x.grad if rec.x.is_leaf else None

    def exchange(self, to_next, to_prev, recv_prev: bool, recv_next: bool,
                 wrap: bool = False):
        """This tick's transfers: (activation that arrived, cotangent that
        arrived)."""
        if not (to_next is not None or to_prev is not None or recv_prev
                or recv_next):
            return None, None
        return stage_exchange(
            self.sched.mesh, self.sched.axis, to_next=to_next,
            to_prev=to_prev, from_prev=self.act if recv_prev else None,
            from_next=self.act if recv_next else None, wrap=wrap)

    # -- the end of the step --------------------------------------------

    def finish(self, model: nn.Module) -> dict:
        """Sum the replicated parameters' gradients and the metrics over
        ``pp``: ``{"loss", "ce", "aux"}``, equal on every stage."""
        sched = self.sched
        if self.pp > 1:
            group = axis_group(sched.mesh, sched.axis)
            for p in light_params(model, sched.decomp):
                g = p.grad
                if g is None:
                    g = p.grad = torch.zeros_like(p)
                elif getattr(g, "placements", None) not in (
                        None, getattr(p, "placements", None)):
                    # A tensor-parallel lookup's gradient comes replicated:
                    # laid out as its parameter, every stage's line up.
                    g = p.grad = g.redistribute(p.device_mesh, p.placements)
                all_reduce_(_local(g), group)
            for t in (self.ce, self.aux):
                all_reduce_(t, group)
        aux = self.aux / self.n_mb
        return {"loss": self.ce + aux, "ce": self.ce.clone(), "aux": aux}


def light_params(model: nn.Module, decomp) -> List[nn.Parameter]:
    """The parameters outside the blocks (embed, final norm, head): every
    stage holds them (plain, or DTensors of the stage's layout)."""
    in_blocks = {id(p) for p in decomp.blocks.parameters()}
    return [p for p in model.parameters() if id(p) not in in_blocks]


def stage_params(model: nn.Module, decomp, mesh, axis_name: str = "pp",
                 n_chunks: int = 1) -> List[nn.Parameter]:
    """The parameters this stage updates: its own blocks' and the
    replicated ones (:func:`light_params`), this stage's first; each as
    the module holds it (a DTensor or FSDP2's shard on a stage laid out
    over other axes)."""
    pp, s = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    own = [p for ls in stage_layers(len(decomp.blocks), pp, s, n_chunks)
           for i in ls for p in decomp.blocks[i].parameters()]
    return own + light_params(model, decomp)


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------


def _gpipe_forward(st: _Step) -> dict:
    """The GPipe forward ticks: microbatch ``t - s`` on stage ``s`` at
    tick ``t``, the activation handed on at the tick's end."""
    pp, s, n = st.pp, st.s, st.n_mb
    inflight, act = {}, None
    for t in range(st.sched.T):
        y_send = None
        i = t - s
        if 0 <= i < n:
            rec = inflight[i] = st.forward(0, i, None if s == 0 else act)
            if s < pp - 1:
                y_send = rec.y
        act, _ = st.exchange(y_send, None, s > 0 and 0 <= t - s + 1 < n,
                             False)
    return inflight


def _gpipe_backward(st: _Step, inflight: dict) -> None:
    """The GPipe backward: the forward ticks in reverse, the cotangent
    handed back at each tick's end."""
    pp, s, n = st.pp, st.s, st.n_mb
    T, cot = st.sched.T, None
    for u in range(T):
        dx_send = None
        i = T - 1 - u - s
        if 0 <= i < n:
            dx = st.backward(inflight.pop(i), None if s == pp - 1 else cot)
            if s > 0:
                dx_send = dx
        _, cot = st.exchange(None, dx_send, False,
                             s < pp - 1 and 0 <= T - 2 - u - s < n)


def _walk_gpipe(st: _Step) -> None:
    _gpipe_backward(st, _gpipe_forward(st))


def pipelined_decoder_apply(cfg, model, inputs, mesh, *, decomp=None,
                            n_microbatches: int = 4, axis_name: str = "pp",
                            attn_fn=None, segment_ids=None,
                            return_aux: bool = False):
    """The model's forward with its blocks pipelined over ``axis_name``
    (GPipe): embed on the first stage, each stage's blocks, the head on
    the last; the logits ([B, S, vocab] or ViT's [B, n_classes]) are then
    sent to every stage, and ``return_aux`` adds the router loss (summed
    over the stages, averaged over the microbatches).  Call on every rank
    of the mesh.  The logits are a forward's only: gradients come from
    :func:`pipeline_train_gpipe`, which walks the backward schedule
    (autograd does not cross processes)."""
    sched = StageSchedule(cfg, decomp or default_decomposition(model), mesh,
                          n_microbatches=n_microbatches, axis_name=axis_name)
    with torch.no_grad(), _stage_attention(sched.chunks, attn_fn):
        st = _Step(sched, inputs, segment_ids, None, with_loss=False)
        _gpipe_forward(st)
        last = st.pp - 1
        logits = torch.cat(st.outs) if st.s == last else None
        if st.pp > 1:
            import torch.distributed as dist

            from .collectives import _staged

            group = axis_group(mesh, axis_name)
            src = dist.get_global_rank(group, last)
            shape = [None if logits is None else tuple(logits.shape)]
            dist.broadcast_object_list(shape, src=src, group=group)
            if logits is None:
                logits = torch.empty(shape[0], dtype=torch.float32,
                                     device=inputs.device)
            buf = logits.cpu() if _staged("broadcast", group, logits) \
                else logits
            dist.broadcast(buf, src=src, group=group)
            if buf is not logits:
                logits.copy_(buf)
            all_reduce_(st.aux, group)
        aux = st.aux / st.n_mb
    return (logits, aux) if return_aux else logits


def pipeline_train_gpipe(cfg, model, tokens, mesh, *, decomp=None,
                         n_microbatches: int = 4, axis_name: str = "pp",
                         attn_fn=None, segment_ids=None, denom=None) -> dict:
    """One GPipe step's gradients: every microbatch's forward through the
    stages, then every backward in reverse (each microbatch's graph
    kept until its backward: the schedule's memory price).  See
    :meth:`StageSchedule.train` for what it returns and where the
    gradients go."""
    return StageSchedule(
        cfg, decomp or default_decomposition(model), mesh,
        n_microbatches=n_microbatches, axis_name=axis_name,
    ).train(model, tokens, attn_fn=attn_fn, segment_ids=segment_ids,
            denom=denom)


# ---------------------------------------------------------------------------
# 1F1B
# ---------------------------------------------------------------------------


def _walk_1f1b(st: _Step) -> None:
    pp, s, n = st.pp, st.s, st.n_mb
    last = s == pp - 1
    lag = 2 * (pp - 1) - s  # stage s runs microbatch t - lag backward
    inflight, act, cot = {}, None, None
    for t, has_f, has_b in st.sched.ticks:
        y_send = dx_send = None
        f, b = t - s, t - lag
        do_b = has_b and 0 <= b < n
        if do_b and not last:
            # Before the tick's forward, so one graph fewer is alive.
            dx_send = st.backward(inflight.pop(b), cot)
        if has_f and 0 <= f < n:
            rec = inflight[f] = st.forward(0, f, None if s == 0 else act)
            if not last:
                y_send = rec.y
        if do_b and last:  # the seed: the loss of the forward just run
            dx = st.backward(inflight.pop(b), None)
            if s > 0:
                dx_send = dx
        # Stage s - 1 ran a forward this tick, stage s + 1 a backward.
        act, cot = st.exchange(y_send, dx_send,
                               s > 0 and 0 <= t - s + 1 < n,
                               s < pp - 1 and 0 <= t - lag + 1 < n)


def pipeline_train_1f1b(cfg, model, tokens, mesh, *, decomp=None,
                        n_microbatches: int = 4, axis_name: str = "pp",
                        attn_fn=None, segment_ids=None, denom=None) -> dict:
    """One flat 1F1B step's gradients (see :meth:`StageSchedule.train`
    for what it returns and where the gradients go).

    At tick ``t`` stage ``s`` runs the forward of microbatch ``t - s``
    and the backward of microbatch ``t - (2(pp - 1) - s)``: the last
    stage seeds each backward from the loss of the forward it just ran,
    the others take the cotangent that arrived from the next stage one
    tick earlier.  ``2(pp - 1) + n_microbatches`` ticks; stage ``s``
    holds at most ``2(pp - 1 - s)`` microbatches' graphs (one on the
    last stage)."""
    return StageSchedule(
        cfg, decomp or default_decomposition(model), mesh, schedule="1f1b",
        n_microbatches=n_microbatches, axis_name=axis_name,
    ).train(model, tokens, attn_fn=attn_fn, segment_ids=segment_ids,
            denom=denom)


# ---------------------------------------------------------------------------
# Interleaved (virtual-stage) 1F1B
# ---------------------------------------------------------------------------


def _walk_interleaved(st: _Step) -> None:
    sched = st.sched
    pp, d, K, tab = st.pp, st.s, st.K, sched.tab
    n_f, n_b, n_stash = sched.slots
    inbox_f, inbox_b = [None] * n_f, [None] * n_b
    stash: List[Optional[_InFlight]] = [None] * n_stash
    act = cot = None
    for t, has_f, has_b in sched.ticks:
        if tab["f_arr"][t] >= 0:
            inbox_f[tab["f_arr"][t]] = act
        if tab["b_arr"][t] >= 0:
            inbox_b[tab["b_arr"][t]] = cot
        y_send = dx_send = None
        do_b = has_b and tab["b_loc"][t] >= 0
        seed = do_b and tab["b_rd"][t] < 0  # the last chunk's own loss

        def backward():
            j, rd, slot = tab["b_loc"][t], tab["b_rd"][t], tab["stash_r"][t]
            rec, stash[slot] = stash[slot], None
            dx = st.backward(rec, None if rd < 0 else inbox_b[rd])
            return dx if j * pp + d > 0 else None

        if do_b and not seed:  # before the forward: one graph fewer alive
            dx_send = backward()
        if has_f and tab["f_loc"][t] >= 0:
            j, i, rd = tab["f_loc"][t], tab["f_mb"][t], tab["f_rd"][t]
            rec = st.forward(j, i, None if rd < 0 else inbox_f[rd])
            stash[tab["stash_w"][t]] = rec
            if j * pp + d < K - 1:
                y_send = rec.y
        if seed:
            dx_send = backward()
        nxt = t + 1 < sched.T
        act, cot = st.exchange(y_send, dx_send,
                               nxt and tab["f_arr"][t + 1] >= 0,
                               nxt and tab["b_arr"][t + 1] >= 0, wrap=True)


def pipeline_train_interleaved(cfg, model, tokens, mesh, *, decomp=None,
                               n_microbatches: int = 4, n_chunks: int = 2,
                               axis_name: str = "pp", attn_fn=None,
                               segment_ids=None, denom=None) -> dict:
    """One interleaved 1F1B step's gradients, ``n_chunks`` chunks per
    stage (see :meth:`StageSchedule.train` for what it returns).

    The ticks are the tables of :func:`.interleave.interleaved_schedule`:
    at tick ``t`` stage ``d`` first files what arrived (``f_arr`` /
    ``b_arr`` name the inbox slot), then runs the forward of local chunk
    ``f_loc`` on microbatch ``f_mb`` from the batch (``f_rd`` < 0, global
    chunk 0) or from inbox slot ``f_rd``, keeping its graph in stash slot
    ``stash_w``, then the backward of the graph in ``stash_r`` from its
    own loss (``b_rd`` < 0, the last chunk) or the cotangent in inbox
    slot ``b_rd``.  Activations go to stage ``(d + 1) % pp`` and
    cotangents to ``(d - 1) % pp``: the chunks form a ring."""
    return StageSchedule(
        cfg, decomp or default_decomposition(model), mesh,
        schedule="interleaved", n_microbatches=n_microbatches,
        n_chunks=n_chunks, axis_name=axis_name,
    ).train(model, tokens, attn_fn=attn_fn, segment_ids=segment_ids,
            denom=denom)


_WALKERS = {"gpipe": _walk_gpipe, "1f1b": _walk_1f1b,
            "interleaved": _walk_interleaved}

# The schedules ``make_train_step(pipeline_schedule=)`` takes.
FUSED = {"gpipe": pipeline_train_gpipe, "1f1b": pipeline_train_1f1b,
         "interleaved": pipeline_train_interleaved}
