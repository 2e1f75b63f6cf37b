"""Continuous-batching serve loop with deferred-init replica bring-up
(counterpart of ``torchdistx_tpu/serve/engine.py``).

One :class:`ServeEngine` is one replica: a fixed-lane decode batch
(``ServeConfig.max_batch``), a paged KV pool (:mod:`.kv_cache`), an
admission queue, and the serving programs (:mod:`.programs`), each a
CUDA graph captured once per replica shape on the card.  Each
:meth:`ServeEngine.step` interleaves:

1. **admission**: waiting requests are admitted while a batch lane and
   enough pages for their prompt are free; admission first consults the
   prefix cache (:mod:`.prefix`): the longest cached page-aligned
   prefix's pages are MAPPED into the new sequence's table
   (``alloc_shared``: no prefill FLOPs for the reused tokens) and only
   the suffix is prefilled.  A fresh prompt that fits one chunk runs
   through its ``prefill-<bucket>`` program at admission (the first
   generated token); a suffix behind a cached prefix, or a prompt longer
   than ``ServeConfig.prefill_chunk``, prefills **chunked**: one
   ``chunk-<bucket>`` call per engine tick, interleaved with decode,
   which is also how prompts longer than the largest bucket serve;
2. **decode**: ONE batched step for every fully-prefilled lane (ragged
   paged attention over each lane's own context length, the CUDA kernel
   on the GPU); mid-prefill lanes sit the step out;
3. **retirement**: lanes that hit EOS / their token budget / the
   context cap drop their page references *immediately* (a page frees
   when its last reference drops; shared prefix pages survive in the
   cache).  A finished prefill inserts its prompt's full pages into the
   prefix cache first, so later requests with the same preamble reuse
   them.

Shared pages are COPY-ON-WRITE: the only write a grower can aim at a
shared page (recomputing the last prompt position of a fully cached
page-aligned prompt) first duplicates the page through the ``cow``
program and remaps the grower's table.  Under pool pressure the engine
EVICTS cache leaves (LRU) before it preempts a running lane.

Decode is **speculative** by default (``TDX_SPEC_DECODE=0`` turns it
off): a host-side n-gram drafter (:class:`.prefix.NgramDrafter`) fed by
admitted prompts and each lane's own emitted tokens proposes up to
``spec_k`` tokens per lane, and one ``verify-<k>`` call scores all k+1
positions of every lane.  Greedy accept keeps the longest draft prefix
matching the verify argmaxes plus one corrected (or bonus) token;
:meth:`PagedKVCache.rollback` retracts the rejected positions.  The
verify program attends through the plain
:func:`~..ops.paged_attention.paged_prefill_attention`, which rounds
otherwise than the decode kernel: in float32 every token equals plain
decode's, in bfloat16 later tokens may differ.

When the pool cannot cover a lane's growth the engine **preempts** the
youngest lane (frees its pages, requeues the whole request at the front
of the queue; greedy decode regenerates it identically), the vLLM
recompute-preemption policy: page exhaustion costs latency, never a
wrong or dropped response.  The chaos ``serve`` site fires at the top of
every step (``raise:chunk`` deferred to the next prefill-chunk boundary,
``raise:verify`` to the next verify tick), and the ``lower`` / ``cache``
/ ``compile`` sites at each lazy program build, before its capture
opens; a retryable fault mid-batch (the chaos error, a CUDA out of
memory: ``cuda_bridge.materialize._retryable_errors``) requeues every
active lane the same way.  The
programs stay as they were captured: the next tick replays them, none is
rebuilt or run eagerly.  A sticky CUDA error is not retryable and
propagates.

**Replica bring-up** (:func:`spin_up_replica`) is the deferred-init story
end to end: the port's :func:`~..deferred_init.deferred_init` records the
model as fakes (zero storage), the keyed materializer
(:func:`~..cuda_bridge.materialize.materialize_module_cuda`) replays the
recording straight onto the device with its groups, retry ladder, init
dtype and ``materialize`` span, drawing every ``uniform_`` / ``normal_``
through the keyed kernel, so a replica's weights are the same function of
(seed, recording) as every other materialization and no global generator
changes; then :meth:`ServeEngine.warmup` captures every program.

Telemetry through the port's :mod:`..observe`, under the JAX package's
names: ``tdx.serve.*`` counters (``prefills``, ``prefill_tokens``,
``prefill_chunks``, ``prefix_hits``, ``prefix_tokens_reused``,
``cow_copies``, ``decode_steps``, ``requests_completed``,
``preempted_requests``), histograms (``ttft_s``, ``queue_wait_s``,
``token_latency_s``), gauges (``queue_depth``, ``active_requests``,
``tokens_per_s``, ``prefix_nodes``, ``prefix_hit_rate``, ``spec_*``),
``serve.step`` / ``serve.prefill`` / ``serve.spin_up`` spans and
``serve.fault`` / ``serve.preempt`` / ``serve.cancel`` instants.  Plain
integer attributes (``prefills``, ``decode_steps``, ``preemptions``,
``prefill_chunks``, ``cow_copies``, ``prefix_hits``,
``prefix_tokens_reused``, ``spec_*``) count the same events per engine.
Each request's timeline and latency split go to the request ledger
(:mod:`..observe.reqledger`); TTFT, per-token latency and queue wait
feed the engine's SLO windows (:class:`~..observe.slo.ServeSLO`,
published as ``tdx.serve.slo.*_p{50,95,99}_s``); a step fault or a
page-exhaustion preemption dumps the flight recorder
(``TDX_FLIGHT_DIR``); :func:`spin_up_replica` walks its health
component through ``spin_up`` -> ``warming`` -> ``serving``.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import chaos, observe
from .._device import resolve_device
from ..cuda_bridge.materialize import (
    _retryable_errors,
    bind_values,
    materialize_module_cuda,
)
from ..deferred_init import deferred_init
from ..models import PRESETS, TransformerConfig
from ..observe import reqledger
from ..observe import slo as _slo
from ..ops import _build
from ..ops.paged_attention import build_kernel
from ..registry.scheduler import path_sources
from .kv_cache import OutOfPages, PagedKVCache, init_pools
from .prefix import NgramDrafter, PrefixCache
from .programs import (
    ResolvedServeConfig,
    ServeConfig,
    ServeProgram,
    build_serving_functions,
    make_model,
    model_family,
    serve_program_specs,
)

__all__ = ["Request", "ServeEngine", "oracle_generate", "spin_up_replica"]

_log = logging.getLogger("torchdistx_tpu_torch")


@dataclass
class Request:
    """One generation request.  ``arrival_step`` simulates staggered
    arrivals (a request is not admissible before that engine step).

    ``deadline_s`` is an END-TO-END deadline, measured from first
    submission: past it the request is expired while queued AND
    cancelled mid-decode (its lane's pages freed immediately,
    ``on_cancel`` told with the tokens so far).  ``priority`` is for a
    fleet's load shedding; the engine treats priorities equally."""

    rid: str
    tokens: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    arrival_step: int = 0
    deadline_s: Optional[float] = None
    priority: int = 1


@dataclass
class _Lane:
    """One active batch lane."""

    req: Request
    seq_id: int
    slot: int
    length: int = 0                # tokens currently in the KV cache
    generated: List[int] = field(default_factory=list)
    admitted_step: int = 0
    prefilling: bool = False       # mid-chunked-prefill; decode skips it
    spec_k: int = 0                # current draft length cap (adaptive)


class ServeEngine:
    """One serving replica over ``model`` (the family's ``nn.Module``,
    materialized on ``device``); see the module docstring for the loop.

    On the card each program is captured as a CUDA graph at its first
    use (:meth:`warmup` captures them all); ``cuda_graphs=False`` runs
    them eagerly instead.  A capture or replay that fails raises; a
    retryable fault in a step requeues the step's lanes.  ``slo_name``
    names the engine's SLO windows (a fleet gives each replica its
    own)."""

    def __init__(
        self,
        family: str,
        cfg: TransformerConfig,
        model: torch.nn.Module,
        *,
        serve_cfg: Optional[ServeConfig] = None,
        device="cuda",
        cuda_graphs: bool = True,
        on_token: Optional[Callable[[str, int], None]] = None,
        on_complete: Optional[Callable[[str, List[int], np.ndarray],
                                       None]] = None,
        on_cancel: Optional[Callable[[str, List[int], bool], None]] = None,
        slo_name: str = "serve",
    ):
        self.device = resolve_device(device)
        self.family = family
        self.cfg = cfg
        self.model = model
        # Weight-version stamp of the parameters served (install_params).
        self.weight_version: Optional[str] = None
        self.scfg: ResolvedServeConfig = (serve_cfg or ServeConfig()).resolve(cfg)
        self.on_token = on_token
        self.on_complete = on_complete
        # (rid, tokens_so_far, was_active): was_active tells a cancelled
        # LANE (pages freed mid-decode) from an expired waiting request.
        self.on_cancel = on_cancel
        self.cancelled: Dict[str, List[int]] = {}  # rid -> tokens at cancel
        self._draining = False
        self.kv = PagedKVCache(self.scfg.kv_config(cfg))
        self.prefix = PrefixCache(self.kv)
        self.k_pages, self.v_pages = init_pools(
            self.scfg.kv_config(cfg), cfg.dtype, self.device)
        self._fns = build_serving_functions(model)
        self._specs = {s.name: s for s in serve_program_specs(self.scfg)}
        self._programs: Dict[str, ServeProgram] = {}
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda"
        # One memory pool for every graph of the engine (programs never
        # run concurrently, so they may share intermediates) and one
        # side stream for the captures.
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.cuda_graphs else None)
        self._capture_stream = (torch.cuda.Stream(self.device)
                                if self.cuda_graphs else None)
        self.capture_seconds = 0.0
        # Chunk-boundary chaos faults (``serve@N=raise:chunk``) are
        # deferred here by step() and fired BETWEEN prefill chunks; the
        # same for ``raise:verify``, fired right before the next verify
        # tick.
        self._pending_chunk_faults: List[chaos.Fault] = []
        self._pending_verify_faults: List[chaos.Fault] = []
        self._drafter: Optional[NgramDrafter] = (
            NgramDrafter() if self.scfg.spec_decode else None)
        self.spec_drafted = 0       # draft tokens sent to verify
        self.spec_accepted = 0      # draft tokens accepted
        self.spec_verify_ticks = 0  # batched verify calls
        self.waiting: deque[Request] = deque()
        self.active: Dict[int, _Lane] = {}      # slot -> lane
        self._delivered: Dict[str, int] = {}    # rid -> tokens streamed
        self.results: Dict[str, List[int]] = {}
        self.final_logits: Dict[str, np.ndarray] = {}
        self._step_no = 0
        self._next_seq = 1
        self._t0: Optional[float] = None
        self._tokens_out = 0
        # Set by spin_up_replica: record + materialize seconds, and each
        # kernel library's outcome ("hit": nothing built, "miss": nvcc).
        self.bring_up_seconds: Optional[float] = None
        self.bring_up_outcomes: Dict[str, str] = {}
        self.prefills = 0
        self.decode_steps = 0           # plain and verify ticks
        self.preemptions = 0
        self.prefill_chunks = 0
        self.cow_copies = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self._retryable = _retryable_errors()
        self.slo = _slo.ServeSLO(name=slo_name)
        # Live percentile export; no-op unless TDX_METRICS_EXPORT_S > 0
        # (the first engine's SLO wins the exporter slot).
        _slo.ensure_exporter(self.slo)
        # Handle resolved once: the decode tick is the hot path.
        self._tok_hist = observe.histogram(
            "tdx.serve.token_latency_s",
            buckets=(0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0),
        )

    # -- programs -----------------------------------------------------------

    def _program(self, name: str) -> ServeProgram:
        """The program ``name``, built (and on the card captured) at its
        first use.  The chaos ``lower`` / ``cache`` / ``compile`` sites
        (group 1, as the JAX engine's lazy compile takes them) fire
        before the build, never inside a capture."""
        prog = self._programs.get(name)
        if prog is None:
            if self.k_pages is None:
                raise RuntimeError("release_kv() dropped this engine's pool")
            for site in ("lower", "cache", "compile"):
                chaos.maybe_inject(site, 1, path=str(_build.cache_dir()))
            spec = self._specs[name]
            prog = ServeProgram(spec, self._fns[spec.kind],
                                (self.k_pages, self.v_pages))
            if self.cuda_graphs:
                t = time.perf_counter()
                prog.capture(self._graph_pool, self._capture_stream)
                self.capture_seconds += time.perf_counter() - t
            self._programs[name] = prog
        return prog

    def warmup(self) -> Dict[str, float]:
        """Build, and on the card capture, every program of the replica
        shape now (the JAX engine compiles them all here), so the first
        request pays none; returns name -> seconds."""
        if self.device.type == "cuda":
            build_kernel()
        seconds: Dict[str, float] = {}
        for name in self._specs:
            if name not in self._programs:
                t = time.perf_counter()
                self._program(name)
                seconds[name] = time.perf_counter() - t
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return seconds

    def graph_pool_bytes(self) -> int:
        """Device bytes the captured graphs' shared memory pool holds."""
        if self._graph_pool is None:
            return 0
        pool = tuple(self._graph_pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)

    # -- public API ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        need = self.kv.cfg.pages_for(len(req.tokens) + 1)
        if need > self.kv.cfg.usable_pages:
            raise ValueError(
                f"request {req.rid}: prompt of {len(req.tokens)} tokens "
                f"needs {need} pages but the pool only has "
                f"{self.kv.cfg.usable_pages}"
            )
        if len(req.tokens) + req.max_new_tokens > self.scfg.max_context:
            raise ValueError(
                f"request {req.rid}: prompt + budget "
                f"({len(req.tokens)} + {req.max_new_tokens}) exceeds "
                f"max_context={self.scfg.max_context}"
            )
        if not req.tokens:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new_tokens < 1:
            # A zero budget would still emit prefill's first token,
            # diverging from the oracle (which generates nothing).
            raise ValueError(
                f"request {req.rid}: max_new_tokens must be >= 1, got "
                f"{req.max_new_tokens}"
            )
        req._submit_t = time.perf_counter()
        # The deadline is END-TO-END: anchored once, at the first submit;
        # a requeued request keeps its original deadline.
        if req.deadline_s is not None and not hasattr(req, "_deadline_t"):
            req._deadline_t = req._submit_t + req.deadline_s
        # Ledger anchor: the first enqueue wins (a requeue hop only logs a
        # dispatch).
        reqledger.on_enqueue(req.rid, priority=req.priority,
                             deadline_s=req.deadline_s,
                             n_prompt=len(req.tokens))
        reqledger.on_event(req.rid, "dispatch", replica=self.slo.name)
        self.waiting.append(req)
        self._gauges()

    def run(self, requests: Sequence[Request] = (), *,
            max_steps: int = 100_000) -> Dict[str, List[int]]:
        """Submit ``requests`` and drive the loop until every request
        completed (or ``max_steps``); returns the replica's cumulative
        rid -> generated-tokens map."""
        for r in requests:
            self.submit(r)
        if (self._drafter is not None and not len(self._drafter)
                and len(self.prefix)):
            # A fresh drafter on a warm radix tree seeds itself from the
            # preambles the tree already proved hot.
            self._drafter.warm_from_prefix(self.prefix)
        if self._t0 is None:
            self._t0 = time.perf_counter()
        start = self._step_no
        while (self.waiting or self.active) and (
                self._step_no - start) < max_steps:
            self.step()
        if self.waiting or self.active:
            raise RuntimeError(
                f"serve loop hit max_steps={max_steps} with "
                f"{len(self.waiting)} waiting / {len(self.active)} active"
            )
        return dict(self.results)

    def drain(self, *, max_steps: int = 100_000) -> List[Request]:
        """Scale-down hook: finish every IN-FLIGHT lane (admission is
        suspended), then hand back whatever was still waiting, and drop
        the prefix cache's references so every refcount returns to 0."""
        self._draining = True
        try:
            start = self._step_no
            while self.active and (self._step_no - start) < max_steps:
                self.step()
            if self.active:
                raise RuntimeError(
                    f"drain hit max_steps={max_steps} with "
                    f"{len(self.active)} lanes still active"
                )
            leftover = list(self.waiting)
            self.waiting.clear()
            self.prefix.clear()
            return leftover
        finally:
            self._draining = False

    def requeue_active(self, *, reason: str = "fault") -> int:
        """Preempt every active lane back into ``waiting`` (recompute
        policy); returns the number of lanes requeued."""
        n = len(self.active)
        for slot in list(self.active):
            self._preempt(slot, reason=reason)
        return n

    def cancel(self, rid: str, *,
               reason: str = "cancel") -> Optional[List[int]]:
        """Cancel one request: an active lane is evicted and its pages
        freed IMMEDIATELY; a waiting request is removed.  Returns the
        tokens generated so far (``[]`` if never admitted), or ``None``
        if the engine doesn't hold ``rid``.  Each lane's decode reads only
        its own row and page table, so the survivors' tokens cannot
        change.  Does not call ``on_cancel`` (the caller knows)."""
        for slot, lane in list(self.active.items()):
            if lane.req.rid != rid:
                continue
            self.active.pop(slot)
            self.kv.free(lane.seq_id)
            self._delivered.pop(rid, None)
            self.cancelled[rid] = list(lane.generated)
            observe.instant("serve.cancel", category="serve", rid=rid,
                            reason=reason, step=self._step_no,
                            tokens=len(lane.generated),
                            flow=reqledger.flow_id(rid))
            reqledger.on_abort(rid, replica=self.slo.name, reason=reason)
            self._gauges()
            return list(lane.generated)
        for req in list(self.waiting):
            if req.rid == rid:
                self.waiting.remove(req)
                self.cancelled[rid] = []
                observe.instant("serve.cancel", category="serve", rid=rid,
                                reason=reason, step=self._step_no, tokens=0,
                                flow=reqledger.flow_id(rid))
                reqledger.on_abort(rid, replica=self.slo.name, reason=reason)
                self._gauges()
                return []
        return None

    def _expire_deadlines(self) -> None:
        """Cancel every lane and waiting request past its end-to-end
        deadline, freeing lane pages at once, and tell ``on_cancel``."""
        now = time.perf_counter()
        doomed = [
            lane.req.rid for lane in self.active.values()
            if getattr(lane.req, "_deadline_t", None) is not None
            and now > lane.req._deadline_t
        ] + [
            req.rid for req in self.waiting
            if getattr(req, "_deadline_t", None) is not None
            and now > req._deadline_t
        ]
        for rid in doomed:
            was_active = any(lane.req.rid == rid
                             for lane in self.active.values())
            toks = self.cancel(rid, reason="deadline")
            if toks is None:  # pragma: no cover — rid just enumerated
                continue
            # Terminal for the ledger: spent prefill/decode time becomes
            # guardrail time (the cancel above ended the attempt).
            reqledger.on_reject(rid, reason="deadline", tokens=len(toks))
            if self.on_cancel is not None:
                self.on_cancel(rid, toks, was_active)

    def install_params(self, params: Mapping[str, torch.Tensor], *,
                       version: Optional[str] = None) -> None:
        """Serve other weights (a state dict of the model): copied INTO
        the existing parameter storages, which the captured graphs read,
        so no program is recaptured.  Legal only while no lane is active;
        clears the prefix cache, whose K/V the old weights computed."""
        if self.active:
            raise RuntimeError(
                f"install_params with {len(self.active)} active lanes; "
                f"drain first"
            )
        self.prefix.clear()
        self.model.load_state_dict(params)
        self.weight_version = version

    def release_kv(self) -> None:
        """Free the replica's KV pool and its programs' graphs (the end
        of a drain).  The engine can still report results; it can no
        longer serve."""
        if self.active:
            raise RuntimeError(
                f"release_kv with {len(self.active)} active lanes; "
                f"drain first"
            )
        self.drop_graphs()
        self.k_pages = self.v_pages = None
        self.kv = PagedKVCache(self.scfg.kv_config(self.cfg))
        self.prefix = PrefixCache(self.kv)
        self._gauges()

    def drop_graphs(self) -> None:
        """Destroy the programs' captured graphs now, on this thread (a
        fleet calls it under its device lock): a graph destroyed while
        another thread captures in global mode invalidates that capture,
        and one left to die with its engine dies wherever the last
        reference goes.  The engine can no longer serve."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for prog in self._programs.values():
            if prog.graph is not None:
                prog.graph.reset()
        self._programs.clear()
        self._graph_pool = None

    def outstanding_tokens(self) -> int:
        """Remaining token budget across waiting + active requests: the
        load signal a fleet router balances on.  Safe to call from
        another thread (a stale snapshot, never a crash)."""
        for _ in range(8):
            try:
                waiting = list(self.waiting)
                lanes = list(self.active.values())
            except RuntimeError:  # resized mid-iteration; retry
                continue
            return (
                sum(r.max_new_tokens for r in waiting)
                + sum(max(1, lane.req.max_new_tokens - len(lane.generated))
                      for lane in lanes)
            )
        return len(self.waiting) + len(self.active)  # coarse fallback

    def step(self) -> None:
        """One engine tick: chaos site -> deadlines -> chunked-prefill
        advance -> admission (+prefill) -> one batched decode step ->
        retirement.  A retryable fault mid-batch requeues every active
        lane (recompute preemption); any other error propagates."""
        self._step_no += 1
        if self._t0 is None:
            self._t0 = time.perf_counter()
        with observe.span(
            "serve.step", category="serve", step=self._step_no,
            active=len(self.active), waiting=len(self.waiting),
        ):
            try:
                self._take_serve_faults()
                self._expire_deadlines()
                self._advance_prefill()
                self._admit()
                if self._pending_chunk_faults:
                    # A chunk fault due on a step with no chunk boundary
                    # to defer to still fires (a plan's fault is never
                    # silently dropped).
                    chaos.execute(self._pending_chunk_faults.pop(0))
                self._decode_step()
                if self._pending_verify_faults:
                    # Same for a verify fault on a step with no verify
                    # tick (spec off, no decodable lanes).
                    chaos.execute(self._pending_verify_faults.pop(0))
            except self._retryable as e:
                _log.warning(
                    "serve: step %d fault (%s: %s); requeueing %d active "
                    "requests", self._step_no, type(e).__name__,
                    str(e)[:120], len(self.active),
                )
                observe.instant("serve.fault", category="serve",
                                step=self._step_no, error=type(e).__name__)
                # Persist the ring before the requeue rewrites the
                # engine's state (no-op without TDX_FLIGHT_DIR).
                observe.flight_dump(
                    "serve_fault", step=self._step_no,
                    error=f"{type(e).__name__}: {e}"[:300],
                    active=len(self.active), waiting=len(self.waiting),
                )
                for slot in list(self.active):
                    self._preempt(slot, reason="fault")
        self._gauges()

    # -- admission / prefill ------------------------------------------------

    def _take_serve_faults(self) -> None:
        """The serve chaos site, taken by hand instead of through
        :func:`chaos.maybe_inject`: ``raise:chunk`` faults are DEFERRED
        to the next prefill-chunk boundary, ``raise:verify`` to the next
        speculative verify tick (after drafts were taken and capacity
        extended); everything else executes now."""
        plan = chaos.active_plan()
        if plan is None:
            return
        for fault in plan.take("serve", self._step_no):
            if fault.kind == "raise" and fault.arg == "chunk":
                self._pending_chunk_faults.append(fault)
            elif fault.kind == "raise" and fault.arg == "verify":
                self._pending_verify_faults.append(fault)
            else:
                chaos.execute(fault)

    def _free_slot(self) -> Optional[int]:
        for s in range(self.scfg.max_batch):
            if s not in self.active:
                return s
        return None

    def _admit(self) -> None:
        if self._draining:
            return  # a draining replica finishes lanes, admits nothing
        while self.waiting:
            req = self.waiting[0]
            if req.arrival_step > self._step_no:
                break
            slot = self._free_slot()
            if slot is None:
                break
            shared = (self.prefix.match(req.tokens)
                      if self.scfg.prefix_cache else [])
            need = self.kv.cfg.pages_for(len(req.tokens)) - len(shared)
            # Cache leaves are cheaper to give up than running lanes;
            # evict LRU ones (never this request's own matched prefix)
            # until the suffix fits.
            while (need > self.kv.free_pages
                   and self.prefix.evict(exclude=set(shared))):
                pass
            if need > self.kv.free_pages:
                break  # retirement will free pages; keep FIFO order
            self.waiting.popleft()
            self._prefill(req, slot, shared)

    def _chunk_cap(self) -> int:
        return self.scfg.prefill_chunk or self.scfg.prefill_buckets[-1]

    def _prefill(self, req: Request, slot: int,
                 shared: Sequence[int]) -> None:
        """Admit one request: map its cached prefix pages (``shared``),
        then prefill the suffix: in one shot through ``prefill-<bucket>``
        when it is a fresh prompt that fits one chunk, else chunk by
        chunk across engine ticks (``_advance_prefill``)."""
        L = len(req.tokens)
        # Queue wait = submit -> lane and pages granted; a requeued
        # request measures from its ORIGINAL submit.
        sub = getattr(req, "_submit_t", None)
        if sub is not None:
            wait = time.perf_counter() - sub
            observe.histogram("tdx.serve.queue_wait_s").observe(wait)
            self.slo.observe_queue_wait(wait)
        sid = self._next_seq
        self._next_seq += 1
        if shared:
            self.kv.alloc_shared(sid, shared, L)
        else:
            self.kv.alloc(sid, L)
        # Reused tokens never re-prefill, but the LAST prompt position
        # must run (its logits are the first generated token): a fully
        # cached prompt recomputes exactly one token, and that write is
        # the one copy-on-write case (it lands in a shared page).
        start = min(len(shared) * self.scfg.page_size, L - 1)
        if start > 0:
            self.prefix_hits += 1
            self.prefix_tokens_reused += start
            observe.counter("tdx.serve.prefix_hits").inc()
            observe.counter("tdx.serve.prefix_tokens_reused").inc(start)
        reqledger.on_admit(req.rid, replica=self.slo.name,
                           prefix_tokens=start)
        lane = _Lane(req=req, seq_id=sid, slot=slot, length=start,
                     admitted_step=self._step_no, prefilling=True,
                     spec_k=self.scfg.spec_k)
        if self._drafter is not None:
            self._drafter.observe(req.tokens)
        try:
            with observe.span("serve.prefill", category="serve", rid=req.rid,
                              tokens=L, reused=start):
                if (not shared and L <= self.scfg.prefill_buckets[-1]
                        and L <= self._chunk_cap()):
                    bucket = self.scfg.bucket_for(L)
                    toks = np.zeros((1, bucket), np.int32)
                    toks[0, :L] = req.tokens
                    row = self.kv.table_rows([sid],
                                             self.scfg.max_pages_per_seq)
                    logits = self._program(f"prefill-{bucket}")(
                        toks, np.asarray([L], np.int32), row)
                    logits = logits.float().cpu().numpy()
                    lane.length = L
                    reqledger.on_event(req.rid, "prefill", bucket=bucket,
                                       n=L, replica=self.slo.name)
                else:
                    logits = self._run_chunk(lane)  # None: more chunks
        except BaseException:
            # The request left the queue and holds pages but is not in
            # `active`, where step()'s fault handler cannot see it: undo
            # both, so a failed program (a device fault, a chaos fault at
            # the lazy build) costs latency, never leaked pages or a lost
            # request, then let the error through.
            self.kv.free(sid)
            self.waiting.appendleft(req)
            self.preemptions += 1
            observe.counter("tdx.serve.preempted_requests").inc()
            observe.instant("serve.preempt", category="serve",
                            rid=req.rid, reason="prefill_fault",
                            step=self._step_no,
                            flow=reqledger.flow_id(req.rid))
            reqledger.on_abort(req.rid, replica=self.slo.name,
                               reason="prefill_fault")
            raise
        self.active[slot] = lane
        self.prefills += 1
        observe.counter("tdx.serve.prefills").inc()
        observe.counter("tdx.serve.prefill_tokens").inc(L - start)
        if logits is not None:
            self._finish_prefill(lane, logits)

    def _run_chunk(self, lane: _Lane) -> Optional[np.ndarray]:
        """One prefill chunk for ``lane``: copy-on-write its first page
        if shared, run the bucketed chunk program over the next
        ``prefill_chunk`` prompt tokens.  Returns the final position's
        logits when the prompt is complete, else ``None``."""
        req = lane.req
        L = len(req.tokens)
        s = lane.length
        n = min(L - s, self._chunk_cap())
        bucket = self.scfg.bucket_for(n)
        # Only a chunk's FIRST page can be shared (later pages were
        # written by this sequence's earlier chunks); cow_page does
        # nothing at refcount 1, so this is unconditional.
        self._cow_for(lane, s // self.scfg.page_size)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = req.tokens[s:s + n]
        row = self.kv.table_rows([lane.seq_id], self.scfg.max_pages_per_seq)
        logits = self._program(f"chunk-{bucket}")(
            toks, np.asarray([s], np.int32), np.asarray([s + n], np.int32),
            row)
        lane.length = s + n
        self.prefill_chunks += 1
        observe.counter("tdx.serve.prefill_chunks").inc()
        reqledger.on_chunk(req.rid, bucket=bucket, n_tokens=n,
                           replica=self.slo.name)
        if lane.length >= L:
            return logits.float().cpu().numpy()
        return None

    def _cow_for(self, lane: _Lane, page_index: int) -> None:
        """Give ``lane`` a private copy of its ``page_index``-th page if
        that page is shared, cloning the contents through the ``cow``
        program.  Under pool exhaustion: evict cache leaves, then preempt
        the youngest OTHER lane; each drops references, so the loop ends
        (at worst the refcount falls to 1 and no copy is needed)."""
        while True:
            try:
                moved = self.kv.cow_page(lane.seq_id, page_index)
                break
            except OutOfPages:
                if self.prefix.evict():
                    continue
                victim = self._youngest_other(lane)
                if victim is not None:
                    self._preempt(victim, reason="pages")
                    continue
                raise  # pragma: no cover — ref > 1 implies an evictee
        if moved is not None:
            src, dst = moved
            self._program("cow")(np.asarray([src], np.int32),
                                 np.asarray([dst], np.int32))
            self.cow_copies += 1
            observe.counter("tdx.serve.cow_copies").inc()
            reqledger.on_cow(lane.req.rid, replica=self.slo.name)

    def _youngest_other(self, lane: _Lane) -> Optional[int]:
        others = [s for s in self.active if s != lane.slot]
        if not others:
            return None
        return max(others, key=lambda s: (self.active[s].admitted_step, s))

    def _advance_prefill(self) -> None:
        """One chunk for every mid-prefill lane: chunked prefill
        interleaves with decode at engine-tick granularity, so a long
        prompt cannot lock the batch out for its whole prefill.  A
        deferred ``raise:chunk`` chaos fault fires HERE, between
        chunks."""
        for slot in sorted(self.active):
            lane = self.active.get(slot)
            if lane is None or not lane.prefilling:
                continue
            if self._pending_chunk_faults:
                chaos.execute(self._pending_chunk_faults.pop(0))
            logits = self._run_chunk(lane)
            if logits is not None:
                self._finish_prefill(lane, logits)

    def _finish_prefill(self, lane: _Lane, logits: np.ndarray) -> None:
        """The prompt's K/V is fully written: publish its full pages to
        the prefix cache (BEFORE the first emit: retirement may free the
        sequence at once, and the cache's references keep the pages
        alive), then deliver the first token."""
        lane.prefilling = False
        req = lane.req
        nfull = len(req.tokens) // self.scfg.page_size
        if nfull and self.scfg.prefix_cache:
            self.prefix.insert(
                req.tokens[:nfull * self.scfg.page_size],
                self.kv.page_ids(lane.seq_id)[:nfull],
            )
        # A re-prefill after preemption replays a first token the client
        # already received: no TTFT sample for it.
        first_delivery = self._delivered.get(req.rid, 0) == 0
        self._emit(lane, int(np.argmax(logits)), logits)
        sub = getattr(req, "_submit_t", None)
        if first_delivery and sub is not None:
            ttft = time.perf_counter() - sub
            observe.histogram("tdx.serve.ttft_s").observe(ttft)
            self.slo.observe_ttft(ttft)

    # -- decode ---------------------------------------------------------------

    def _decodable(self) -> List[int]:
        return [s for s in sorted(self.active)
                if not self.active[s].prefilling]

    def _oldest_first(self) -> List[int]:
        return sorted(self.active,
                      key=lambda s: (self.active[s].admitted_step, s))

    def _youngest(self) -> int:
        return max(self.active,
                   key=lambda s: (self.active[s].admitted_step, s))

    def _ensure_capacity(self) -> None:
        """Every decoding lane must own a page slot for its next token;
        evict prefix-cache leaves first, then preempt the youngest lanes,
        until the pool covers the rest."""
        for slot in self._oldest_first():
            lane = self.active.get(slot)
            if lane is None or lane.prefilling:
                continue
            while True:
                try:
                    self.kv.extend(lane.seq_id, lane.length + 1)
                    break
                except OutOfPages:
                    if self.prefix.evict():
                        continue
                    victim = self._youngest()
                    self._preempt(victim, reason="pages")
                    if victim == slot:
                        break  # this lane itself was the youngest

    def _decode_step(self) -> None:
        if not self._decodable():
            return
        if self._drafter is not None:
            self._spec_decode_step()
        else:
            self._plain_decode_step()

    def _step_operands(self, slots: List[int], width: int):
        """(tokens [B, width], starts [B], page table [B, maxp]) of a
        decode or verify tick: each lane's last token at column 0, idle
        lanes all zeros (position 0, null table row)."""
        B = self.scfg.max_batch
        maxp = self.scfg.max_pages_per_seq
        tokens = np.zeros((B, width), np.int32)
        start = np.zeros((B,), np.int32)
        table = np.zeros((B, maxp), np.int32)
        table[slots] = self.kv.table_rows(
            [self.active[s].seq_id for s in slots], maxp)
        for slot in slots:
            lane = self.active[slot]
            tokens[slot, 0] = (lane.generated[-1] if lane.generated
                               else lane.req.tokens[-1])
            start[slot] = lane.length
        return tokens, start, table

    def _plain_decode_step(self) -> None:
        self._ensure_capacity()
        slots = self._decodable()
        if not slots:
            return
        t_step = time.perf_counter()
        tokens, positions, table = self._step_operands(slots, 1)
        logits = self._program("decode")(tokens[:, 0], positions, table)
        logits = logits.float().cpu().numpy()
        # Every lane's next token took this step's wall time: one sample
        # per lane.
        dt = time.perf_counter() - t_step
        n_lanes = len(slots)
        self._tok_hist.observe(dt, n=n_lanes)
        self.slo.observe_token_latency(dt, n=n_lanes)
        if reqledger.enabled():
            # One coalesced timeline event per decode stretch per lane;
            # the gate is hoisted so the off path costs one check a tick.
            for slot in slots:
                reqledger.on_decode(self.active[slot].req.rid,
                                    n_lanes=n_lanes, replica=self.slo.name)
        for slot in slots:
            lane = self.active.get(slot)
            if lane is None:  # pragma: no cover — nothing retires mid-loop
                continue
            lane.length += 1
            self._emit(lane, int(np.argmax(logits[slot])), logits[slot])
        self.decode_steps += 1
        observe.counter("tdx.serve.decode_steps").inc()

    # -- speculative decode -------------------------------------------------

    def _drafts_for(self, slots: List[int]) -> Dict[int, List[int]]:
        """Per-slot draft proposals, clamped so no draft outruns the
        request's token budget or the context cap."""
        drafts: Dict[int, List[int]] = {}
        for slot in slots:
            lane = self.active[slot]
            req = lane.req
            k = min(
                lane.spec_k,
                req.max_new_tokens - len(lane.generated) - 1,
                self.scfg.max_context - lane.length - 1,
            )
            drafts[slot] = (self._drafter.draft(req.tokens + lane.generated, k)
                            if k > 0 else [])
        return drafts

    def _ensure_spec_capacity(self, drafts: Dict[int, List[int]]) -> None:
        """Like :meth:`_ensure_capacity` but covering each lane's draft
        window too.  Under pool pressure a lane's OWN draft is shed
        before anyone is preempted: speculation is optional, lanes are
        not."""
        for slot in self._oldest_first():
            lane = self.active.get(slot)
            if lane is None or lane.prefilling:
                continue
            while True:
                try:
                    self.kv.extend(
                        lane.seq_id,
                        lane.length + len(drafts.get(slot, ())) + 1)
                    break
                except OutOfPages:
                    if self.prefix.evict():
                        continue
                    if drafts.get(slot):
                        drafts[slot] = []
                        continue
                    victim = self._youngest()
                    self._preempt(victim, reason="pages")
                    if victim == slot:
                        break  # this lane itself was the youngest

    def _spec_decode_step(self) -> None:
        """Draft -> one batched verify tick -> greedy accept + rollback.
        ``verify-<k>`` scores all k+1 positions of every lane in ONE call
        (a zero-draft lane occupies a width-1 ragged row); greedy accept
        takes the longest draft prefix matching the program's own
        argmaxes plus one corrected (or bonus) token, then KV rollback
        retracts the rejected positions."""
        drafts = self._drafts_for(self._decodable())
        if not any(drafts.values()) and not self._pending_verify_faults:
            # Nothing proposed (cold drafter): plain decode is the same
            # tick at width 1, without the rollback.
            self._plain_decode_step()
            return
        self._ensure_spec_capacity(drafts)
        # COW guard for the write at position ``length`` (nothing at
        # refcount 1), BEFORE the page tables are read: a cow under pool
        # pressure can preempt a lane, and a stale table row would let
        # the verify tick write a dead lane's K/V into a reused page.
        for slot in self._decodable():
            lane = self.active.get(slot)
            if lane is not None:
                self._cow_for(lane, lane.length // self.scfg.page_size)
        slots = self._decodable()
        if not slots:
            return
        if self._pending_verify_faults:
            # The deferred ``raise:verify`` chaos fault: after drafting
            # and capacity growth, before the verify call; step()'s
            # handler requeues lanes whose pages already cover draft
            # positions, and frees them all.
            chaos.execute(self._pending_verify_faults.pop(0))
        t_step = time.perf_counter()
        kb = self.scfg.spec_bucket_for(
            max(len(drafts.get(s, ())) for s in slots) or 1)
        tokens, start, table = self._step_operands(slots, kb + 1)
        end = np.zeros_like(start)
        for slot in slots:
            d = drafts.get(slot, ())
            tokens[slot, 1:1 + len(d)] = d
            end[slot] = start[slot] + len(d) + 1
        logits = self._program(f"verify-{kb}")(tokens, start, end, table)
        logits = logits.float().cpu().numpy()
        dt = time.perf_counter() - t_step
        n_lanes = len(slots)
        ledger_on = reqledger.enabled()
        total_emitted = 0
        for slot in slots:
            lane = self.active.get(slot)
            if lane is None:  # pragma: no cover — nothing retires mid-loop
                continue
            d = drafts.get(slot, [])
            rows = logits[slot]  # [kb+1, vocab]
            accepted = 0
            emitted: List[int] = []
            for i, guess in enumerate(d):
                t = int(np.argmax(rows[i]))
                emitted.append(t)
                if t != guess:
                    break  # first wrong draft; t is the corrected token
                accepted += 1
            if accepted == len(d):
                # Clean sweep: the last verified position yields one
                # bonus token.
                emitted.append(int(np.argmax(rows[len(d)])))
            self.spec_drafted += len(d)
            self.spec_accepted += accepted
            if d:
                # Per-lane k adaptation: grow back toward the cap on a
                # clean sweep, back off when under half survived.
                if accepted == len(d):
                    lane.spec_k = min(lane.spec_k + 1, self.scfg.spec_k)
                elif accepted * 2 < len(d):
                    lane.spec_k = max(1, lane.spec_k - 1)
            if ledger_on:
                reqledger.on_spec(lane.req.rid, drafted=len(d),
                                  accepted=accepted, emitted=len(emitted),
                                  n_lanes=n_lanes, replica=self.slo.name)
            # Token-level rollback: the verify tick wrote K/V for every
            # position in [length, length + len(d)]; those past the
            # accepted prefix hold rejected drafts.
            self.kv.rollback(lane.seq_id, lane.length + accepted + 1)
            for i, tok in enumerate(emitted):
                lane.length += 1
                self._emit(lane, tok, rows[i])
                total_emitted += 1
                if lane.slot not in self.active:
                    break  # retired (eos / budget); KV already freed
        self.spec_verify_ticks += 1
        if total_emitted:
            # Every token delivered this tick took the tick's wall time:
            # one sample per token.
            self._tok_hist.observe(dt, n=total_emitted)
            self.slo.observe_token_latency(dt, n=total_emitted)
        self.decode_steps += 1
        observe.counter("tdx.serve.decode_steps").inc()

    def _emit(self, lane: _Lane, token: int, logits: np.ndarray) -> None:
        lane.generated.append(token)
        if self._drafter is not None:
            # One (order-gram -> token) pair per emitted token: the
            # lane's own stream predicts its future best.
            seq = lane.req.tokens + lane.generated
            self._drafter.observe(seq[-(self._drafter.order + 1):])
        # Recompute preemption replays a requeued request from scratch;
        # positions the client already received must not stream twice.
        pos = len(lane.generated)
        rid = lane.req.rid
        if pos > self._delivered.get(rid, 0):
            self._delivered[rid] = pos
            self._tokens_out += 1
            if self.on_token is not None:
                self.on_token(rid, token)
        req = lane.req
        done = (
            (req.eos_id is not None and token == req.eos_id)
            or len(lane.generated) >= req.max_new_tokens
            or lane.length >= self.scfg.max_context
        )
        if done:
            self._retire(lane, logits)

    def _retire(self, lane: _Lane, logits: np.ndarray) -> None:
        self.kv.free(lane.seq_id)
        self.active.pop(lane.slot, None)
        self._delivered.pop(lane.req.rid, None)
        self.results[lane.req.rid] = list(lane.generated)
        self.final_logits[lane.req.rid] = np.asarray(logits, np.float32)
        observe.counter("tdx.serve.requests_completed").inc()
        reqledger.on_finish(lane.req.rid, replica=self.slo.name,
                            tokens=len(lane.generated))
        if self.on_complete is not None:
            self.on_complete(lane.req.rid, list(lane.generated),
                             self.final_logits[lane.req.rid])

    def _preempt(self, slot: int, *, reason: str) -> None:
        """Evict a lane and requeue its whole request at the queue front
        (recompute policy: greedy decode regenerates identically)."""
        lane = self.active.pop(slot)
        self.kv.free(lane.seq_id)
        self.waiting.appendleft(lane.req)
        self.preemptions += 1
        observe.counter("tdx.serve.preempted_requests").inc()
        observe.instant("serve.preempt", category="serve",
                        rid=lane.req.rid, reason=reason,
                        step=self._step_no,
                        flow=reqledger.flow_id(lane.req.rid))
        reqledger.on_abort(lane.req.rid, replica=self.slo.name,
                           reason=reason)
        # Fault-driven preemptions already dumped at the step level with
        # the whole batch's context; page-exhaustion preemptions dump
        # here (throttled per reason inside the recorder).
        if reason != "fault":
            observe.flight_dump(
                "serve_preempt", rid=lane.req.rid, preempt_reason=reason,
                step=self._step_no, pages_in_use=self.kv.pages_in_use,
            )

    # -- telemetry ----------------------------------------------------------

    def _gauges(self) -> None:
        if not observe.enabled():
            return
        observe.gauge("tdx.serve.queue_depth").set(len(self.waiting))
        observe.gauge("tdx.serve.active_requests").set(len(self.active))
        if self._t0 is not None:
            dt = time.perf_counter() - self._t0
            if dt > 0:
                observe.gauge("tdx.serve.tokens_per_s").set(
                    round(self._tokens_out / dt, 3))
        observe.gauge("tdx.serve.prefix_nodes").set(self.prefix.page_count())
        observe.gauge("tdx.serve.prefix_hit_rate").set(
            round(self.prefix.hit_rate(), 4))
        if self.spec_drafted:
            observe.gauge("tdx.serve.spec_drafted").set(self.spec_drafted)
            observe.gauge("tdx.serve.spec_accepted").set(self.spec_accepted)
            observe.gauge("tdx.serve.spec_accept_rate").set(
                round(self.spec_accepted / self.spec_drafted, 4))
        if reqledger.enabled():
            reqledger.occupancy_sample(
                replica=self.slo.name,
                decode_busy=len(self.active),
                decode_lanes=self.scfg.max_batch,
                kv_pages_free=self.kv.free_pages,
                kv_pages_shared=self.kv.shared_pages,
                prefix_hit_rate=self.prefix.hit_rate(),
                queue_depth=len(self.waiting),
            )
        # Percentile publication sorts the windows: refresh every 32
        # ticks and whenever the loop drains (the periodic exporter also
        # republishes on its own clock).
        if self._step_no % 32 == 0 or not (self.waiting or self.active):
            self.slo.publish()


# ---------------------------------------------------------------------------
# replica bring-up + oracle
# ---------------------------------------------------------------------------


def _resolve_model(model, family):
    if isinstance(model, str):
        cfg = PRESETS[model]
        return cfg, family or model_family(model)
    return model, family or "llama"


def spin_up_replica(
    model: "str | TransformerConfig" = "tiny",
    *,
    family: Optional[str] = None,
    serve_cfg: Optional[ServeConfig] = None,
    seed: int = 0,
    param_dtype: Optional[torch.dtype] = None,
    sample_len: int = 8,
    on_token: Optional[Callable[[str, int], None]] = None,
    on_complete: Optional[Callable[[str, List[int], np.ndarray],
                                   None]] = None,
    on_cancel: Optional[Callable[[str, List[int], bool], None]] = None,
    device="cuda",
    health_component: str = "serve",
    slo_name: str = "serve",
) -> ServeEngine:
    """Bring up one serving replica on ``device``: ``deferred_init`` the
    model (fakes claiming ``device``, zero storage) -> materialize the
    parameters straight onto the device with the keyed materializer
    (:func:`~..cuda_bridge.materialize.materialize_module_cuda` of
    ``seed``, then :func:`~..cuda_bridge.materialize.bind_values`) ->
    capture every serving program (:meth:`ServeEngine.warmup`).
    ``bring_up_seconds`` covers the first two, ``capture_seconds`` the
    last.  The values are a function of ``seed`` and the recording
    alone: the global generator is neither read nor reseeded, and
    replicas of one seed come up with equal weights whatever thread
    spins them, concurrently or not.
    On the card ``bring_up_outcomes`` holds each kernel library's
    outcome (:func:`..ops._build.bring_up`): ``hit`` where it came from
    the local cache or the registry, ``miss`` where nvcc built it.

    ``model`` is a preset name (family inferred from it) or a
    :class:`TransformerConfig` (then pass ``family``).  ``param_dtype``
    is the dtype every floating parameter is stored in, norm scales
    included, as the JAX package's replica casts its params (default:
    the config's, which keeps norms in float32); compute runs in the
    config's ``dtype``.  ``on_token`` /
    ``on_complete`` / ``on_cancel`` are the engine's hooks (a fleet's
    replica passes its own).  ``sample_len`` is the JAX signature's
    sample input length for tracing the init program; the port records
    the module itself and needs none.

    ``health_component`` walks ``spin_up`` -> ``warming`` -> ``serving``
    in :mod:`..observe.health` (no router may send work before
    ``serving``); ``slo_name`` names the engine's SLO windows."""
    del sample_len
    dev = resolve_device(device)
    cfg, family = _resolve_model(model, family)
    if param_dtype is not None:
        cfg = cfg.replace(param_dtype=param_dtype)
    observe.health.set_state(health_component, "spin_up")
    with observe.span("serve.spin_up", category="serve",
                      family=family) as sp:
        t0 = time.perf_counter()
        # The libraries first: once the materializer has loaded the keyed
        # draws' library, a build of it would read as a hit.
        outcomes = {}
        if dev.type == "cuda":
            outcomes = _build.bring_up(path_sources("serve"))
            build_kernel()
        net = deferred_init(make_model, family, cfg, dev)
        bind_values(net, materialize_module_cuda(
            net, seed=seed, param_dtype=param_dtype, device=dev))
        net.eval()
        engine = ServeEngine(family, cfg, net, serve_cfg=serve_cfg,
                             device=dev, on_token=on_token,
                             on_complete=on_complete, on_cancel=on_cancel,
                             slo_name=slo_name)
        engine.bring_up_outcomes = outcomes
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        engine.bring_up_seconds = time.perf_counter() - t0
        observe.health.set_state(health_component, "warming")
        engine.warmup()
        observe.health.set_state(health_component, "serving")
        sp.set(seconds=round(engine.bring_up_seconds, 3),
               capture_s=round(engine.capture_seconds, 3))
    return engine


@torch.no_grad()
def oracle_generate(
    model: torch.nn.Module,
    prompt: Sequence[int],
    max_new_tokens: int,
    eos_id: Optional[int] = None,
):
    """The no-batching, no-cache greedy oracle: full forward over the
    growing sequence through the model, argmax each step.  Returns
    ``(generated_tokens, final_step_logits)``: what the engine must
    reproduce for the same request, whatever batching, paging, sharing,
    speculation or preemption happened along the way."""
    device = next(model.parameters()).device
    toks = list(prompt)
    out: List[int] = []
    logits_last = None
    for _ in range(max_new_tokens):
        logits = model(torch.tensor([toks], dtype=torch.long, device=device))
        logits_last = logits[0, -1].float().cpu().numpy()
        t = int(np.argmax(logits_last))
        out.append(t)
        toks.append(t)
        if eos_id is not None and t == eos_id:
            break
        if len(toks) >= model.cfg.max_seq_len:
            break
    return out, logits_last
