"""Serve fleet (the port's counterpart of ``torchdistx_tpu/serve/fleet.py``):
N replicas behind one router and autoscaler.

* **ServeFleet**, the controller.  Owns N in-process replicas, each a
  :func:`~.engine.spin_up_replica` engine on its own daemon thread.  The
  controller drives everything from a single-threaded
  :meth:`~ServeFleet.tick` loop: replica threads only serve; routing,
  scaling, requeueing and completion bookkeeping never race each other.
* **Router** (:mod:`.router`): one bounded global
  :class:`~.router.AdmissionQueue` (overflow and per-request deadline →
  typed :class:`~.router.Rejection`), prefix-affinity dispatch
  (:func:`~.router.prefix_affinity`, falling back to
  least-outstanding-WORK over remaining token budget) with a per-replica
  dispatch cap, so backlog builds in the global queue where the
  autoscaler sees it.
* **Autoscaler**: pure and hysteretic: scale up on sustained queue-depth
  or p95-TTFT pressure, scale down by DRAINING a replica (it finishes
  its in-flight lanes, gets no new work, hands back its backlog, then
  frees its KV pool).  The ``min_replicas`` floor is not a scaling
  decision: a dead replica is backfilled even with ``autoscale=False``.

**Failure semantics** reuse the chaos subsystem: the ``fleet`` site
(keyed by 1-based replica id; kinds ``raise`` / ``hang`` / ``preempt``
/ ``flap``) fires inside the named replica's serving thread while it has
a batch in flight.  The controller detects the death (terminal state, or
a stalled heartbeat after ``stall_s``) and requeues every request the
replica held onto the survivors, FRONT of the global queue.  Greedy
decode regenerates a requeued request identically and the fleet-level
stream dedupe suppresses replayed positions, so **faults cost latency,
never a token**: fleet output equals the single-engine
:func:`~.engine.oracle_generate` across storms, kills and scale
transitions.  Each replica reports ``fleet/rN`` states into
:mod:`..observe.health`; ``/readyz`` is ready iff a replica serves.

**Guardrails** (:mod:`.guardrails`, armed by ``FleetConfig.guardrails``):
per-replica circuit breakers with quarantine and a half-open probe
replica, end-to-end deadlines that cancel a doomed lane mid-decode,
hedged dispatch (first TTFT wins, the loser's lane is cancelled) and
priority brownout.  **Weight rollover** (:mod:`.rollover`):
:meth:`ServeFleet.start_rollover` rolls the live fleet onto a committed
checkpoint blue-green behind a canary gate; every completion is
oracle-exact FOR ITS VERSION (:attr:`ServeFleet.served_version`,
``version_params``).

**One device, several threads.**  The replicas of a fleet share one
device and run in one process.  Every piece of device work of the fleet
(a replica's bring-up and program capture, each engine step, drain,
cancel and pool release, a rollover's checkpoint restore and canary
oracle) runs under one lock, :attr:`ServeFleet.device_lock`: a CUDA
graph capture forbids other threads' unsafe CUDA calls while it records
(``capture_error_mode="global"``), and every replica launches on the
current (default) stream, where its work would serialize anyway.  So a
fleet on one card interleaves its replicas' ticks; the host-side
routing, queueing and bookkeeping run beside them.  Replicas of one seed
come up with equal weights: :func:`~.engine.spin_up_replica` takes them
from the keyed materializer, a function of the seed and the recording.

**Warm bring-up.**  A replica's only compiled artifacts are its kernel
libraries; ``bring_up_warm`` is True when its bring-up built none with
nvcc (each came from the local cache or the artifact registry,
``TDX_REGISTRY_DIR``), and ``tdx.fleet.spin_up_warm_s`` then gauges its
bring-up seconds (telemetry on).  It still records, materializes and
captures its programs itself: the port compiles no init program.

What the port does not have yet: a replica over a mesh (``mesh=`` /
``plan=``: ROADMAP A6.6; the port's engine serves one device).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import chaos, observe
from .. import config as tdx_config
from ..models import PRESETS, TransformerConfig
from ..observe import reqledger
from ..utils.logging import get_logger
from .engine import Request, ServeEngine, oracle_generate, spin_up_replica
from .guardrails import (
    Brownout,
    CircuitBreaker,
    GuardrailConfig,
    QuarantineEntry,
    should_hedge,
)
from .programs import ServeConfig, make_model, model_family
from .router import (
    AdmissionQueue,
    FleetRejected,
    Rejection,
    least_outstanding,
    prefix_affinity,
)

__all__ = ["Autoscaler", "FleetConfig", "ReplicaHandle", "ServeFleet",
           "params_model"]

# Replica states the controller treats as dead (requeue + remove).
_DEAD_STATES = ("failed", "preempted")
_TERMINAL_STATES = _DEAD_STATES + ("drained", "stopped")


@dataclass(frozen=True)
class FleetConfig:
    """Fleet sizing, admission, and autoscaling policy."""

    min_replicas: int = 1         # backfilled even with autoscale off
    max_replicas: int = 4
    max_queue: int = 256          # global admission bound (queue_full)
    dispatch_per_replica: float = 2.0  # cap = max_batch × this, queued beyond
    up_queue_per_replica: float = 4.0  # queue pressure: queued > this × serving
    up_ttft_p95_s: Optional[float] = None  # TTFT pressure (None = queue only)
    up_consecutive: int = 2       # ticks of pressure before scaling up
    down_consecutive: int = 8     # ticks of idle before draining one
    cooldown_s: float = 1.0       # min seconds between scaling actions
    stall_s: float = 30.0         # heartbeat age that declares a replica dead
    autoscale: bool = True        # pressure/idle decisions (floor is always on)
    guardrails: Optional[GuardrailConfig] = None  # None = reactive-only fleet


class Autoscaler:
    """Pure hysteretic scaling policy: feed it one observation per
    controller tick, get ``"up"`` / ``"down"`` / ``None``.  No I/O, no
    clocks of its own — fully scriptable in tests."""

    def __init__(self, fc: FleetConfig):
        self.fc = fc
        self._up_streak = 0
        self._down_streak = 0
        self._last_scale: Optional[float] = None

    def decide(self, *, now: float, queued: int, outstanding: int,
               serving: int, total: int,
               ttft_p95: Optional[float] = None) -> Optional[str]:
        fc = self.fc
        if total < fc.min_replicas:
            # The floor is availability, not load policy: no hysteresis,
            # no cooldown, no autoscale gate — backfill immediately.
            return "up"
        if not fc.autoscale:
            return None
        pressure = serving > 0 and (
            queued > fc.up_queue_per_replica * serving
            or (fc.up_ttft_p95_s is not None and ttft_p95 is not None
                and ttft_p95 > fc.up_ttft_p95_s)
        )
        idle = queued == 0 and outstanding == 0
        self._up_streak = self._up_streak + 1 if pressure else 0
        self._down_streak = self._down_streak + 1 if idle else 0
        in_cooldown = (self._last_scale is not None
                       and (now - self._last_scale) < fc.cooldown_s)
        if (self._up_streak >= fc.up_consecutive and total < fc.max_replicas
                and not in_cooldown):
            self._up_streak = self._down_streak = 0
            self._last_scale = now
            return "up"
        if (self._down_streak >= fc.down_consecutive
                and serving > fc.min_replicas and serving > 1
                and not in_cooldown):
            self._up_streak = self._down_streak = 0
            self._last_scale = now
            return "down"
        return None


class ReplicaHandle:
    """Controller-side view of one replica thread.  The controller owns
    the handle; the replica thread only touches its own deques, state,
    and heartbeat — every field is either single-writer or a thread-safe
    container."""

    def __init__(self, idx: int, bound_cfg):
        self.idx = idx                      # 1-based; the chaos fleet key
        self.component = f"fleet/r{idx}"    # observe.health namespace
        self.slo_name = f"serve-r{idx}"     # observe.slo namespace
        self.bound_cfg = bound_cfg          # tdx_config captured at spawn
        self.thread: Optional[threading.Thread] = None
        self.engine: Optional[ServeEngine] = None
        self.state = "launching"
        self.inbox: "deque[Request]" = deque()
        self.done: "deque[tuple]" = deque()   # (rid, tokens, final_logits)
        self.bad: "deque[tuple]" = deque()    # (rid, message) — engine reject
        self.assigned: set = set()            # rids routed here, not yet done
        # Guardrail plumbing (all thread-safe deques; see guardrails.py):
        self.faults: "deque[tuple]" = deque()     # (t, kind) replica-thread obs
        self.cancels: "deque[tuple]" = deque()    # (rid, reason) ctrl → replica
        self.cancelled: "deque[tuple]" = deque()  # (rid, toks, active) ← engine
        self.breaker: Optional[CircuitBreaker] = None  # controller-owned
        self.half_open = False                # quarantine probe: one request
        self.tripped = False                  # breaker ejected it
        # Blue-green rollover (docs/serving.md §Weight rollover):
        self.weight_version: Optional[str] = None  # ckpt stamp it serves
        self.params_override = None   # installed post-spin-up (GREEN)
        self.canary = False           # out of rotation: probe work only
        self._slow_counted: Optional[float] = None  # last beat flagged slow
        self.stop_evt = threading.Event()
        self.drain_evt = threading.Event()
        self.work_evt = threading.Event()
        self.leftover: List[Request] = []     # drain's unserved backlog
        self.error: Optional[BaseException] = None
        self.bring_up_seconds: Optional[float] = None
        self.capture_seconds: Optional[float] = None
        self.bring_up_warm: Optional[bool] = None
        self.last_beat = time.monotonic()
        self.reaped = False                   # controller removed it

    def set_state(self, state: str) -> None:
        """Advance the replica state machine; terminal states stick (a
        woken hang thread must not resurrect a reaped replica), and a
        reaped replica no longer mirrors into /readyz."""
        if self.state in _TERMINAL_STATES:
            return
        self.state = state
        if not self.reaped:
            observe.health.set_state(self.component, state)

    def give(self, req: Request) -> None:
        self.assigned.add(req.rid)
        self.inbox.append(req)
        self.work_evt.set()

    def outstanding(self) -> int:
        """Remaining token budget routed at this replica (inbox not yet
        pulled + the engine's waiting/active lanes)."""
        load = sum(r.max_new_tokens for r in list(self.inbox))
        eng = self.engine
        if eng is not None:
            load += eng.outstanding_tokens()
        return load

    def prefix_match_tokens(self, tokens) -> int:
        """How many of ``tokens`` this replica's prefix cache already
        holds — the router-affinity probe.  Called from the CONTROLLER
        thread against the replica's live tree; the probe is
        mutation-free and any cross-thread artifact reads as 0 (it's a
        routing heuristic, never an invariant)."""
        eng = self.engine
        if eng is None or not eng.scfg.prefix_cache:
            return 0
        try:
            return eng.prefix.match_len(tokens)
        except Exception:  # noqa: BLE001 — a stale probe must not kill a tick
            return 0

    def note_fault(self, kind: str) -> None:
        """Record one breaker observation from the replica thread; the
        controller drains it into the breaker window on its next tick
        (the timestamp is the FAULT's, not the drain's)."""
        self.faults.append((time.monotonic(), kind))

    def beat(self) -> None:
        self.last_beat = time.monotonic()


class ServeFleet:
    """The fleet controller; see the module docstring for the design."""

    def __init__(
        self,
        model: "str | TransformerConfig" = "tiny",
        *,
        family: Optional[str] = None,
        serve_cfg: Optional[ServeConfig] = None,
        fleet_cfg: Optional[FleetConfig] = None,
        mesh=None,
        plan=None,
        seed: int = 0,
        param_dtype=None,
        sample_len: int = 8,
        on_token: Optional[Callable[[str, int], None]] = None,
        device="cuda",
    ):
        if mesh is not None or plan is not None:
            raise NotImplementedError(
                "a fleet of replicas over a mesh (mesh=, plan=) is ROADMAP "
                "A6.6: the port's engine serves one device")
        if isinstance(model, str):
            cfg = PRESETS[model]
            if not isinstance(cfg, TransformerConfig):
                raise ValueError(f"preset {model!r} is not a decoder LM")
            family = family or model_family(model)
        else:
            cfg = model
            family = family or "llama"
        self.model, self.family, self.cfg = model, family, cfg
        self.serve_cfg = serve_cfg
        self.fc = fleet_cfg or FleetConfig()
        self.device = device
        # Every piece of the fleet's device work holds this (the module
        # docstring says why).
        self.device_lock = threading.RLock()
        self._seed, self._param_dtype = seed, param_dtype
        self._sample_len = sample_len
        self.on_token = on_token
        # Validation mirror of ServeEngine.submit: an invalid request is
        # a typed rejection at the DOOR, not a replica-thread crash.
        self._resolved = (serve_cfg or ServeConfig()).resolve(cfg)
        self._kvcfg = self._resolved.kv_config(cfg)
        # The first replica's state dict (oracle use): its tensors are that
        # replica's parameters, which nothing overwrites (install_params
        # only ever runs on a replica that starts on other weights).
        self.params = None
        # Blue-green rollover state (docs/serving.md §Weight rollover).
        # ``active_version`` is the stamp new work routes to (None until
        # a roll shifts traffic — None == None keeps the pre-roll fleet
        # on the legacy single-version dispatch path); ``_rid_version``
        # pins in-flight requests to the version they dispatched under;
        # ``served_version`` / ``version_params`` record, per finished
        # rid, which weights produced it — the per-version oracle key.
        self.active_version: Optional[str] = None
        self.version_params: Dict[Optional[str], object] = {}
        self.served_version: Dict[str, Optional[str]] = {}
        self._rid_version: Dict[str, Optional[str]] = {}
        self._spawn_params = None     # weights NEW replicas install
        self._spawn_version: Optional[str] = None
        self.rollover = None          # in-flight RolloverController
        self.queue = AdmissionQueue(max_depth=self.fc.max_queue)
        self.autoscaler = Autoscaler(self.fc)
        self.handles: List[ReplicaHandle] = []       # launch order
        self.results: Dict[str, List[int]] = {}
        self.final_logits: Dict[str, np.ndarray] = {}
        self.rejected: Dict[str, Rejection] = {}
        self._pending: set = set()            # rids admitted, not yet done
        self._requests: Dict[str, Request] = {}
        self._stream_pos: Dict[str, int] = {}  # fleet-level dedupe
        self._stream_lock = threading.Lock()
        # Guardrail state (docs/serving.md §Guardrails); gc None = off.
        self.gc: Optional[GuardrailConfig] = self.fc.guardrails
        self.quarantine: List[QuarantineEntry] = []
        self.brownout = (Brownout(self.gc)
                         if self.gc is not None and self.gc.brownout else None)
        self.partial: Dict[str, List[int]] = {}  # delivered tokens, by rid
        self._hedges: Dict[str, List[ReplicaHandle]] = {}  # rid → both targets
        self._first_replica: Dict[str, int] = {}  # rid → idx that won TTFT
        self._wake = threading.Event()
        self._next_idx = 1
        self._tick_no = 0
        self._shutdown = False
        self._log = get_logger()

    # -- scaling ------------------------------------------------------------

    def start(self, n: Optional[int] = None, *, wait: bool = True,
              timeout: float = 300.0) -> "ServeFleet":
        """Bring up ``n`` replicas (default ``min_replicas``)."""
        n = self.fc.min_replicas if n is None else n
        for _ in range(n):
            self.scale_up()
        if wait:
            self.wait_replicas(n, timeout=timeout)
        return self

    def scale_up(self, *, wait: bool = False, timeout: float = 300.0,
                 params=None, version: Optional[str] = None,
                 canary: bool = False) -> ReplicaHandle:
        """Launch one replica.  The effective ``tdx_config`` is captured
        HERE, on the calling thread, and re-entered on the replica thread
        via ``tdx_config.bind``: thread-local ``override`` scopes are
        invisible to spawned threads.

        ``params``/``version`` install explicit weights after the
        spin-up (the rollover's GREEN bring-up); with neither given the
        fleet's spawn defaults apply, so floor backfills, autoscale-ups,
        and half-open probes after a shifted roll all come up on the NEW
        weights.  ``canary=True`` keeps the replica out of dispatch
        rotation (probe traffic only)."""
        h = ReplicaHandle(self._next_idx, tdx_config.get())
        self._next_idx += 1
        if params is None:
            params = self._spawn_params
            if version is None:
                version = self._spawn_version
        h.params_override = params
        h.weight_version = version
        h.canary = canary
        if self.gc is not None and self.gc.breaker:
            h.breaker = CircuitBreaker(self.gc)
        self.handles.append(h)
        h.set_state("launching")
        observe.counter("tdx.fleet.scale_ups").inc()
        observe.instant("fleet.scale_up", category="serve", replica=h.idx)
        h.thread = threading.Thread(
            target=self._replica_main, args=(h,),
            name=f"tdx-fleet-r{h.idx}", daemon=True,
        )
        h.thread.start()
        if wait:
            deadline = time.monotonic() + timeout
            while h.state not in ("serving",) + _TERMINAL_STATES:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"replica r{h.idx} not serving after {timeout}s "
                        f"(state={h.state})"
                    )
                self._wake.wait(0.005)
                self._wake.clear()
            if h.state != "serving":
                raise RuntimeError(
                    f"replica r{h.idx} died during bring-up "
                    f"(state={h.state}): {h.error}"
                )
        return h

    def scale_down(self) -> Optional[ReplicaHandle]:
        """Start draining the least-loaded serving replica: it finishes
        its in-flight lanes, gets no new work, hands back its unadmitted
        backlog, and frees its KV pool; the controller requeues the
        backlog and removes it (:meth:`tick`).  A canary is never the
        victim — draining the GREEN probe mid-canary would wreck an
        otherwise healthy roll."""
        serving = [h for h in self.handles
                   if h.state == "serving" and not h.canary]
        if not serving:
            return None
        h = least_outstanding(serving, lambda x: x.outstanding())
        h.set_state("draining")
        h.drain_evt.set()
        h.work_evt.set()
        observe.instant("fleet.scale_down", category="serve", replica=h.idx)
        return h

    def wait_replicas(self, n: int, *, timeout: float = 300.0) -> None:
        """Tick until ``n`` replicas are serving (bring-up + backfill)."""
        deadline = time.monotonic() + timeout
        while sum(1 for h in self.handles if h.state == "serving") < n:
            if time.monotonic() > deadline:
                states = {f"r{h.idx}": h.state for h in self.handles}
                raise RuntimeError(
                    f"fewer than {n} replicas serving after {timeout}s: "
                    f"{states}"
                )
            self.tick()
            self._wake.wait(0.005)
            self._wake.clear()

    def oracle_generate(self, params, prompt: Sequence[int],
                        max_new_tokens: int, eos_id: Optional[int] = None):
        """:func:`~.engine.oracle_generate` under ``params`` (a state dict
        of the fleet's model, e.g. ``version_params[v]``): the unbatched,
        uncached greedy reference, run on the tensors themselves (no
        copy) under the fleet's device lock."""
        with self.device_lock:
            return oracle_generate(
                params_model(self.family, self.cfg, params), prompt,
                max_new_tokens, eos_id)

    def start_rollover(self, checkpoint_path, *, cfg=None):
        """Begin a blue-green roll of the live fleet onto the committed
        checkpoint at ``checkpoint_path``.  The roll is driven
        stage-by-stage from :meth:`tick` (fetch → canary → shift →
        drain), so it proceeds concurrently with a live storm; the
        returned :class:`~.rollover.RolloverController` exposes the
        stage, outcome, and digest (docs/serving.md §Weight
        rollover)."""
        from .rollover import RolloverController

        if self.rollover is not None:
            raise RuntimeError(
                f"a rollover is already in flight "
                f"(stage={self.rollover.stage})")
        ctl = RolloverController(self, checkpoint_path, cfg=cfg)
        ctl.start()
        return ctl

    # -- admission ----------------------------------------------------------

    def _validate(self, req: Request) -> Optional[str]:
        """ServeEngine.submit's checks, mirrored — returns the rejection
        detail or None."""
        if not req.tokens:
            return "empty prompt"
        if req.max_new_tokens < 1:
            return f"max_new_tokens must be >= 1, got {req.max_new_tokens}"
        if req.deadline_s is not None and req.deadline_s <= 0:
            return f"deadline_s must be > 0, got {req.deadline_s}"
        need = self._kvcfg.pages_for(len(req.tokens) + 1)
        if need > self._kvcfg.usable_pages:
            return (f"prompt of {len(req.tokens)} tokens needs {need} pages "
                    f"but the pool only has {self._kvcfg.usable_pages}")
        if len(req.tokens) + req.max_new_tokens > self._resolved.max_context:
            return (f"prompt + budget ({len(req.tokens)} + "
                    f"{req.max_new_tokens}) exceeds "
                    f"max_context={self._resolved.max_context}")
        return None

    def _reject(self, rejection: Rejection) -> None:
        self.rejected[rejection.rid] = rejection
        self._pending.discard(rejection.rid)
        self._rid_version.pop(rejection.rid, None)
        observe.counter("tdx.fleet.rejected_requests",
                        reason=rejection.reason).inc()
        observe.instant("fleet.reject", category="serve",
                        rid=rejection.rid, reason=rejection.reason,
                        flow=reqledger.flow_id(rejection.rid))
        # Idempotent with the engine-side deadline finalize: a rid the
        # engine already rejected is in the ledger's done ring and this
        # is a no-op.
        reqledger.on_reject(rejection.rid, reason=rejection.reason,
                            tokens=len(rejection.tokens))

    def submit(self, req: Request, *,
               deadline_s: Optional[float] = None) -> None:
        """Admit one request into the global queue.  Raises
        :class:`~.router.FleetRejected` (``invalid`` / ``queue_full``)
        — every rejection is also recorded in :attr:`rejected` and
        counted (``tdx.fleet.rejected_requests``)."""
        detail = self._validate(req)
        if detail is not None:
            rej = Rejection(req.rid, "invalid", detail)
            self._reject(rej)
            raise FleetRejected(rej)
        if (self.brownout is not None and self.brownout.active
                and req.priority < self.gc.brownout_priority):
            # Brownout rejects low-priority work AT THE DOOR — queueing
            # it just to shed it a tick later wastes queue depth the
            # high-priority traffic needs.
            rej = Rejection(
                req.rid, "shed",
                f"brownout: priority {req.priority} < "
                f"{self.gc.brownout_priority} rejected at admission",
            )
            observe.counter("tdx.fleet.shed_requests").inc()
            self._reject(rej)
            raise FleetRejected(rej)
        try:
            self.queue.push(
                req,
                deadline_s=(deadline_s if deadline_s is not None
                            else req.deadline_s),
            )
        except FleetRejected as e:
            self._reject(e.rejection)
            raise
        self._pending.add(req.rid)
        self._requests[req.rid] = req
        req._submit_t = time.perf_counter()
        # Ledger t0 is FLEET admission (first on_enqueue wins), so queue
        # attribution spans the global queue plus any requeue hops; the
        # per-replica engine submit's on_enqueue is then a no-op.
        reqledger.on_enqueue(req.rid, priority=req.priority,
                             deadline_s=req.deadline_s,
                             n_prompt=len(req.tokens))
        # End-to-end deadline, anchored at FLEET admission — queue wait
        # counts against it, and it survives requeues onto new engines.
        if req.deadline_s is not None and not hasattr(req, "_deadline_t"):
            req._deadline_t = req._submit_t + req.deadline_s

    # -- the controller tick ------------------------------------------------

    def _ttft_p95(self) -> Optional[float]:
        """Worst per-replica p95 TTFT over the live SLO windows — the
        autoscaler's latency-pressure signal."""
        worst = None
        for h in self.handles:
            eng = h.engine
            if eng is None or h.state != "serving":
                continue
            p = eng.slo.windows["ttft"].percentiles((95,))
            if p and (worst is None or p[95] > worst):
                worst = p[95]
        return worst

    def tick(self) -> None:
        """One control step: expire deadlines → reap completions → reap
        dead/drained replicas (requeue their work) → guardrails
        (breakers → quarantine → hedge settlement → brownout) →
        dispatch → scale.  Single-threaded: only the controller thread
        calls this."""
        self._tick_no += 1
        now = time.monotonic()
        for rej in self.queue.expire(now=now):
            self._reject(rej)
        for h in list(self.handles):
            self._reap_completions(h)
            if h.state in _DEAD_STATES or (
                    h.state == "serving"
                    and (now - h.last_beat) > self.fc.stall_s):
                self._reap_dead(h)
            elif h.state == "drained":
                self._reap_drained(h)
        if self.gc is not None:
            self._feed_breakers(now)
            self._service_quarantine(now)
            self._settle_hedges()
            self._brownout_tick()
        if self.rollover is not None:
            # Roll stages run on the controller tick, after reaps (so
            # canary completions are visible) and before dispatch (so a
            # shift redirects this tick's traffic).
            self.rollover.step()
        self._dispatch()
        self._autoscale(now)
        if observe.enabled():
            observe.gauge("tdx.fleet.replicas").set(len(self.handles))
            observe.gauge("tdx.fleet.ready_replicas").set(
                sum(1 for h in self.handles if h.state == "serving"))
            if self.gc is not None:
                observe.gauge("tdx.fleet.quarantined_replicas").set(
                    len(self.quarantine))

    def _reap_completions(self, h: ReplicaHandle) -> None:
        while h.done:
            rid, toks, logits = h.done.popleft()
            h.assigned.discard(rid)
            if rid in self._pending:      # dedupe: a revived "dead"
                self._pending.discard(rid)   # replica may double-finish
                self.results[rid] = toks
                self.final_logits[rid] = logits
                # Which weights produced this output — the per-version
                # oracle key (fleet.version_params[served_version[rid]]).
                self.served_version[rid] = h.weight_version
                self._rid_version.pop(rid, None)
                with self._stream_lock:
                    self.partial.pop(rid, None)
                    self._first_replica.pop(rid, None)
                if h.half_open:
                    # The probe request completed cleanly: the replica
                    # earned its way back into full rotation.
                    self._promote_half_open(h)
        while h.bad:
            rid, msg = h.bad.popleft()
            h.assigned.discard(rid)
            if rid in self._pending:
                self._reject(Rejection(rid, "invalid", msg))
        while h.cancelled:
            # Engine-initiated deadline cancellations (mid-decode or
            # while waiting inside the replica): typed rejection
            # carrying tokens-so-far; pages were already freed.
            rid, _toks, was_active = h.cancelled.popleft()
            h.assigned.discard(rid)
            if was_active:
                observe.counter("tdx.fleet.cancelled_lanes").inc()
            if rid in self._pending:
                self._reject_deadline(rid, where="mid-decode"
                                      if was_active else "replica-queue")

    def _requeue_assigned(self, h: ReplicaHandle, reqs: Sequence[Request],
                          *, why: str) -> None:
        for req in reqs:
            if req.rid not in self._pending:
                continue  # completed before the replica went away
            if any(x is not h and req.rid in x.assigned
                   for x in self.handles):
                # A hedge twin still holds a live copy — losing one
                # racer must not spawn a THIRD dispatch.
                h.assigned.discard(req.rid)
                continue
            self.queue.requeue(req)
            h.assigned.discard(req.rid)
            with self._stream_lock:
                streamed = self._stream_pos.get(req.rid, 0)
            if streamed == 0:
                # Nothing delivered yet: unpin, so the re-dispatch may
                # legally land on any version (drained leftovers and
                # killed-before-first-token requests regenerate whole).
                self._rid_version.pop(req.rid, None)
            observe.counter("tdx.fleet.requeued_requests").inc()
            observe.instant("fleet.requeue", category="serve",
                            rid=req.rid, replica=h.idx, reason=why,
                            flow=reqledger.flow_id(req.rid))
            # A dead/killed replica never ran the engine's abort path:
            # close its attempt here (no-op if the engine already did).
            reqledger.on_abort(req.rid, replica=h.slo_name, reason=why)
            reqledger.on_event(req.rid, "requeue", replica=h.idx,
                               reason=why)

    def _remove(self, h: ReplicaHandle) -> None:
        h.reaped = True
        h.stop_evt.set()
        h.work_evt.set()
        self.handles.remove(h)
        observe.health.clear_state(h.component)

    def _reap_dead(self, h: ReplicaHandle) -> None:
        """A replica died (chaos raise/preempt, bring-up failure) or
        stalled (chaos hang past ``stall_s``): requeue everything it
        held and remove it.  The min-replica floor backfills on the
        next autoscale pass."""
        why = h.state if h.state in _DEAD_STATES else "stalled"
        self._log.warning(
            "fleet: replica r%d %s (%s); requeueing %d requests",
            h.idx, why, h.error or "heartbeat stale", len(h.assigned),
        )
        observe.instant("fleet.replica_dead", category="serve",
                        replica=h.idx, reason=why)
        reqs = [self._requests[rid] for rid in sorted(h.assigned)
                if rid in self._requests]
        self._requeue_assigned(h, reqs, why=why)
        if h.half_open:
            self._probe_failed(h, time.monotonic())
        self._remove(h)

    def _reap_drained(self, h: ReplicaHandle) -> None:
        """A drain finished: its in-flight lanes completed bitwise (they
        were reaped above), its unserved backlog goes back to the queue
        front, its KV pool is already freed — remove it."""
        self._reap_completions(h)  # lanes it finished while draining
        self._requeue_assigned(h, h.leftover, why="drain")
        if not h.tripped:
            # A breaker ejection is a guardrail action, not a scaling
            # decision — it is counted in tdx.fleet.breaker_trips.
            observe.counter("tdx.fleet.scale_downs").inc()
        self._remove(h)

    # -- guardrails (docs/serving.md §Guardrails) ---------------------------

    def _feed_breakers(self, now: float) -> None:
        """Drain replica-thread fault observations into each breaker's
        sliding window, add slow-tick observations controller-side, and
        trip any breaker whose window filled — ejecting the replica
        (drain if its heartbeat is live, kill if not) and opening a
        quarantine entry with exponential backoff."""
        gc = self.gc
        if not gc.breaker:
            return
        for h in list(self.handles):
            if h.breaker is None or h.state not in ("serving", "draining"):
                continue
            while h.faults:
                t, kind = h.faults.popleft()
                h.breaker.record(t, kind)
            beat_age = now - h.last_beat
            if (gc.slow_tick_s is not None and h.state == "serving"
                    and beat_age > gc.slow_tick_s
                    and h._slow_counted != h.last_beat
                    and (h.inbox or h.assigned)):
                # One observation per slow EPISODE: the beat timestamp
                # is the episode's identity (a wedged thread stops
                # beating; counting every tick would trip on one stall).
                h.breaker.record(now, "slow")
                h._slow_counted = h.last_beat
            if h.state == "serving" and h.breaker.tripped(now):
                self._trip_breaker(h, now)

    def _trip_breaker(self, h: ReplicaHandle, now: float) -> None:
        gc = self.gc
        h.tripped = True
        observe.counter("tdx.fleet.breaker_trips").inc()
        observe.instant("fleet.breaker_trip", category="serve",
                        replica=h.idx, window=h.breaker.count(now))
        self._log.warning(
            "fleet: breaker tripped on r%d (%d faults in %.1fs window)",
            h.idx, h.breaker.count(now), gc.breaker_window_s,
        )
        if h.half_open:
            # The probe itself misbehaved: double the origin entry's
            # backoff instead of opening a second quarantine record.
            for q in self.quarantine:
                if q.probe_idx == h.idx:
                    q.fail_probe(now, gc)
                    break
        else:
            self.quarantine.append(QuarantineEntry(
                origin_idx=h.idx, until=now + gc.quarantine_s,
                backoff_s=gc.quarantine_s,
            ))
        responsive = (now - h.last_beat) <= max(
            1.0, gc.slow_tick_s or 0.0)
        if responsive:
            # Eject politely: finish in-flight lanes, hand back the
            # backlog (reaped via the normal drained path).
            h.set_state("draining")
            h.drain_evt.set()
            h.work_evt.set()
        else:
            # Not responding — kill: requeue its work and remove it;
            # the stop event lets the thread exit when it wakes.
            reqs = [self._requests[rid] for rid in sorted(h.assigned)
                    if rid in self._requests]
            self._requeue_assigned(h, reqs, why="breaker")
            self._remove(h)

    def _service_quarantine(self, now: float) -> None:
        """Expired quarantine entries re-admit capacity HALF-OPEN: a
        fresh replica (a new spin-up) that gets exactly one
        probe request; a clean completion promotes it to full rotation
        (:meth:`_reap_completions`), a failure doubles the backoff."""
        for q in self.quarantine:
            if q.probe_idx is not None or now < q.until:
                continue
            if len(self.handles) >= self.fc.max_replicas:
                continue  # no headroom this tick; retry next tick
            h = self.scale_up()
            h.half_open = True
            q.probe_idx = h.idx
            observe.counter("tdx.fleet.half_open_probes").inc()
            observe.instant("fleet.half_open_probe", category="serve",
                            replica=h.idx, origin=q.origin_idx)

    def _probe_failed(self, h: ReplicaHandle, now: float) -> None:
        """A half-open replica died before completing its probe."""
        for q in self.quarantine:
            if q.probe_idx == h.idx:
                q.fail_probe(now, self.gc)
                observe.instant("fleet.probe_failed", category="serve",
                                replica=h.idx, origin=q.origin_idx,
                                backoff_s=round(q.backoff_s, 3))
                return

    def _promote_half_open(self, h: ReplicaHandle) -> None:
        """The probe completed cleanly: full rotation, quarantine over."""
        h.half_open = False
        self.quarantine = [q for q in self.quarantine
                           if q.probe_idx != h.idx]
        observe.instant("fleet.probe_ok", category="serve", replica=h.idx)

    def _settle_hedges(self) -> None:
        """Resolve hedge races: once a hedged request's first token
        arrived (or it completed), cancel the copy on every OTHER
        replica — the loser's lane frees its pages now instead of
        burning a duplicate decode to completion.  Greedy decode plus
        the fleet-level stream dedupe make the race invisible to the
        client whichever replica wins."""
        if not self._hedges:
            return
        for rid in list(self._hedges):
            if rid not in self._pending:
                # Completed or rejected; cancel any straggler copies.
                for h in self._hedges.pop(rid):
                    if h in self.handles and rid in h.assigned:
                        h.assigned.discard(rid)
                        h.cancels.append((rid, "hedge_settled"))
                        h.work_evt.set()
                continue
            with self._stream_lock:
                winner = self._first_replica.get(rid)
            if winner is None:
                continue  # race still running
            observe.counter("tdx.fleet.hedge_wins").inc()
            observe.instant("fleet.hedge_win", category="serve",
                            rid=rid, replica=winner,
                            flow=reqledger.flow_id(rid))
            reqledger.on_event(rid, "hedge_win", replica=winner)
            for h in self._hedges.pop(rid):
                if h.idx != winner and h in self.handles \
                        and rid in h.assigned:
                    h.assigned.discard(rid)
                    h.cancels.append((rid, "hedge_lost"))
                    h.work_evt.set()

    def _brownout_tick(self) -> None:
        if self.brownout is None:
            return
        was = self.brownout.active
        serving = sum(1 for h in self.handles if h.state == "serving")
        active = self.brownout.observe(
            queued=self.queue.depth(), serving=serving,
            ttft_p95=self._ttft_p95(),
        )
        if active and not was:
            observe.counter("tdx.fleet.brownouts").inc()
            observe.instant("fleet.brownout_enter", category="serve",
                            queued=self.queue.depth(), serving=serving)
            self._log.warning(
                "fleet: entering brownout (queued=%d, serving=%d)",
                self.queue.depth(), serving,
            )
        elif was and not active:
            observe.instant("fleet.brownout_exit", category="serve")
        if active:
            # Shed QUEUED low-priority entries every brownout tick —
            # work queued just before entry, plus any that trickled in.
            for rej in self.queue.shed_low_priority(self.gc.brownout_priority):
                observe.counter("tdx.fleet.shed_requests").inc()
                self._reject(rej)

    # -- dispatch -----------------------------------------------------------

    def _dispatch(self) -> None:
        serving = [h for h in self.handles
                   if h.state == "serving" and not h.canary]
        if not serving:
            return
        cap = max(1, int(self._resolved.max_batch
                         * self.fc.dispatch_per_replica))
        now = time.monotonic()
        deferred: List[Request] = []
        while True:
            # A half-open replica is on probation: exactly ONE request
            # until its probe completes (docs/serving.md §Guardrails).
            ready = [h for h in serving
                     if len(h.assigned) < (1 if h.half_open else cap)]
            if not ready:
                break  # backlog stays queued → visible scale pressure
            entry = self.queue.pop(now=now)
            if entry is None:
                break
            req = entry.req
            if req.rid not in self._pending:
                # Resolved while queued (an aborted roll dropped its
                # probe rids; a breaker/brownout path rejected it):
                # dispatching would burn a lane on a dead rid.
                continue
            dl = getattr(req, "_deadline_t", None)
            if dl is not None and time.perf_counter() > dl:
                # Dispatch-time deadline check: requeued entries are
                # exempt from the QUEUE deadline (an admitted request
                # is a promise), but a promise the client stopped
                # waiting for is not worth a replica's time — typed
                # rejection carrying whatever was already delivered.
                self._reject_deadline(req.rid, where="dispatch")
                continue
            # Version-aware routing (docs/serving.md §Weight rollover):
            # a request that already streamed tokens under one weight
            # version is PINNED to it — migrating mid-decode would tear
            # the output across versions — while unpinned work routes
            # to the fleet's active version.  Pre-roll fleets have
            # every version None, so the filter is the identity.
            pinned = req.rid in self._rid_version
            want = (self._rid_version[req.rid] if pinned
                    else self.active_version)
            cand = [h for h in ready if h.weight_version == want]
            if not cand:
                if pinned and not any(h.weight_version == want
                                      for h in self.handles):
                    # The version it streamed under is fully retired —
                    # no live or draining replica can ever resume it.
                    self._reject_stale(req.rid)
                    continue
                deferred.append(req)  # capacity may appear next tick
                continue
            h, affine = prefix_affinity(
                cand, lambda x: x.outstanding(),
                lambda x: x.prefix_match_tokens(req.tokens),
            )
            if affine:
                observe.counter("tdx.fleet.prefix_affinity_hits").inc()
            self._rid_version[req.rid] = h.weight_version
            reqledger.on_version(req.rid, h.weight_version)
            h.give(req)
            if self.gc is not None and len(cand) > 1:
                waited = now - entry.enqueued_t
                if (req.rid not in self._hedges
                        and should_hedge(waited, req.deadline_s, self.gc)):
                    # Hedge twins must serve the SAME weight version:
                    # first-token-wins arbitration across versions
                    # would be a cross-version torn output.
                    mates = [x for x in cand
                             if x is not h and not x.half_open]
                    mate = least_outstanding(mates,
                                             lambda x: x.outstanding())
                    if mate is not None:
                        mate.give(req)
                        self._hedges[req.rid] = [h, mate]
                        observe.counter("tdx.fleet.hedged_requests").inc()
                        observe.instant(
                            "fleet.hedge", category="serve", rid=req.rid,
                            primary=h.idx, mate=mate.idx,
                            waited_s=round(waited, 4),
                            flow=reqledger.flow_id(req.rid),
                        )
                        reqledger.on_event(req.rid, "hedge",
                                           primary=h.idx, mate=mate.idx)
        for req in deferred:
            # No replica of the right version had room THIS tick (e.g.
            # mid-shift, before GREEN capacity caught up): back to the
            # queue's exempt front lane, retried next tick.  The
            # backlog stays visible to the autoscaler, whose spawn
            # defaults track the shifted version.
            self.queue.requeue(req)

    def _reject_deadline(self, rid: str, *, where: str) -> None:
        """Typed ``deadline`` rejection carrying tokens-so-far; also
        cancels any other live copies of the request (hedge twins)."""
        with self._stream_lock:
            partial = tuple(self.partial.pop(rid, ()))
            self._first_replica.pop(rid, None)
        self._reject(Rejection(
            rid, "deadline",
            f"end-to-end deadline exceeded ({where}); "
            f"{len(partial)} tokens delivered",
            tokens=partial,
        ))
        for h in self.handles:
            if rid in h.assigned:
                h.assigned.discard(rid)
                h.cancels.append((rid, "deadline"))
                h.work_evt.set()
        self._hedges.pop(rid, None)

    def _reject_stale(self, rid: str) -> None:
        """Typed ``stale_version`` rejection: the weight version this
        request streamed tokens under retired mid-roll (its last
        replica died before the request finished), and continuing the
        stream on any other version would tear the output.  Exactly one
        rejection, carrying the delivered-so-far tokens — which remain
        an exact prefix of the retired version's oracle."""
        with self._stream_lock:
            partial = tuple(self.partial.pop(rid, ()))
            self._first_replica.pop(rid, None)
        want = self._rid_version.get(rid)
        observe.counter("tdx.fleet.stale_version_rejects").inc()
        self._reject(Rejection(
            rid, "stale_version",
            f"weight version {want} retired mid-roll; "
            f"{len(partial)} tokens delivered",
            tokens=partial,
        ))

    def _autoscale(self, now: float) -> None:
        serving = sum(1 for h in self.handles if h.state == "serving")
        outstanding = sum(h.outstanding() for h in self.handles)
        decision = self.autoscaler.decide(
            now=now, queued=self.queue.depth(), outstanding=outstanding,
            serving=serving, total=len(self.handles),
            ttft_p95=self._ttft_p95(),
        )
        if decision == "up" and len(self.handles) < self.fc.max_replicas:
            self.scale_up()
        elif decision == "down":
            self.scale_down()

    # -- the blocking storm driver ------------------------------------------

    def run(self, requests: Sequence[Request] = (), *,
            max_seconds: float = 300.0) -> Dict[str, List[int]]:
        """Submit ``requests`` (``arrival_step`` staggers them by
        controller tick) and tick until every admitted request completed
        or was rejected; returns the cumulative rid → tokens map.
        Requests rejected at the door (``invalid`` / ``queue_full``)
        are recorded in :attr:`rejected` and skipped, not raised — a
        storm driver wants the fleet's aggregate behavior."""
        arrivals = sorted(requests, key=lambda r: r.arrival_step)
        deadline = time.monotonic() + max_seconds
        i = 0
        while True:
            while i < len(arrivals) and (
                    arrivals[i].arrival_step <= self._tick_no):
                try:
                    self.submit(arrivals[i])
                except FleetRejected:
                    pass  # recorded + counted by submit
                i += 1
            self.tick()
            if i >= len(arrivals) and not self._pending:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"fleet run exceeded {max_seconds}s with "
                    f"{len(self._pending)} pending / {len(arrivals) - i} "
                    f"unsubmitted"
                )
            self._wake.wait(0.002)
            self._wake.clear()
        return dict(self.results)

    def shutdown(self) -> None:
        """Stop every replica thread and clear the fleet's /readyz
        components; results stay readable."""
        self._shutdown = True
        for h in list(self.handles):
            h.stop_evt.set()
            h.work_evt.set()
        for h in list(self.handles):
            if h.thread is not None:
                h.thread.join(timeout=10.0)
            h.reaped = True
            observe.health.clear_state(h.component)
        self.handles.clear()
        if observe.enabled():
            observe.gauge("tdx.fleet.replicas").set(0)
            observe.gauge("tdx.fleet.ready_replicas").set(0)

    def __enter__(self) -> "ServeFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- the replica thread -------------------------------------------------

    def _make_on_token(self, h: ReplicaHandle):
        """Per-replica stream adapter with FLEET-level dedupe: the
        engine dedupes replayed positions within ONE engine, but a
        request requeued onto a new replica regenerates from position 1
        — the client must not hear those positions twice."""
        counts: Dict[str, int] = {}  # this replica's delivered positions

        def _on_token(rid: str, token: int) -> None:
            pos = counts.get(rid, 0) + 1
            counts[rid] = pos
            with self._stream_lock:
                if pos <= self._stream_pos.get(rid, 0):
                    return  # already streamed by a previous replica
                self._stream_pos[rid] = pos
                # Delivered-token log: a mid-decode deadline rejection
                # carries these back to the requester (tokens-so-far).
                self.partial.setdefault(rid, []).append(token)
                # Hedge-race arbitration: the replica that delivered the
                # request's FIRST token wins; the controller cancels the
                # other copy on its next tick (_settle_hedges).
                if pos == 1:
                    self._first_replica[rid] = h.idx
                    # First token pins the served version for partial-
                    # output attribution (a stale_version / deadline
                    # rejection's tokens oracle-check against THESE
                    # weights); a completion overwrites it with the
                    # finishing replica's stamp — same version by the
                    # pinning invariant.
                    self.served_version[rid] = h.weight_version
            # Read at call time, not closure-capture at spin-up: a
            # driver may install the hook on a fleet whose replicas
            # are already serving (open-loop TTFT measurement).
            user = self.on_token
            if user is not None:
                user(rid, token)

        return _on_token

    def _maybe_fleet_fault(self, h: ReplicaHandle) -> None:
        """The ``fleet`` chaos site: keyed by replica id, fired from the
        replica's own thread while it has a batch in flight — OUTSIDE
        the engine's step-level retry, so a raise kills the REPLICA (and
        the controller requeues), not just the batch.  Reads the
        process-wide installed plan (``chaos.install`` /
        ``TDX_FAULT_PLAN``) — a thread-local ``override(fault_plan=...)``
        scope is invisible to replica threads anyway."""
        plan = chaos.active_plan()
        if plan is None:
            return
        for fault in plan.take("fleet", h.idx):
            if fault.kind == "flap":
                # Intermittent fault: the replica SURVIVES it — the
                # batch requeues (recompute preemption, same bitwise
                # contract) and the fault lands in the breaker window.
                # A flaky replica therefore keeps serving, keeps
                # faulting, and keeps burning latency until the breaker
                # trips and the controller ejects it — exactly the
                # failure mode proactive guardrails exist for.
                try:
                    chaos.execute_replica_fault(fault)
                except Exception:
                    h.note_fault("flap")
                    if h.engine is not None:
                        with self.device_lock:
                            h.engine.requeue_active(reason="fault")
                continue
            chaos.execute_replica_fault(fault)

    def _replica_main(self, h: ReplicaHandle) -> None:
        chaos.set_cancel_event(h.stop_evt)
        try:
            with tdx_config.bind(h.bound_cfg):
                with self.device_lock:
                    engine = self._spin_up(h)
                h.bring_up_seconds = engine.bring_up_seconds
                h.capture_seconds = engine.capture_seconds
                h.bring_up_warm = (
                    "miss" not in set(engine.bring_up_outcomes.values()))
                if h.bring_up_warm and observe.enabled():
                    observe.gauge("tdx.fleet.spin_up_warm_s").set(
                        round(engine.bring_up_seconds, 3))
                if self.params is None:
                    self.params = engine.model.state_dict()
                self.version_params.setdefault(h.weight_version,
                                               engine.model.state_dict())
                if h.weight_version is not None and not h.reaped:
                    observe.health.set_info(h.component,
                                            version=h.weight_version)
                h.set_state("serving")
                h.beat()
                self._wake.set()
                self._serve_loop(h, engine)
        except BaseException as e:  # noqa: BLE001 — the death IS the signal
            h.error = e
            h.set_state("preempted" if isinstance(e, chaos.ReplicaPreempted)
                        else "failed")
            # The dead replica's graphs go now, under the device lock, not
            # with its handle on whatever thread drops it: destroyed during
            # another replica's capture they would invalidate it (C16).
            # Its pool stays until the handle is dropped.
            if h.engine is not None:
                try:
                    with self.device_lock:
                        h.engine.drop_graphs()
                except Exception:  # noqa: BLE001 — a broken device: the
                    pass           # death above is what is reported
        finally:
            self._wake.set()

    def _spin_up(self, h: ReplicaHandle) -> ServeEngine:
        engine = spin_up_replica(
            self.model, family=self.family, serve_cfg=self.serve_cfg,
            seed=self._seed, param_dtype=self._param_dtype,
            sample_len=self._sample_len, on_token=self._make_on_token(h),
            on_complete=lambda rid, toks, logits: (
                h.done.append((rid, toks, logits)), self._wake.set()),
            on_cancel=lambda rid, toks, active: (
                h.cancelled.append((rid, toks, active)), self._wake.set()),
            device=self.device, health_component=h.component,
            slo_name=h.slo_name,
        )
        h.engine = engine
        if h.params_override is not None:
            # GREEN bring-up: the rolled checkpoint's weights are copied
            # into the captured programs' parameter storages before the
            # replica serves, so nothing is recaptured.
            engine.install_params(h.params_override,
                                  version=h.weight_version)
        return engine

    def _serve_loop(self, h: ReplicaHandle, engine: ServeEngine) -> None:
        lock = self.device_lock
        while not h.stop_evt.is_set():
            if h.drain_evt.is_set():
                leftover = list(h.inbox)     # never admitted; hand back
                h.inbox.clear()
                with lock:
                    leftover.extend(engine.drain())
                    engine.release_kv()
                h.leftover = leftover
                h.set_state("drained")
                return
            while h.cancels:
                # Controller-issued cancellations (hedge losers, doomed
                # dispatches): drop the copy wherever it is: inbox,
                # engine queue, or an ACTIVE LANE, whose pages go back
                # to the pool right now.  No on_cancel echo: the
                # controller initiated this and already bookkept it.
                rid, reason = h.cancels.popleft()
                for r in list(h.inbox):
                    if r.rid == rid:
                        try:
                            h.inbox.remove(r)
                        except ValueError:
                            pass  # popped by the submit loop meanwhile
                with lock:
                    toks = engine.cancel(rid, reason=reason)
                if toks:  # non-empty ⇒ an active lane was cancelled
                    observe.counter("tdx.fleet.cancelled_lanes").inc()
            while h.inbox:
                req = h.inbox.popleft()
                req.arrival_step = 0  # fleet ticks ≠ this engine's steps
                try:
                    engine.submit(req)
                except ValueError as e:
                    h.bad.append((req.rid, str(e)))
            if engine.active or engine.waiting:
                if engine.active:
                    # Mid-batch, by contract; outside the device lock, so
                    # a hang stalls this replica only.
                    self._maybe_fleet_fault(h)
                with lock:
                    engine.step()
                h.beat()
                if h.done:
                    self._wake.set()
            else:
                h.beat()
                h.work_evt.wait(0.002)
                h.work_evt.clear()
        # Stop-initiated exit (fleet shutdown, or a reaped/aborted
        # canary): free the pool HERE, so a shutdown racing an in-flight
        # scale-up or roll never leaks KV pages.  Active lanes are
        # preempted first, which frees their pages and keeps the
        # recompute contract if they ever run again.
        with lock:
            if engine.active:
                engine.requeue_active(reason="stop")
            engine.release_kv()


def params_model(family: str, cfg: TransformerConfig,
                 params) -> torch.nn.Module:
    """The family's module for ``cfg`` whose parameters ARE the tensors of
    ``params`` (a state dict; nothing is copied or allocated): what the
    oracle runs for a weight version."""
    model = make_model(family, cfg, device="meta")
    model.load_state_dict(params, assign=True)
    return model.eval()
