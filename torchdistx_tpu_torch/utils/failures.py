"""Failure detection + elastic (checkpoint-restart) recovery (counterpart
of ``torchdistx_tpu/utils/failures.py``).

The loop is the JAX package's, chaos-hardened the same way: every failure
mode it claims to survive is injectable via
:mod:`torchdistx_tpu_torch.chaos` and proven survived in the CPU tests
(``tests/test_torch_failures.py`` holds it against the JAX loop):

* :func:`device_health` — active probe: run a tiny computation on every
  visible CUDA device and report per-device status/latency, each probe
  bounded by a deadline (catches the "device wedged but enumerated"
  state a passive check misses — without itself hanging on it);
* :class:`FailureDetector` — thresholded repeated probing, suitable for a
  sidecar thread or a between-steps check;
* :func:`run_elastic` — a step-loop wrapper that checkpoints every N
  steps (with integrity manifests, :mod:`.checkpoint`) and survives:

  - **raised runtime errors** (``retry_on``): restore latest verified
    checkpoint, resume, up to a restart budget — with exponential
    backoff and a :func:`device_health` re-probe between restarts;
  - **hung steps** (``step_deadline``): a watchdog abandons a step that
    never returns and treats it as a retryable failure;
  - **corrupted checkpoints**: restore verifies before reading,
    quarantines bad directories to ``step_N.corrupt``, and falls back to
    the next-newest verified step instead of crashing;
  - **announced preemptions** (SIGTERM): finish the current step, write
    a final committed checkpoint plus a ``CLEAN_EXIT.json`` marker, and
    return (or ``exit 0`` with ``exit_on_drain=True``) so the relauncher
    resumes losslessly with ``resume=True``.

What differs from the JAX loop, all from PyTorch's in-place state:

* A train state (:func:`..parallel.make_train_step`'s live module and
  optimizer) is restored IN PLACE — every parameter, every optimizer
  entry with its step counter, and the step count — so a step that
  raised half-way leaves nothing behind; a pytree state is restored into
  new tensors, as JAX returns new arrays.
* A step the watchdog abandons could go on writing the live module after
  the loop restored it.  The worker is cancelled (an injected hang wakes
  and returns without running the step), and before an in-place restore
  the loop waits for it to end; if it does not within the grace period,
  the loop raises instead of restoring under a live writer (relaunch
  with ``resume=True``).  This is the contract (ROADMAP C9), not a gap:
  the JAX loop may restore beside a running step because its arrays are
  immutable, but an eager step holds the live module and optimizer
  themselves, so a restore into fresh storage would still take the
  step's ``.grad`` writes into the rebound parameters and its
  ``opt.step()`` into a module the next step trains, and a Python thread
  cannot be killed.
* The default ``retry_on`` is the port's retryable set
  (:func:`..cuda_bridge.materialize._retryable_errors`: the chaos error
  and ``torch.cuda.OutOfMemoryError``), never a bare ``RuntimeError``: a
  sticky CUDA error poisons the context, so a retry can only loop.
* On a process group every rank runs the loop: saves are collective,
  rank 0 alone writes markers, renames and prunes, with a barrier after
  each, and the ranks agree each step on a preemption notice (one
  all-reduce of a flag), so they drain at the same step.

Telemetry: counters ``tdx.elastic.restarts`` / ``.watchdog_kills`` /
``.drains`` / ``.drain_failures`` / ``.unhealthy_restarts``,
``tdx.ckpt.verify_fail`` / ``.quarantined``,
``tdx.chaos.injected{kind=...}``; spans ``ckpt.save`` / ``ckpt.restore``
/ ``ckpt.verify``; the ``elastic`` liveness heartbeat
(:func:`..observe.health.beat`).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal
import sys
import threading
import time
from collections import deque
from collections.abc import Sequence as SequenceABC
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Optional,
    Sequence,
    Tuple,
    Type,
)

import torch

from .. import chaos, observe
from .logging import get_logger

__all__ = [
    "FailureDetector",
    "ReplayWindowExceeded",
    "StepHangError",
    "device_health",
    "run_elastic",
]

CLEAN_EXIT_MARKER = "CLEAN_EXIT.json"

# How long an in-place restore waits for a step the watchdog abandoned.
_ABANDONED_GRACE_S = 5.0

# device key -> abandoned probe thread (see device_health): while one is
# still wedged, re-probes of that device are refused instead of stacking
# another doomed thread per poll.  _PROBE_LOCKS serializes the whole
# check→probe→register sequence PER DEVICE, so two concurrent callers
# cannot both pass the stuck-check and each leak an abandoned thread.
_STUCK_PROBES: Dict[str, threading.Thread] = {}
_PROBE_LOCKS: Dict[str, threading.Lock] = {}
_stuck_probes_lock = threading.Lock()


def _probe_lock(device_key: str) -> threading.Lock:
    with _stuck_probes_lock:
        return _PROBE_LOCKS.setdefault(device_key, threading.Lock())


class StepHangError(RuntimeError):
    """A step exceeded the watchdog deadline and its worker thread was
    abandoned.  Always treated as retryable by :func:`run_elastic`."""


class ReplayWindowExceeded(RuntimeError):
    """A restore targeted a step older than the retained batch window.

    The replay window only holds batches since the last committed
    checkpoint (so streaming loaders work and host memory stays flat);
    rewinding past it is impossible *in this process*.  The documented
    contract: relaunch with ``resume=True`` — a fresh process replays
    from a fresh iterator and can reach any committed step."""


def _visible_devices() -> List[torch.device]:
    """Every CUDA device; the CPU in a process that has none (where it
    computes, so a CPU run probes it)."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def device_health(
    devices: Optional[Sequence] = None, *, deadline: Optional[float] = 30.0
) -> Dict[str, Any]:
    """Actively probe each device with a tiny computation (a launch, a
    sum, and the host read that synchronizes it).

    Returns ``{"healthy": bool, "devices": [{"id", "platform", "ok",
    "latency_ms", "error"}, ...]}``.  A probe failure marks the device
    (and the report) unhealthy instead of raising.  ``devices`` defaults
    to every CUDA device (the CPU in a process without one).

    Each per-device probe is bounded by ``deadline`` seconds — a wedged
    device accepts work and never completes it, so an unbounded probe
    would hang in exactly the state it exists to detect.  The probe runs
    on a daemon thread that is ABANDONED on timeout.  While a device's
    abandoned probe is still wedged, later calls report it unhealthy
    WITHOUT spawning another thread, so repeated polling
    (:class:`FailureDetector`) leaks at most one thread per wedged
    device, not one per probe.  ``deadline=None`` probes inline.
    """
    devices = [torch.device(d) for d in
               (devices if devices is not None else _visible_devices())]
    report = []
    for d in devices:
        key = str(d)
        entry: Dict[str, Any] = {"id": d.index if d.index is not None else 0,
                                 "platform": d.type, "ok": True,
                                 "latency_ms": None, "error": None}

        def _probe(entry=entry, d=d):
            t0 = time.perf_counter()
            try:
                x = torch.ones((8,), dtype=torch.float32, device=d)
                val = float(x.sum())
                if val != 8.0:
                    raise RuntimeError(f"probe computed {val} != 8.0")
                entry["latency_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
            except Exception as e:  # noqa: BLE001 — any device error = unhealthy
                entry["ok"] = False
                entry["error"] = f"{type(e).__name__}: {e}"[:200]

        # The per-device lock spans check → probe → register, so N
        # concurrent health checks serialize on each device instead of
        # all passing the stuck-check and leaking a thread apiece.
        with _probe_lock(key):
            with _stuck_probes_lock:
                stuck = _STUCK_PROBES.get(key)
            if stuck is not None and stuck.is_alive():
                entry = {**entry, "ok": False,
                         "error": "previous probe still wedged; not re-probing"}
                report.append(entry)
                continue
            if deadline is None:
                _probe()
            else:
                t = threading.Thread(target=_probe, daemon=True,
                                     name=f"tdx-health-probe-{key}")
                t.start()
                t.join(deadline)
                if t.is_alive():
                    with _stuck_probes_lock:
                        _STUCK_PROBES[key] = t
                    # Fresh dict: whatever the abandoned thread writes
                    # later must not flip a verdict already reported.
                    entry = {**entry, "ok": False, "latency_ms": None,
                             "error": f"probe timed out after {deadline}s "
                                      f"(device wedged?)"}
                else:
                    with _stuck_probes_lock:
                        _STUCK_PROBES.pop(key, None)
        report.append(entry)
    return {"healthy": all(e["ok"] for e in report), "devices": report}


class FailureDetector:
    """Repeated probing with a consecutive-failure threshold.

    Call :meth:`check` between steps (or from a sidecar thread); it
    returns the current health and fires ``on_failure`` once when the
    threshold is crossed."""

    def __init__(
        self,
        *,
        threshold: int = 2,
        devices: Optional[Sequence] = None,
        on_failure: Optional[Callable[[Dict[str, Any]], None]] = None,
    ):
        self.threshold = threshold
        self.devices = devices
        self.on_failure = on_failure
        self.consecutive_failures = 0
        self.last_report: Optional[Dict[str, Any]] = None
        self._fired = False

    def check(self) -> bool:
        self.last_report = device_health(self.devices)
        if self.last_report["healthy"]:
            self.consecutive_failures = 0
            self._fired = False
            return True
        self.consecutive_failures += 1
        if self.consecutive_failures >= self.threshold and not self._fired:
            self._fired = True
            if self.on_failure is not None:
                self.on_failure(self.last_report)
        return False


def _default_retry_on() -> Tuple[Type[BaseException], ...]:
    """The port's retryable set: the chaos ``raise``/``flap`` error and
    ``torch.cuda.OutOfMemoryError`` — never a sticky CUDA error."""
    from ..cuda_bridge.materialize import _retryable_errors

    return _retryable_errors()


_END = object()  # batch-iterator exhaustion sentinel


class _ReplayWindow:
    """Bounded batch buffer: holds only the batches consumed since the
    last committed checkpoint, so streaming loaders work and host memory
    stays flat at ``O(checkpoint_every)`` instead of ``O(len(batches))``.

    ``start`` is the newest committed step; batches for steps ``<= start``
    have been released.  :meth:`get` pulls lazily from the iterator;
    :meth:`commit` releases the prefix; :meth:`check_rewind` enforces the
    window contract for restores (see :class:`ReplayWindowExceeded`).

    A ``Sequence`` input (list/tuple — random access, owned by the
    caller) skips the buffering entirely: every step stays addressable at
    zero extra memory, so in-process restores can rewind arbitrarily deep
    (the pre-window semantics).  The window contract below applies to
    one-shot iterators only.

    Cross-process resume (``start_step > 0`` on a fresh iterator)
    fast-forwards by consuming and discarding the first ``start_step``
    batches — the data-iterator contract for ``resume=True`` is that it
    restarts from the beginning and is deterministic up to the resume
    point."""

    def __init__(self, batches: Iterable[Any], start_step: int = 0):
        if isinstance(batches, SequenceABC) and not isinstance(batches, (str, bytes)):
            self._seq: Optional[SequenceABC] = batches
            return
        self._seq = None
        self._it = iter(batches)
        self._buf: deque = deque()
        self.start = start_step
        self._pulled = start_step  # highest 1-based step pulled so far
        self._exhausted = False
        for _ in range(start_step):  # fast-forward on resume
            try:
                next(self._it)
            except StopIteration:
                self._exhausted = True
                break

    def get(self, step: int):
        """The batch for 1-based ``step``, or ``_END`` past the data."""
        if self._seq is not None:
            return self._seq[step - 1] if step <= len(self._seq) else _END
        if step <= self.start:
            raise ReplayWindowExceeded(
                f"batch for step {step} was released at the step-{self.start} "
                f"checkpoint commit"
            )
        while self._pulled < step and not self._exhausted:
            try:
                self._buf.append(next(self._it))
                self._pulled += 1
            except StopIteration:
                self._exhausted = True
        if self._pulled < step:
            return _END
        return self._buf[step - self.start - 1]

    def commit(self, step: int) -> None:
        """A checkpoint at ``step`` committed: release batches ``<= step``."""
        if self._seq is not None:
            return
        while self.start < step and self._buf:
            self._buf.popleft()
            self.start += 1
        self.start = max(self.start, step)

    def check_rewind(self, step: int) -> None:
        if self._seq is not None:
            return
        if step < self.start:
            raise ReplayWindowExceeded(
                f"restore targets step {step} but the replay window begins "
                f"after the step-{self.start} commit — batches before it were "
                f"released (streaming input cannot be rewound in-process). "
                f"Relaunch with resume=True: a fresh process replays from a "
                f"fresh data iterator and can resume any committed step "
                f"(docs/robustness.md)."
            )


def run_elastic(
    step_fn: Callable[[Any, Any], Tuple[Any, Any]],
    state: Any,
    batches: Iterable[Any],
    *,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100,
    max_restarts: int = 3,
    retry_on: Optional[Tuple[Type[BaseException], ...]] = None,
    on_metrics: Optional[Callable[[int, Any], None]] = None,
    async_checkpoints: bool = False,
    resume: bool = False,
    max_to_keep: Optional[int] = None,
    step_deadline: Optional[float] = None,
    backoff_base: float = 0.0,
    backoff_max: float = 30.0,
    probe_on_restart: bool = True,
    verify_saves: bool = True,
    drain_on_sigterm: bool = True,
    exit_on_drain: bool = False,
):
    """Run ``state, metrics = step_fn(state, batch)`` over ``batches`` with
    checkpoint-restart elasticity.

    Every ``checkpoint_every`` completed steps the state is saved (DCP +
    integrity manifest, via :mod:`.checkpoint`); ``state`` is a pytree of
    tensors or a :func:`..parallel.make_train_step` train state.  When
    ``step_fn`` raises one of ``retry_on`` (default: the port's retryable
    set, :func:`..cuda_bridge.materialize._retryable_errors`), the newest
    *verified* checkpoint is restored and the loop resumes from the step
    after it, up to ``max_restarts`` times.  Re-raises on budget
    exhaustion or any non-listed exception (fail fast on real bugs).

    ``batches`` may be any iterable, including a one-shot streaming
    loader: only the batches since the last committed checkpoint are
    retained for replay (a restore within that window re-executes them;
    rewinding past it raises :class:`ReplayWindowExceeded` with the
    relaunch contract).

    Hardening knobs:

    ``step_deadline``
        Watchdog: a step running longer than this many seconds is
        abandoned (its worker is cancelled and its results discarded) and
        treated as a retryable failure.  Hung steps raise nothing, so
        without this a wedged device stalls the loop forever.  Before an
        in-place restore of a train state the loop waits up to 5 s for
        the abandoned worker to end, and raises if it has not.  ``None``
        (default) disables the watchdog and runs steps inline.
    ``backoff_base`` / ``backoff_max``
        Exponential backoff before restart *n*: ``min(backoff_max,
        backoff_base * 2**(n-1))`` seconds (``backoff_base=0`` disables).
        A :func:`device_health` re-probe runs after the backoff
        (``probe_on_restart=False`` disables) — an unhealthy report is
        logged and counted, not fatal: the next step failure re-enters
        this path anyway.
    ``verify_saves``
        Integrity-verify each checkpoint right after it commits; a save
        that fails verification is quarantined immediately and the
        previous good checkpoint remains the restore target.  Pruning
        (``max_to_keep``) runs strictly verify-then-prune, so the newest
        *verified* checkpoint is never deleted, and quarantined
        ``step_N.corrupt`` dirs never count toward the keep budget.
    ``drain_on_sigterm`` / ``exit_on_drain``
        Announced-preemption drain: on SIGTERM (main thread only), finish
        the current step, write a final committed checkpoint plus
        ``CLEAN_EXIT.json``, and return early — or ``sys.exit(0)`` with
        ``exit_on_drain=True``, the relauncher contract (exit 0 ⇒ resume
        with ``resume=True`` continues at the exact drained step, no lost
        or repeated optimizer updates).  The previous SIGTERM handler is
        restored on exit.

    With ``resume=True`` the loop first scans ``checkpoint_dir`` for
    committed checkpoints from a PREVIOUS process and continues from the
    newest verified one — a preempted job dies whole and is relaunched,
    so recovery must work across processes, not only within one.  A
    checkpoint written under another mesh or plan (its manifest's
    topology block differs from ``state``'s) is resharded in flight
    (:func:`..reshard.restore_resharded`).  Corrupt candidates are
    quarantined and the scan falls back to older steps.

    With ``async_checkpoints=True`` periodic saves return once the state
    is copied to host memory and write on a background thread; an
    in-flight save is committed
    (manifest + marker + verification) at the next save, restore, drain,
    or exit, so recovery never reads a half-written checkpoint.

    Fault injection for tests comes in two layers: any exception type
    listed in ``retry_on`` triggers the restart path, and
    :mod:`torchdistx_tpu_torch.chaos` fault plans (``TDX_FAULT_PLAN``) inject
    raises, hangs, checkpoint corruption, slow saves, and preemption
    signals at exact steps.

    Returns ``(state, steps_completed, restarts_used)``.
    """
    log = get_logger()
    if max_to_keep is not None and max_to_keep < 1:
        raise ValueError(
            f"max_to_keep must be >= 1 (got {max_to_keep}); the latest "
            f"checkpoint is always needed for recovery."
        )
    retry_on = retry_on or _default_retry_on()
    retryable = tuple(retry_on) + (StepHangError,)
    # Resolved ONCE, on the caller's thread: a thread-local
    # tdx_config.override(fault_plan=...) scope must bind even though the
    # step site fires on watchdog worker threads.
    fault_plan = chaos.active_plan()

    from ..reshard import ReshardError, needs_reshard, restore_resharded
    from .checkpoint import (
        _any_rank,
        _barrier,
        _dist_on,
        _is_writer,
        is_committed,
        is_train_state,
        quarantine_checkpoint,
        restore_checkpoint,
        save_checkpoint,
        verify_checkpoint,
    )

    restarts = 0
    step = 0
    last_saved: Optional[int] = None
    drain = {"requested": False}
    drained = False
    drain_ok = True
    async_saver = None
    pending_async: Optional[Tuple[int, str]] = None
    abandoned: Optional[threading.Thread] = None  # the last killed step
    if async_checkpoints and checkpoint_dir is not None:
        from .checkpoint import AsyncCheckpointSaver

        async_saver = AsyncCheckpointSaver()

    def _ckpt_path(s: int) -> str:
        return os.path.join(checkpoint_dir, f"step_{s}")

    def _on_disk_steps(committed_only: bool = True) -> List[int]:
        if checkpoint_dir is None or not os.path.isdir(checkpoint_dir):
            return []
        out = []
        for name in os.listdir(checkpoint_dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and (not committed_only or is_committed(_ckpt_path(int(m.group(1))))):
                out.append(int(m.group(1)))
        return sorted(out)

    def _prune(step_now: int) -> None:
        # Strictly verify-then-prune (we only get here after the newest
        # save verified clean in _finalize), so pruning can never leave
        # zero restorable checkpoints.  The keep budget counts COMMITTED
        # step_N dirs only; quarantined step_N.corrupt dirs neither count
        # nor get deleted (forensics outrank disk tidiness), while stale
        # uncommitted dirs are deletable junk.
        if max_to_keep is None:
            return
        keep = set(sorted(set(_on_disk_steps()) | {step_now})[-max_to_keep:])
        if _is_writer():
            for s in _on_disk_steps(committed_only=False):
                if s not in keep:
                    shutil.rmtree(_ckpt_path(s), ignore_errors=True)
        _barrier()

    def _quarantine(path: str) -> None:
        if _is_writer():
            quarantine_checkpoint(path)
        _barrier()

    def _finalize(step_done: int, path: str) -> bool:
        """Post-commit bookkeeping for a durable save: verify, adopt as
        the restore target, release replayed batches, prune, then let
        chaos damage it (post-commit is the bit-rot model)."""
        nonlocal last_saved
        if verify_saves:
            ok, reason = verify_checkpoint(path)
            if not ok:
                log.error(
                    "run_elastic: freshly saved checkpoint %s failed "
                    "verification (%s); quarantined — previous checkpoint "
                    "remains the restore target", path, reason,
                )
                _quarantine(path)
                return False
        last_saved = step_done
        window.commit(step_done)
        _prune(step_done)
        chaos.maybe_inject("save", step_done, path=path, plan=fault_plan)
        return True

    def _commit_pending() -> None:
        nonlocal pending_async
        if async_saver is None:
            return
        async_saver.wait_until_finished()  # writes manifest + marker
        if pending_async is not None:
            s, p = pending_async
            pending_async = None
            _finalize(s, p)

    def save(step_now: int, state_now: Any, *, sync: bool = False) -> bool:
        """Returns False when a SYNC save landed corrupt (quarantined);
        async saves report True — their durability verdict arrives at the
        next commit."""
        nonlocal pending_async
        if checkpoint_dir is None:
            return True
        path = _ckpt_path(step_now)
        _commit_pending()
        if async_saver is not None and not sync:
            async_saver.save(path, state_now)
            pending_async = (step_now, path)
            return True
        save_checkpoint(path, state_now)
        return _finalize(step_now, path)

    def _restore_best(verify_window: bool) -> Tuple[int, Any]:
        """Newest verified checkpoint on disk, quarantining every corrupt
        candidate encountered on the way down."""
        for s in reversed(_on_disk_steps()):
            path = _ckpt_path(s)
            ok, reason = verify_checkpoint(path)
            if not ok:
                log.error(
                    "run_elastic: checkpoint %s failed verification (%s); "
                    "quarantining and falling back", path, reason,
                )
                _quarantine(path)
                continue
            if verify_window:
                window.check_rewind(s)  # raises with the relaunch contract
            try:
                # The restore chaos site fires INSIDE the containment: an
                # injected restore failure must fall back like a real one,
                # not crash the recovery path it exists to exercise.
                chaos.maybe_inject("restore", s, path=path, plan=fault_plan)
                if needs_reshard(path, state):
                    # Checkpoint was written under a different topology
                    # (mesh shape / axis names / sharding plan) than the
                    # relaunch state: stream it through the reshard engine
                    # instead of crashing on a sharding mismatch.
                    observe.counter("tdx.reshard.elastic_reshards").inc()
                    observe.instant(
                        "reshard.elastic", category="reshard", path=path,
                    )
                    log.warning(
                        "run_elastic: checkpoint %s topology differs from "
                        "the relaunch mesh; resharding in-flight", path,
                    )
                    return s, restore_resharded(
                        path, target=state, chaos_plan=fault_plan
                    )
                return s, restore_checkpoint(path, target=state)
            except ReshardError:
                # Degrade-never-corrupt: a failed reshard proves nothing
                # about the SOURCE checkpoint (it verified clean above),
                # so it must not be quarantined.  Surface the typed error.
                raise
            except Exception as e:  # noqa: BLE001 — torn write below manifest
                log.error(
                    "run_elastic: restore of verified checkpoint %s raised "
                    "(%s: %s); quarantining and falling back",
                    path, type(e).__name__, str(e)[:200],
                )
                _quarantine(path)
        raise RuntimeError(
            f"run_elastic: no verified checkpoint available under "
            f"{checkpoint_dir!r}."
        )

    def restore() -> Tuple[int, Any]:
        nonlocal last_saved
        if checkpoint_dir is None or last_saved is None:
            raise RuntimeError(
                "run_elastic: failure with no checkpoint to restore "
                "(set checkpoint_dir to enable recovery)."
            )
        _commit_pending()  # commit any in-flight write first
        s, restored = _restore_best(verify_window=True)
        last_saved = s
        return s, restored

    def _backoff_and_probe(nth: int) -> None:
        if backoff_base > 0:
            delay = min(backoff_max, backoff_base * (2 ** (nth - 1)))
            log.warning(
                "run_elastic: backing off %.2fs before restart %d", delay, nth
            )
            time.sleep(delay)
        if probe_on_restart:
            rep = device_health()
            if not rep["healthy"]:
                observe.counter("tdx.elastic.unhealthy_restarts").inc()
                bad = [e for e in rep["devices"] if not e["ok"]]
                log.warning(
                    "run_elastic: device health probe UNHEALTHY before "
                    "restart: %s", bad[:3],
                )

    def _call_step(state_now: Any, batch: Any, step_no: int):
        nonlocal abandoned
        cancel = threading.Event()

        def _invoke():
            chaos.maybe_inject("step", step_no, plan=fault_plan)
            if cancel.is_set():
                # Abandoned while the fault held it: the step must not
                # run, it would write state the loop has restored.
                return None
            return step_fn(state_now, batch)

        if step_deadline is None:
            return _invoke()
        box: Dict[str, Any] = {}

        def _target():
            # Abandoned-thread hygiene: injected chaos hangs on this
            # thread wake on `cancel` and let it exit, instead of each
            # watchdog kill leaking a thread asleep for the hang's full
            # duration.  (A REAL wedged CUDA call still pins its thread —
            # nothing in-process can cancel that.)
            chaos.set_cancel_event(cancel)
            try:
                box["result"] = _invoke()
            except BaseException as e:  # noqa: BLE001 — relayed to the caller
                box["error"] = e

        t = threading.Thread(
            target=_target, daemon=True, name=f"tdx-step-{step_no}"
        )
        t.start()
        t.join(step_deadline)
        if t.is_alive():
            cancel.set()
            abandoned = t
            observe.counter("tdx.elastic.watchdog_kills").inc()
            observe.instant("elastic.watchdog_kill", category="elastic",
                            step=step_no, deadline_s=step_deadline)
            observe.flight_dump("step_watchdog_kill", step=step_no,
                                deadline_s=step_deadline)
            raise StepHangError(
                f"step {step_no} exceeded the {step_deadline}s watchdog "
                f"deadline; worker thread abandoned (a result that arrives "
                f"later is discarded — state comes from the checkpoint)"
            )
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _await_abandoned() -> None:
        """An in-place restore must not race a step the watchdog
        abandoned: wait for its worker to end (a cancelled fault returns
        at once), else refuse."""
        nonlocal abandoned
        if abandoned is None:
            return
        t, abandoned = abandoned, None
        if not is_train_state(state):
            return  # a pytree restores into new tensors
        t.join(_ABANDONED_GRACE_S)
        if t.is_alive():
            raise RuntimeError(
                f"run_elastic: the step abandoned by the watchdog is still "
                f"running after {_ABANDONED_GRACE_S}s; it holds the live "
                f"module and optimizer and its thread cannot be stopped, so "
                f"nothing is restored under it: restart the process and "
                f"call run_elastic(..., resume=True) to continue from the "
                f"last verified checkpoint")

    def _drain_now() -> bool:
        """Drain on the preemption notice; returns whether the final
        checkpoint is durable AND verified.  A drain save that lands
        corrupt (quarantined by _finalize) must NOT advertise a clean
        exit: CLEAN_EXIT.json is the relauncher's promise that
        ``resume=True`` continues at exactly this step, and the
        quarantined checkpoint cannot honor it — resume must fall back
        to the previous verified step instead."""
        log.warning(
            "run_elastic: preemption notice received; draining at step %d",
            step,
        )
        observe.counter("tdx.elastic.drains").inc()
        observe.instant("elastic.drain", category="elastic", step=step)
        observe.flight_dump("sigterm_drain", step=step)
        ok = True
        if checkpoint_dir is not None:
            _commit_pending()
            if last_saved != step:
                ok = save(step, state, sync=True)  # durable before exit
            if ok:
                if _is_writer():
                    with open(
                        os.path.join(checkpoint_dir, CLEAN_EXIT_MARKER), "w"
                    ) as f:
                        json.dump(
                            {"step": step, "reason": "sigterm-drain",
                             "pid": os.getpid(), "time": time.time()},
                            f,
                        )
                _barrier()
            else:
                observe.counter("tdx.elastic.drain_failures").inc()
                observe.instant(
                    "elastic.drain_failure", category="elastic", step=step
                )
                log.error(
                    "run_elastic: drain checkpoint at step %d failed "
                    "verification and was quarantined; NOT writing %s — "
                    "resume will use the previous verified checkpoint "
                    "(step %s)", step, CLEAN_EXIT_MARKER, last_saved,
                )
        return ok

    import torch.distributed as dist

    agree_on_drain = (drain_on_sigterm and _dist_on()
                      and dist.get_world_size() > 1)
    prev_handler: Any = None
    handler_installed = False
    if drain_on_sigterm and threading.current_thread() is threading.main_thread():
        def _on_sigterm(signum, frame):  # noqa: ARG001 — signal signature
            drain["requested"] = True  # defer all work to the step loop

        prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        handler_installed = True

    # Step-0 checkpoint so a failure before the first periodic save is
    # still recoverable.  The finally block commits any in-flight async
    # write even on a re-raise, so the checkpoint a caller would resume
    # from is never left half-written.
    try:
        resumed_from: Optional[int] = None
        if resume and _on_disk_steps():
            try:
                resumed_from, state = _restore_best(verify_window=False)
            except ReshardError:
                # A typed reshard failure is NOT "no checkpoint": the
                # source verified clean and only the topology migration
                # failed.  Starting fresh would silently discard a
                # perfectly good checkpoint — surface it instead.
                raise
            except RuntimeError:
                # Every candidate failed verification and is quarantined.
                # A crash here would only delay the inevitable: the next
                # relaunch would see an empty scan and start fresh — do
                # that now, loudly, with the forensics preserved in the
                # .corrupt dirs.
                log.error(
                    "run_elastic: resume found NO verified checkpoint under "
                    "%s (all candidates quarantined); starting fresh",
                    checkpoint_dir,
                )
        if resumed_from is not None:
            last_saved = step = resumed_from
            window = _ReplayWindow(batches, start_step=resumed_from)
            log.info(
                "run_elastic: resumed from %s (previous process)",
                _ckpt_path(resumed_from),
            )
        else:
            window = _ReplayWindow(batches)
            save(0, state)

        while True:
            # Liveness heartbeat behind /healthz: a wedged step that the
            # watchdog hasn't killed yet (or a hang with no deadline set)
            # goes stale here and flips the probe to 503.
            observe.health.beat("elastic", period_hint_s=step_deadline)
            if agree_on_drain:
                # A notice reaches each rank at its own time; the ranks
                # drain together at the first step boundary any has it.
                drain["requested"] = _any_rank(drain["requested"])
            if drain["requested"]:
                drain_ok = _drain_now()
                drained = True
                break
            batch = window.get(step + 1)
            if batch is _END:
                break
            try:
                state, metrics = _call_step(state, batch, step + 1)
                step += 1
                if on_metrics is not None:
                    on_metrics(step, metrics)
                if checkpoint_dir is not None and step % checkpoint_every == 0:
                    save(step, state)
            except retryable as e:
                restarts += 1
                observe.counter("tdx.elastic.restarts").inc()
                if restarts > max_restarts:
                    log.error(
                        "run_elastic: restart budget exhausted (%d)", max_restarts
                    )
                    raise
                log.warning(
                    "run_elastic: step %d failed (%s: %s); restoring step %s "
                    "(restart %d/%d)",
                    step + 1, type(e).__name__, str(e)[:120], last_saved,
                    restarts, max_restarts,
                )
                _backoff_and_probe(restarts)
                _await_abandoned()
                step, state = restore()
    finally:
        if handler_installed:
            signal.signal(signal.SIGTERM, prev_handler)
        if async_saver is not None:
            try:
                # Commit (manifest + verify + prune) the final in-flight
                # write; close() must run regardless (else the writer
                # thread leaks), and a failed background write must not mask an
                # in-flight training exception (stays as __context__).
                _commit_pending()
            finally:
                async_saver.close()
    if drained and exit_on_drain:
        if not drain_ok:
            # Exit 0 is the relauncher's lossless-resume signal; a
            # quarantined drain checkpoint cannot honor it.
            log.error(
                "run_elastic: drain checkpoint failed verification; "
                "exiting 1 at step %d (resume falls back to the previous "
                "verified checkpoint)", step,
            )
            sys.exit(1)
        log.info("run_elastic: clean drain exit at step %d (rc 0)", step)
        sys.exit(0)
    return state, step, restarts
