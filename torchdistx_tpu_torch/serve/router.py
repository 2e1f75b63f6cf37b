"""Fleet request router (the port's own copy of
``torchdistx_tpu/serve/router.py``): bounded admission, deadlines,
least-work dispatch.

The routing half of the serve fleet (:mod:`.fleet`), kept separate and
engine-free so its policies are testable as plain data structures:

* :class:`AdmissionQueue`: the ONE global intake for the whole fleet: a
  bounded FIFO (``max_depth``) whose overflow is a **typed rejection**
  (:class:`FleetRejected` carrying a :class:`Rejection`), never a silent
  drop, plus per-request admission deadlines: a request still queued
  past its deadline is expired with reason ``deadline``.  Requeues
  (requests pulled back from a dead or draining replica) re-enter at the
  FRONT and are exempt from both the bound and the deadline: an admitted
  request is a promise; a replica fault may cost it latency, never its
  response.
* :func:`least_outstanding`: the dispatch policy: route to the ready
  replica with the least outstanding work, measured in *remaining token
  budget* rather than request count.  Ties break by listing order, which
  the fleet keeps stable (replica launch order).
* :func:`prefix_affinity`: prefer the replica whose prefix cache
  (:mod:`.prefix`) holds the longest cached prefix of the request's
  tokens, falling back to least-outstanding-work among equals.

The queue is thread-safe (callers submit from any thread; the fleet
controller drains it from its tick loop); the dispatch policy is pure.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, TypeVar

from .engine import Request

__all__ = [
    "AdmissionQueue",
    "FleetRejected",
    "QueueEntry",
    "Rejection",
    "least_outstanding",
    "prefix_affinity",
]

REJECT_REASONS = ("queue_full", "deadline", "invalid", "shed",
                  "stale_version")


@dataclass(frozen=True)
class Rejection:
    """One typed rejection: the client gets a reason it can act on
    (back off / retry elsewhere / fix the request), the fleet counts it
    (``tdx.fleet.rejected_requests``), and nothing is silently dropped.
    A ``deadline`` rejection issued after admission (a lane cancelled
    mid-decode, docs/serving.md §Guardrails) carries the tokens the
    client already received in ``tokens``; ``shed`` is the brownout
    reason (low-priority work dropped under sustained pressure);
    ``stale_version`` is the rollover reason — a request that already
    streamed tokens under a weight version whose last replica died
    mid-roll can neither migrate to the new weights (torn output) nor
    wait for a version that is never coming back, so it terminates with
    its delivered-so-far tokens (docs/serving.md §Weight rollover)."""

    rid: str
    reason: str  # one of REJECT_REASONS
    detail: str = ""
    tokens: Tuple[int, ...] = ()  # delivered-so-far (mid-decode deadline)


class FleetRejected(ValueError):
    """Raised by :meth:`AdmissionQueue.push` / ``ServeFleet.submit`` —
    the typed-rejection surface for direct callers."""

    def __init__(self, rejection: Rejection):
        super().__init__(
            f"request {rejection.rid} rejected ({rejection.reason})"
            + (f": {rejection.detail}" if rejection.detail else "")
        )
        self.rejection = rejection


@dataclass
class QueueEntry:
    """A queued request with its admission bookkeeping."""

    req: Request
    enqueued_t: float
    deadline_s: Optional[float] = None  # None = no deadline (requeues)

    def expired(self, now: float) -> bool:
        return (self.deadline_s is not None
                and (now - self.enqueued_t) > self.deadline_s)


class AdmissionQueue:
    """Bounded global admission queue; see the module docstring."""

    def __init__(self, max_depth: int = 256):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        self._lock = threading.Lock()
        self._front: "deque[QueueEntry]" = deque()  # requeues, served first
        self._fifo: "deque[QueueEntry]" = deque()

    def push(self, req: Request, *, deadline_s: Optional[float] = None,
             now: Optional[float] = None) -> QueueEntry:
        """Admit ``req``; raises :class:`FleetRejected` (``queue_full``)
        when the bound is hit."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if len(self._front) + len(self._fifo) >= self.max_depth:
                raise FleetRejected(Rejection(
                    req.rid, "queue_full",
                    f"admission queue at max_depth={self.max_depth}",
                ))
            entry = QueueEntry(req, now, deadline_s)
            self._fifo.append(entry)
            return entry

    def requeue(self, req: Request) -> QueueEntry:
        """Re-admit a request a replica gave back (death or drain): front
        of the line, exempt from the bound and from deadlines — it was
        admitted once and must complete."""
        with self._lock:
            entry = QueueEntry(req, time.monotonic(), None)
            self._front.append(entry)
            return entry

    def pop(self, *, now: Optional[float] = None) -> Optional[QueueEntry]:
        """Next dispatchable entry (requeues first), or None.  Expired
        entries are never returned — collect them via :meth:`expire`."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._front:
                return self._front.popleft()
            while self._fifo:
                entry = self._fifo.popleft()
                if entry.expired(now):
                    self._fifo.appendleft(entry)  # expire() owns it
                    return None
                return entry
            return None

    def expire(self, *, now: Optional[float] = None) -> List[Rejection]:
        """Remove every entry past its admission deadline; returns their
        typed rejections (reason ``deadline``)."""
        now = time.monotonic() if now is None else now
        out: List[Rejection] = []
        with self._lock:
            keep: "deque[QueueEntry]" = deque()
            for entry in self._fifo:
                if entry.expired(now):
                    waited = now - entry.enqueued_t
                    out.append(Rejection(
                        entry.req.rid, "deadline",
                        f"queued {waited:.3f}s > deadline "
                        f"{entry.deadline_s:.3f}s",
                    ))
                else:
                    keep.append(entry)
            self._fifo = keep
        return out

    def shed_low_priority(self, min_priority: int) -> List[Rejection]:
        """Brownout shedding: remove every QUEUED entry whose request
        priority is below ``min_priority``; returns their typed
        rejections (reason ``shed``).  The front (requeue) lane is
        exempt — a requeued request is admitted in-flight work, a
        promise the brownout must not break (same contract that exempts
        it from the bound and the deadline)."""
        out: List[Rejection] = []
        with self._lock:
            keep: "deque[QueueEntry]" = deque()
            for entry in self._fifo:
                prio = getattr(entry.req, "priority", 1)
                if prio < min_priority:
                    out.append(Rejection(
                        entry.req.rid, "shed",
                        f"brownout: queued priority {prio} < "
                        f"{min_priority} shed under pressure",
                    ))
                else:
                    keep.append(entry)
            self._fifo = keep
        return out

    def depth(self) -> int:
        with self._lock:
            return len(self._front) + len(self._fifo)

    def __len__(self) -> int:
        return self.depth()

    def drain(self) -> List[QueueEntry]:
        """Remove and return everything (shutdown)."""
        with self._lock:
            out = list(self._front) + list(self._fifo)
            self._front.clear()
            self._fifo.clear()
            return out


H = TypeVar("H")


def least_outstanding(
    candidates: Sequence[H], load: Callable[[H], int],
) -> Optional[H]:
    """The dispatch policy: the candidate with the least outstanding
    work (remaining token budget), ties broken by listing order.  Pure —
    the fleet passes its ready replicas in launch order, tests pass
    whatever they like."""
    best: Optional[Tuple[int, int]] = None
    pick: Optional[H] = None
    for i, h in enumerate(candidates):
        key = (load(h), i)
        if best is None or key < best:
            best, pick = key, h
    return pick


def prefix_affinity(
    candidates: Sequence[H],
    load: Callable[[H], int],
    match_len: Callable[[H], int],
) -> Tuple[Optional[H], bool]:
    """Prefix-aware dispatch: the candidate with the LONGEST cached
    prefix of the request (``match_len``, in tokens), ties broken by
    least outstanding work then listing order — with no cached prefix
    anywhere this degenerates to exactly :func:`least_outstanding`.
    Returns ``(pick, hit)``: ``hit`` is True when the pick actually had
    a cached prefix (the ``tdx.fleet.prefix_affinity_hits`` signal).
    Pure — the fleet passes thread-safe probes into live replicas."""
    best: Optional[Tuple[int, int, int]] = None
    pick: Optional[H] = None
    for i, h in enumerate(candidates):
        key = (-match_len(h), load(h), i)
        if best is None or key < best:
            best, pick = key, h
    return pick, bool(best is not None and best[0] < 0)
