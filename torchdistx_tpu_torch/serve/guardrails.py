"""Fleet guardrails (the port's own copy of
``torchdistx_tpu/serve/guardrails.py``): the pure policy pieces that turn
"faults cost latency, never a token" into "faults cost **bounded**
latency, never a token".

* :class:`CircuitBreaker`: a sliding fault/hang/slow-tick window per
  replica.  The fleet controller feeds it one observation per replica
  fault (``flap`` chaos faults, slow heartbeats); when the window holds
  ``trip_faults`` observations the breaker trips and the controller
  ejects the replica (drain if responsive, kill if not), quarantines it
  (:class:`QuarantineEntry`, exponential backoff), and later re-admits
  capacity via a HALF-OPEN probe replica that must complete one request
  cleanly before full rotation.
* :class:`Brownout`: hysteretic load-shedding policy, shaped like the
  autoscaler: sustained queue-depth / p95-TTFT pressure past a streak
  threshold enters brownout (queued low-priority work is shed with typed
  ``shed`` rejections and new low-priority work is rejected at the
  door); pressure must stay clear for an exit streak before the fleet
  leaves it.
* :func:`should_hedge`: the hedged-dispatch predicate: a request that
  sat queued past a fraction of its deadline is speculatively dispatched
  to a SECOND replica; first TTFT wins, the loser is cancelled and its
  pages freed.  Greedy decode is deterministic, so the winner's tokens
  are the oracle's whichever replica wins.

Everything here is pure (no clocks of its own, no I/O): the fleet passes
``now``; tests script time directly.  The engine holds the mechanisms
(per-tick deadline cancellation, mid-decode lane cancel), :mod:`.fleet`
the wiring.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Optional, Tuple

__all__ = [
    "Brownout",
    "CircuitBreaker",
    "GuardrailConfig",
    "QuarantineEntry",
    "should_hedge",
]


@dataclass(frozen=True)
class GuardrailConfig:
    """Knobs for all four guardrail mechanisms.  Attach one to
    ``FleetConfig.guardrails`` to arm them; ``None`` (the default)
    keeps the reactive-only fleet."""

    # -- circuit breaker ----------------------------------------------------
    breaker: bool = True
    breaker_window_s: float = 30.0      # sliding observation window
    breaker_trip_faults: int = 3        # observations in window → trip
    slow_tick_s: Optional[float] = None  # beat gap counted as an observation
    quarantine_s: float = 2.0           # initial backoff after a trip
    quarantine_max_s: float = 60.0      # exponential-backoff cap
    backoff_cap_s: Optional[float] = None  # explicit doubling ceiling
    # ``backoff_cap_s`` exists so the probe-failure doubling can be
    # capped BELOW quarantine_max_s: a replica that flapped early in a
    # long run must re-earn rotation in bounded time, not be expelled
    # for the full quarantine_max_s horizon.  None inherits
    # quarantine_max_s (so the default cap is the documented ~60s).
    # -- hedged dispatch ----------------------------------------------------
    hedging: bool = True
    hedge_wait_frac: float = 0.5        # hedge when waited > frac × deadline
    hedge_wait_s: Optional[float] = None  # absolute threshold, deadline-less
    # -- priority brownout --------------------------------------------------
    brownout: bool = True
    brownout_queue_per_replica: float = 8.0  # pressure: queued > this × serving
    brownout_ttft_p95_s: Optional[float] = None  # latency pressure (None = off)
    brownout_enter_consecutive: int = 3
    brownout_exit_consecutive: int = 3
    brownout_priority: int = 1          # shed/reject priority < this

    def __post_init__(self):
        if self.breaker_window_s <= 0:
            raise ValueError(
                f"breaker_window_s must be > 0, got {self.breaker_window_s}")
        if self.breaker_trip_faults < 1:
            raise ValueError(
                f"breaker_trip_faults must be >= 1, got "
                f"{self.breaker_trip_faults}")
        if self.quarantine_s <= 0 or self.quarantine_max_s < self.quarantine_s:
            raise ValueError(
                f"need 0 < quarantine_s <= quarantine_max_s, got "
                f"{self.quarantine_s} / {self.quarantine_max_s}")
        if self.backoff_cap_s is not None and self.backoff_cap_s <= 0:
            raise ValueError(
                f"backoff_cap_s must be > 0, got {self.backoff_cap_s}")
        if not (0.0 <= self.hedge_wait_frac):
            raise ValueError(
                f"hedge_wait_frac must be >= 0, got {self.hedge_wait_frac}")
        if (self.brownout_enter_consecutive < 1
                or self.brownout_exit_consecutive < 1):
            raise ValueError("brownout streaks must be >= 1")


class CircuitBreaker:
    """Sliding-window fault counter for ONE replica.  ``record`` takes
    the observation's own timestamp (fault observations are recorded on
    the replica thread and drained by the controller later, so the
    window must be anchored at fault time, not drain time)."""

    def __init__(self, gc: GuardrailConfig):
        self.gc = gc
        self._obs: Deque[Tuple[float, str]] = deque()

    def record(self, now: float, kind: str) -> None:
        self._obs.append((now, kind))
        self._prune(now)

    def _prune(self, now: float) -> None:
        horizon = now - self.gc.breaker_window_s
        while self._obs and self._obs[0][0] < horizon:
            self._obs.popleft()

    def count(self, now: float) -> int:
        self._prune(now)
        return len(self._obs)

    def tripped(self, now: float) -> bool:
        return self.count(now) >= self.gc.breaker_trip_faults


@dataclass
class QuarantineEntry:
    """One ejected replica's quarantine record.  ``origin_idx`` is the
    tripped replica's id (forensics only — the respawn gets a fresh id);
    ``until`` gates the half-open probe; a failed probe doubles
    ``backoff_s`` (capped) and re-arms ``until``."""

    origin_idx: int
    until: float
    backoff_s: float
    probe_idx: Optional[int] = None  # the in-flight half-open replica

    def fail_probe(self, now: float, gc: GuardrailConfig) -> None:
        cap = gc.backoff_cap_s if gc.backoff_cap_s is not None \
            else gc.quarantine_max_s
        self.backoff_s = min(self.backoff_s * 2.0, cap)
        self.until = now + self.backoff_s
        self.probe_idx = None


class Brownout:
    """Pure hysteretic brownout policy: feed one observation per
    controller tick, read :attr:`active` — same shape as the
    autoscaler, same reason (one pressured tick must not shed work a
    tick of headroom would have absorbed)."""

    def __init__(self, gc: GuardrailConfig):
        self.gc = gc
        self.active = False
        self._enter_streak = 0
        self._exit_streak = 0

    def observe(self, *, queued: int, serving: int,
                ttft_p95: Optional[float] = None) -> bool:
        """Update streaks from this tick's pressure signals; returns
        :attr:`active` after the update."""
        gc = self.gc
        pressure = serving > 0 and (
            queued > gc.brownout_queue_per_replica * serving
            or (gc.brownout_ttft_p95_s is not None and ttft_p95 is not None
                and ttft_p95 > gc.brownout_ttft_p95_s)
        )
        if pressure:
            self._enter_streak += 1
            self._exit_streak = 0
        else:
            self._exit_streak += 1
            self._enter_streak = 0
        if (not self.active
                and self._enter_streak >= gc.brownout_enter_consecutive):
            self.active = True
            self._exit_streak = 0
        elif (self.active
                and self._exit_streak >= gc.brownout_exit_consecutive):
            self.active = False
            self._enter_streak = 0
        return self.active


def should_hedge(waited_s: float, deadline_s: Optional[float],
                 gc: GuardrailConfig) -> bool:
    """The hedged-dispatch predicate, applied at dispatch time: has this
    request already burned enough of its deadline in the queue that a
    single slow replica could doom it?  Deadline-less requests hedge
    only past the absolute ``hedge_wait_s`` threshold (off by
    default)."""
    if not gc.hedging:
        return False
    if deadline_s is not None:
        return waited_s > gc.hedge_wait_frac * deadline_s
    return gc.hedge_wait_s is not None and waited_s > gc.hedge_wait_s
