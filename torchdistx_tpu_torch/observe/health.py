"""Bring-up states and liveness heartbeats (the port's own copy of
``torchdistx_tpu/observe/health.py``), the rows ``/readyz`` and
``/healthz`` probes read.  Two small registries, both process-wide and
thread-safe:

* **component states** — a named component walks an explicit bring-up
  state machine; the serve engine reports ``spin_up`` -> ``warming`` ->
  ``serving`` around replica bring-up (:func:`..serve.spin_up_replica`).
  :func:`readiness` is true only when every registered component is in a
  READY state (``serving`` / ``ready``), so a load balancer cannot route
  to a replica whose programs are still being captured.  A process with
  no registered components is trivially ready.  Components named
  ``fleet/<r>`` are fleet replicas and aggregate: ready iff >= 1 replica
  is serving, with the per-replica states listed in the probe body.
* **heartbeats** — a loop that can wedge (the elastic step loop,
  :func:`..utils.run_elastic`, under its step watchdog) beats once per
  iteration with a period hint; :func:`liveness` is false when any
  heartbeat is older than its allowance (``max(4 × period_hint, 15 s)``
  — generous against the watchdog, so one slow step never flaps it).

The registries hold plain floats/strings under one lock: reporting a
state or a beat costs nanoseconds.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

__all__ = [
    "FLEET_PREFIX",
    "READY_STATES",
    "beat",
    "clear_state",
    "liveness",
    "readiness",
    "reset",
    "set_info",
    "set_state",
    "snapshot",
]

# Terminal bring-up states that count as ready for /readyz.
READY_STATES = ("serving", "ready")

# Components named "fleet/<replica>" are fleet replicas and aggregate:
# the fleet is ready when AT LEAST ONE replica is, so a replica
# mid-bring-up (or mid-drain) never 503s a fleet that is still serving.
FLEET_PREFIX = "fleet/"

_MIN_ALLOWANCE_S = 15.0

_lock = threading.Lock()
_states: Dict[str, Tuple[str, float]] = {}          # name -> (state, since)
_beats: Dict[str, Tuple[float, Optional[float]]] = {}  # name -> (t, hint)
_infos: Dict[str, Dict[str, object]] = {}           # name -> metadata


def set_state(component: str, state: str) -> None:
    """Report a component's bring-up state (e.g. ``set_state("serve",
    "warming")``); also mirrored as a trace instant so the state walk
    shows up on the timeline."""
    with _lock:
        _states[component] = (state, time.monotonic())
    from . import enabled, instant

    if enabled():
        instant(f"{component}.state", category="health", state=state)


def set_info(component: str, **info: object) -> None:
    """Attach static metadata to a component's probe rows — e.g. the
    weight version a fleet replica serves (``set_info("fleet/r2",
    version="step_8@a1b2c3d4")``), so ``/readyz`` shows a half-rolled
    fleet at a glance.  Merged into the component's ``snapshot()`` /
    ``readiness()`` row; ``None`` values are dropped; cleared with the
    state."""
    with _lock:
        cur = _infos.setdefault(component, {})
        for k, v in info.items():
            if v is None:
                cur.pop(k, None)
            else:
                cur[k] = v


def clear_state(component: str) -> None:
    """Forget a component (a fleet replica that scaled away): a removed
    replica must stop counting toward — or against — readiness."""
    with _lock:
        _states.pop(component, None)
        _infos.pop(component, None)


def beat(name: str, period_hint_s: Optional[float] = None) -> None:
    """One liveness heartbeat; ``period_hint_s`` sizes the staleness
    allowance (``max(4 × hint, 15 s)``)."""
    with _lock:
        _beats[name] = (time.monotonic(), period_hint_s)


def snapshot() -> dict:
    """States + heartbeat ages as one JSON-ready dict."""
    now = time.monotonic()
    with _lock:
        states = {
            name: {"state": st, "for_s": round(now - since, 3),
                   **_infos.get(name, {})}
            for name, (st, since) in _states.items()
        }
        beats = {
            name: {
                "age_s": round(now - t, 3),
                **({"period_hint_s": hint} if hint is not None else {}),
            }
            for name, (t, hint) in _beats.items()
        }
    return {"states": states, "heartbeats": beats}


def _allowance(hint: Optional[float]) -> float:
    return max(4.0 * hint, _MIN_ALLOWANCE_S) if hint else _MIN_ALLOWANCE_S


def liveness() -> Tuple[bool, dict]:
    """(alive, detail) for /healthz: alive unless a heartbeat went
    stale.  A process that never beats is alive by definition — the
    probe's job is catching a wedged LOOP, not requiring one."""
    now = time.monotonic()
    detail = snapshot()
    stale = {}
    with _lock:
        for name, (t, hint) in _beats.items():
            age = now - t
            if age > _allowance(hint):
                stale[name] = round(age, 3)
    if stale:
        detail["stale"] = stale
    return (not stale), detail


def readiness() -> Tuple[bool, dict]:
    """(ready, detail) for /readyz: every registered component must be
    in a READY state; none registered → trivially ready.

    ``fleet/*`` components are fleet replicas and aggregate instead of
    gating individually: the fleet contributes ready iff ≥1 replica is
    in a READY state, and the detail carries a ``fleet`` view listing
    every replica's bring-up state (the per-replica body a ``/readyz``
    probe serves)."""
    detail = snapshot()
    fleet = {
        name: info for name, info in detail["states"].items()
        if name.startswith(FLEET_PREFIX)
    }
    not_ready = {
        name: info["state"] for name, info in detail["states"].items()
        if info["state"] not in READY_STATES and name not in fleet
    }
    if fleet:
        serving = sum(
            1 for info in fleet.values() if info["state"] in READY_STATES
        )
        detail["fleet"] = {
            "replicas": {
                name[len(FLEET_PREFIX):]: info for name, info in fleet.items()
            },
            "serving": serving,
        }
        if serving == 0:
            not_ready["fleet"] = "no replica serving"
    if not_ready:
        detail["not_ready"] = not_ready
    return (not not_ready), detail


def reset() -> None:
    """Drop all states and heartbeats (tests)."""
    with _lock:
        _states.clear()
        _beats.clear()
        _infos.clear()
