"""Bring-up states (the port's own copy of the component states of
``torchdistx_tpu/observe/health.py``), the rows a ``/readyz`` probe
reads.

A named component walks an explicit bring-up state machine; the serve
engine reports ``spin_up`` -> ``warming`` -> ``serving`` around replica
bring-up (:func:`..serve.spin_up_replica`).  :func:`readiness` is true
only when every registered component is in a READY state (``serving`` /
``ready``), so a load balancer cannot route to a replica whose programs
are still being captured.  A process with no registered components is
trivially ready.  Components named ``fleet/<r>`` are fleet replicas and
aggregate: ready iff >= 1 replica is serving, with the per-replica
states listed in the probe body.  The JAX module's liveness heartbeats
come with the loops that beat (the elastic loop, ROADMAP A12).

The registry holds plain floats/strings under one lock: reporting a
state costs nanoseconds.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Tuple

__all__ = [
    "FLEET_PREFIX",
    "READY_STATES",
    "clear_state",
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

_lock = threading.Lock()
_states: Dict[str, Tuple[str, float]] = {}          # name -> (state, since)
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


def snapshot() -> dict:
    """The component states as one JSON-ready dict."""
    now = time.monotonic()
    with _lock:
        states = {
            name: {"state": st, "for_s": round(now - since, 3),
                   **_infos.get(name, {})}
            for name, (st, since) in _states.items()
        }
    return {"states": states}


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
    """Drop all states (tests)."""
    with _lock:
        _states.clear()
        _infos.clear()
