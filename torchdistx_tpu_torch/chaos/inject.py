"""Fault executors (the port's own copy of ``torchdistx_tpu/chaos/inject.py``):
turn a matched :class:`~.plan.Fault` into the real failure it models.

Every injection increments ``tdx.chaos.injected{kind=...}``, emits a
``chaos.injected`` instant and dumps the flight recorder (reason
``chaos_injected``) before acting, so a trace of a chaos run shows
exactly what was injected where, and the post-mortem shows the state at
injection, not after the recovery rewrote it.

The injected *raise* is :class:`InjectedRuntimeError`, the port's stand-in
for a device failure the process survives (the JAX package raises a
constructible ``XlaRuntimeError``).  It is a ``RuntimeError`` whose
message names no CUDA error, so the retryable-error contract
(:func:`..cuda_bridge.materialize._retryable_errors`) can tell it from a
sticky CUDA error, which it never retries.

``corrupt`` damages on-disk state (checkpoints, compile caches, registry
artifacts) that the port does not have yet: at every site it raises
``NotImplementedError`` naming the ROADMAP item that brings the target,
never silently doing nothing.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Optional

from .. import observe
from .plan import Fault

_HANG_DEFAULT_S = 3600.0  # "never returns" at test scale; cancellable

# The ROADMAP item that ports what a ``corrupt`` fault at each site
# damages: checkpoints and reshard transfers (A12), the artifact registry
# and its caches (A8), the materializer's compile ladder (A13), the
# fleet's replicas and rollover (A7).
_CORRUPT_TARGETS = {
    "step": ("checkpoint", "A12"), "save": ("checkpoint", "A12"),
    "restore": ("checkpoint", "A12"), "reshard": ("reshard chunk", "A12"),
    "registry": ("artifact registry", "A8"), "cache": ("compile cache", "A8"),
    "lower": ("compile cache", "A13"), "compile": ("compile cache", "A13"),
    "execute": ("compile cache", "A13"), "fleet": ("fleet replica", "A7"),
    "rollover": ("rollover checkpoint", "A7"),
}

_log = logging.getLogger("torchdistx_tpu_torch")


class InjectedRuntimeError(RuntimeError):
    """A ``raise`` / ``flap`` fault: the device failure a replica
    survives (its batch is requeued)."""


class ReplicaPreempted(InjectedRuntimeError):
    """A ``fleet`` site ``preempt``: the replica THREAD is killed (its
    controller sees a dead replica and requeues its work), the process
    lives."""


_tls = threading.local()


def set_cancel_event(event: "threading.Event | None") -> None:
    """Install a cancellation event for chaos sleeps on THIS thread: when
    it fires, an injected ``hang`` / ``slow`` wakes and returns instead of
    sleeping out its argument, so an abandoned worker can exit."""
    _tls.cancel = event


def _interruptible_sleep(seconds: float) -> None:
    ev = getattr(_tls, "cancel", None)
    if ev is None:
        time.sleep(seconds)
        return
    deadline = time.monotonic() + seconds
    while not ev.is_set():
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return
        ev.wait(min(0.25, remaining))


def execute(fault: Fault, *, path: Optional[str] = None) -> None:
    """Perform ``fault``.  ``path`` is the target a ``corrupt`` fault
    would damage (none exists in the port yet)."""
    observe.counter("tdx.chaos.injected", kind=fault.kind).inc()
    observe.instant(
        "chaos.injected", category="chaos",
        spec=fault.spec(), **({"path": str(path)} if path else {}),
    )
    # Before acting: a raise/preempt may unwind or kill the process, and
    # the post-mortem must show the state AT injection (no-op without
    # TDX_FLIGHT_DIR; throttled per reason).
    observe.flight_dump(
        "chaos_injected", spec=fault.spec(),
        **({"path": str(path)} if path else {}),
    )
    _log.warning("chaos: injecting %s%s", fault.spec(),
                 f" (path={path})" if path else "")

    if fault.kind == "raise":
        raise InjectedRuntimeError(
            f"chaos: injected device failure ({fault.spec()})")
    if fault.kind == "flap":
        # The flaky-host model: the same failure as `raise`, but the PLAN
        # keeps the entry live and fires it on its duty-cycle pattern.
        raise InjectedRuntimeError(
            f"chaos: injected intermittent fault ({fault.spec()})")
    if fault.kind == "hang":
        _interruptible_sleep(float(fault.arg) if fault.arg else _HANG_DEFAULT_S)
        return
    if fault.kind == "slow":
        _interruptible_sleep(float(fault.arg) if fault.arg else 1.0)
        return
    if fault.kind == "preempt":
        # The real preemption notice: SIGTERM to our own process (the
        # handler runs in the main thread, whichever thread gets here).
        os.kill(os.getpid(), signal.SIGTERM)
        return
    if fault.kind == "corrupt":
        target = _CORRUPT_TARGETS.get(fault.site)
        if target is None:
            raise ValueError(
                f"corrupt fault has no target at site {fault.site!r}: "
                f"{fault.spec()}")
        what, item = target
        raise NotImplementedError(
            f"chaos: {fault.spec()} would damage the {what}, which the "
            f"port does not have yet (ROADMAP {item})")
    raise AssertionError(f"unreachable fault kind {fault.kind!r}")
