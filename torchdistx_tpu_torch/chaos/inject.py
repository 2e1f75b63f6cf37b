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

``corrupt`` damages state: at the elastic sites (``step``, ``save``,
``restore``) and at ``rollover`` (the incoming checkpoint) the
checkpoint directory it is given (:func:`corrupt_checkpoint`: its
largest payload file truncated or one byte flipped; without a directory,
as at the ``fleet`` site, it raises ``ValueError`` as the JAX executor
does); at ``reshard`` the engine's in-flight chunk buffer (the engine
flips it when it sees the fault fire).  The compile caches and registry
artifacts it would damage at the other sites are not in the port yet:
there it raises ``NotImplementedError`` naming the ROADMAP item that
brings the target, never silently doing nothing.

At the ``fleet`` site :func:`execute_replica_fault` runs a fault inside a
replica thread: ``preempt`` raises :class:`ReplicaPreempted`, which ends
only that thread, and a ``hang`` stays cancellable through the thread's
:func:`set_cancel_event`.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
import zlib
from pathlib import Path
from typing import Optional

from .. import observe
from .plan import Fault

_HANG_DEFAULT_S = 3600.0  # "never returns" at test scale; cancellable
_CORRUPT_MODES = ("truncate", "flip")
# Sites where ``corrupt`` damages a checkpoint directory (at ``rollover``
# the checkpoint a roll fetches; ``fleet`` is given none).
_CHECKPOINT_SITES = ("step", "save", "restore", "rollover", "fleet")

# The ROADMAP item that ports what a ``corrupt`` fault at each other site
# damages: the artifact registry and its caches (A8), the materializer's
# compile ladder (A13).
_CORRUPT_TARGETS = {
    "registry": ("artifact registry", "A8"), "cache": ("compile cache", "A8"),
    "lower": ("compile cache", "A13"), "compile": ("compile cache", "A13"),
    "execute": ("compile cache", "A13"),
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
    """Perform ``fault``.  ``path`` is the checkpoint directory of the
    ``save``/``restore`` sites (required by ``corrupt`` there)."""
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
        if fault.site == "reshard":
            # The reshard engine damages its OWN in-flight chunk buffer
            # when it sees this fault fire (degrade-never-corrupt: the
            # bitwise verify stage catches it, and no file — least of all
            # the source checkpoint — is ever touched).  Nothing to do.
            return
        if fault.site in _CHECKPOINT_SITES:
            if path is None:
                raise ValueError(
                    f"corrupt fault needs a target path (the checkpoint "
                    f"dir): {fault.spec()}")
            corrupt_checkpoint(path, mode=fault.arg or "truncate")
            return
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


def execute_replica_fault(fault: Fault) -> None:
    """Perform a ``fleet``-site fault inside a replica thread.  Same
    telemetry as :func:`execute` (counter, instant, flight dump before
    acting), but ``preempt`` raises :class:`ReplicaPreempted` to end only
    the CALLING replica thread: a SIGTERM would take the whole fleet
    down with it, which is the ``step`` site's job, not this one's."""
    if fault.kind != "preempt":
        execute(fault)
        return
    observe.counter("tdx.chaos.injected", kind=fault.kind).inc()
    observe.instant("chaos.injected", category="chaos", spec=fault.spec())
    observe.flight_dump("chaos_injected", spec=fault.spec())
    _log.warning("chaos: injecting %s (replica-thread preempt)", fault.spec())
    raise ReplicaPreempted(
        f"chaos: injected replica preemption ({fault.spec()})")


def _damage_file(f: Path, mode: str) -> None:
    """Apply one deterministic byte-level damage mode to ``f`` in place."""
    if mode == "truncate":
        size = f.stat().st_size
        with open(f, "r+b") as fh:
            fh.truncate(max(0, size // 2))
        return
    with open(f, "r+b") as fh:  # flip
        data = bytearray(fh.read())
        if not data:
            raise ValueError(f"cannot flip a byte of empty file {f}")
        # Deterministic victim byte: keyed by content, not RNG.
        i = zlib.crc32(bytes(data)) % len(data)
        data[i] ^= 0xFF
        fh.seek(0)
        fh.write(data)


def corrupt_checkpoint(path: "str | Path", mode: str = "truncate") -> str:
    """Deterministically damage one payload file of a committed checkpoint
    (post-commit bit-rot / torn-write model).  The victim is the largest
    payload file — metadata-only damage can slip past a restore that never
    touches the damaged branch; payload damage cannot.  Returns the
    relative path of the damaged file.
    """
    if mode not in _CORRUPT_MODES:
        raise ValueError(f"corrupt mode must be one of {_CORRUPT_MODES}, got {mode!r}")
    path = Path(path)
    from ..utils.checkpoint import iter_payload_files

    victims = sorted(
        iter_payload_files(path),
        key=lambda rel: ((path / rel).stat().st_size, str(rel)),
    )
    if not victims:
        raise FileNotFoundError(f"no payload files to corrupt under {path}")
    rel = victims[-1]
    _damage_file(path / rel, mode)
    return str(rel)
