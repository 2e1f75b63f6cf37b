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
flips it when it sees the fault fire); at ``registry`` the payload of
every complete entry of the artifact registry
(:func:`corrupt_registry_dir`), and at ``cache`` and at the
materializer's ``lower`` / ``compile`` / ``execute`` sites every kernel
library installed in the local cache (:func:`corrupt_cache_dir`, the
JAX executor's compile cache), each given its directory; the CRC check
quarantines a damaged library before it is loaded.

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
# Sites where ``corrupt`` damages the local kernel-library cache.
_CACHE_SITES = ("cache", "lower", "compile", "execute")

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
        if fault.site in (*_CHECKPOINT_SITES, "registry", *_CACHE_SITES):
            if path is None:
                raise ValueError(
                    f"corrupt fault needs a target path (the checkpoint "
                    f"dir, the registry dir at the registry site, the "
                    f"kernel cache dir at the cache and materializer "
                    f"sites): {fault.spec()}")
            if fault.site == "registry":
                damage = corrupt_registry_dir
            elif fault.site in _CACHE_SITES:
                damage = corrupt_cache_dir
            else:
                damage = corrupt_checkpoint
            damage(path, mode=fault.arg or "truncate")
            return
        raise ValueError(
            f"corrupt fault has no target at site {fault.site!r}: "
            f"{fault.spec()}")
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


def _damaged(data: bytes, mode: str, f: Path) -> bytes:
    """``data`` under one deterministic damage mode: its first half
    (``truncate``) or one byte flipped, the byte keyed by content."""
    if mode == "truncate":
        return data[:len(data) // 2]
    if not data:
        raise ValueError(f"cannot flip a byte of empty file {f}")
    out = bytearray(data)
    out[zlib.crc32(data) % len(out)] ^= 0xFF
    return bytes(out)


def _damage_file(f: Path, mode: str) -> None:
    """Apply one deterministic byte-level damage mode to ``f`` in place."""
    with open(f, "r+b") as fh:
        data = _damaged(fh.read(), mode, f)
        fh.seek(0)
        fh.write(data)
        fh.truncate()


def _check_mode(mode: str) -> None:
    if mode not in _CORRUPT_MODES:
        raise ValueError(f"corrupt mode must be one of {_CORRUPT_MODES}, got {mode!r}")


def corrupt_cache_dir(path: "str | Path", mode: str = "truncate") -> "list[str]":
    """Deterministically damage EVERY kernel library (``*.so``) installed
    in a local kernel cache (the counterpart of the JAX package's
    ``corrupt_cache_dir``, whose entries are compile-cache files): the
    same bytes as that executor's damage, written as a new file renamed
    over the old, so a library a process has loaded keeps its mapped
    pages.  Returns the damaged file names."""
    _check_mode(mode)
    path = Path(path)
    victims = sorted(f for f in path.iterdir()
                     if f.is_file() and f.suffix == ".so") \
        if path.is_dir() else []
    if not victims:
        raise FileNotFoundError(f"no kernel libraries to corrupt under {path}")
    for f in victims:
        tmp = f.with_name(f"{f.name}.{os.getpid()}.damage")
        tmp.write_bytes(_damaged(f.read_bytes(), mode, f))
        os.replace(tmp, f)
    return [f.name for f in victims]


def corrupt_registry_dir(path: "str | Path", mode: str = "truncate") -> "list[str]":
    """Deterministically damage the PAYLOAD files of every complete entry
    in a shared artifact registry (the bit-rotted / torn shared
    filesystem model).  Manifests are left intact so the damage is
    exactly what CRC self-verification exists to catch: the next fetch
    must verify-fail, quarantine the entry, and degrade to a local
    build.  Returns the damaged ``<entry>/<file>`` names."""
    _check_mode(mode)
    path = Path(path)
    victims: "list[str]" = []
    if path.is_dir():
        for entry in sorted(path.iterdir()):
            if not entry.is_dir() or entry.name.endswith(".corrupt"):
                continue
            if not (entry / "meta.json").is_file():
                continue  # incomplete/tmp dir: publish owns it
            for f in sorted(entry.iterdir()):
                if f.name == "meta.json" or not f.is_file():
                    continue
                _damage_file(f, mode)
                victims.append(f"{entry.name}/{f.name}")
    if not victims:
        raise FileNotFoundError(f"no registry artifacts to corrupt under {path}")
    return victims


def corrupt_checkpoint(path: "str | Path", mode: str = "truncate") -> str:
    """Deterministically damage one payload file of a committed checkpoint
    (post-commit bit-rot / torn-write model).  The victim is the largest
    payload file — metadata-only damage can slip past a restore that never
    touches the damaged branch; payload damage cannot.  Returns the
    relative path of the damaged file.
    """
    _check_mode(mode)
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
