"""Flight recorder (the port's own copy of
``torchdistx_tpu/observe/flightrec.py``): an always-on bounded ring of
recent telemetry that survives the crash it describes.

The tracer's export buffer exists to be DRAINED (``observe.flush``
takes and clears it, and a long run ages its oldest events out), so by
the time chaos fires mid-batch the events explaining the failure have
usually left the process.  The flight recorder fixes that:

* every event the tracer records is ALSO teed into a separate bounded
  ring (``collections.deque(maxlen=...)`` under its own lock, so a dump
  can snapshot it while other threads append), independent of the
  export buffer: the ring always holds the most recent
  ``TDX_FLIGHT_EVENTS`` events;
* on a failure the port handles (a chaos injection, a serve fault or
  preemption, an unhandled exception) :func:`dump` writes a
  self-contained post-mortem bundle ATOMICALLY (tmp + rename) into
  ``TDX_FLIGHT_DIR``: the ring, the effective config, an environment
  fingerprint (torch, the CUDA runtime, the driver, the device name),
  the last counter snapshots, the request ledger's view, the probe rows
  and the trigger's context.

The bundle's schema is the JAX package's (v2), so
``tools/tdx_trace.py flight`` renders the port's dumps too.  Arming is
config-driven (``TDX_FLIGHT_DIR`` / ``config.override(flight_dir=...)``);
with no flight dir every hook is a cheap None check.  ``%h`` / ``%p`` in
the dir expand to hostname/pid (:func:`..config.expand_path`).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

# v2 adds causal identity: "trace_id" (the run tree's id from
# observe.tracectx, shared with the Chrome trace label) and
# "trace_parent" (the raw inherited TDX_TRACE_PARENT, None at the root)
# — so a dump can be matched to the exact run and the exact spawn edge
# that produced it.  v1 dumps stay readable: validate() accepts both.
SCHEMA_VERSION = 2
SUPPORTED_SCHEMAS = (1, 2)

# Required top-level keys of a dump: the JAX package's list, which
# tools/tdx_trace.py also carries; keep them in sync.
SCHEMA_KEYS = (
    "schema", "reason", "time", "pid", "host", "events", "config",
    "env", "counter_snapshots",
)
SCHEMA_KEYS_V2 = ("trace_id",)

_DEFAULT_RING = 4096
_MAX_COUNTER_SNAPS = 8

_lock = threading.Lock()
_ring: "deque[dict]" = deque(
    maxlen=int(os.environ.get("TDX_FLIGHT_EVENTS", str(_DEFAULT_RING)))
)
_counter_snaps: "deque[dict]" = deque(maxlen=_MAX_COUNTER_SNAPS)
_seq = 0
_hooks_installed = False
_prev_excepthook = None
_prev_thread_excepthook = None
_excepthook_dumped = False

# Per-reason dump throttle: a chaos soak or a preemption storm fires the
# same trigger many times a second, and each dump is a full ring write.
# The FIRST dump of a reason always lands; repeats inside the interval
# are suppressed (counted in tdx.observe.flight_dumps_suppressed).
_MIN_INTERVAL_S = 0.25
_last_dump_ts: Dict[str, float] = {}
# The interval throttle bounds the RATE, not the count: a soak
# preempting for hours at 4 dumps/s would still fill the disk with
# uniquely-named files.  Two caps, first dumps win (the early evidence
# is the interesting evidence), suppressions counted: a PER-REASON cap
# so a routine reason (serve preemptions under sustained page pressure)
# cannot burn the budget a later crash needs, under a process-total cap.
_MAX_DUMPS = 200
_MAX_DUMPS_PER_REASON = 25
_reason_counts: Dict[str, int] = {}

# Guards ring/snapshot iteration vs concurrent appends: list(deque)
# raises RuntimeError if another thread appends mid-iteration — at dump
# time that would silently lose the bundle at exactly the crash moment.
# Uncontended acquire is ~100ns; the overhead gate covers it.
_ring_lock = threading.Lock()


def feed(event: dict) -> None:
    """Tee one tracer event into the ring (installed as the tracer's
    flight feed by ``observe`` when a flight dir is configured)."""
    with _ring_lock:
        _ring.append(event)


def armed() -> bool:
    """Whether a flight dir is configured (the every-hook gate)."""
    from .. import config

    return bool(config.get().flight_dir)


def ring_events() -> List[dict]:
    """The current ring contents, oldest first (a snapshot copy)."""
    with _ring_lock:
        return list(_ring)


def clear() -> None:
    """Drop the ring, counter snapshots, dump throttle, and dump-count
    caps (tests)."""
    global _excepthook_dumped, _seq
    with _ring_lock:
        _ring.clear()
        _counter_snaps.clear()
    with _lock:
        _last_dump_ts.clear()
        _reason_counts.clear()
        _seq = 0
        _excepthook_dumped = False


def snapshot_counters() -> None:
    """Append one timestamped counter-registry snapshot to the bounded
    history the next dump will carry.  Called by the periodic metrics
    exporter (so a dump shows the trend, not just the final values) and
    by :func:`dump` itself (so the final values are always present)."""
    from . import counters

    if counters().empty():
        return
    snap = {"ts": time.time(), "counters": counters().snapshot()}
    with _ring_lock:
        _counter_snaps.append(snap)


def _counter_snapshots() -> List[dict]:
    with _ring_lock:
        return list(_counter_snaps)


def _env_fingerprint() -> Dict[str, Any]:
    """Provenance a post-mortem reader needs to reproduce the failing
    environment: interpreter and torch versions, the CUDA runtime and
    driver, the device, and the TDX_* knobs that were set (values
    included: they are paths and small scalars, never secrets)."""
    fp: Dict[str, Any] = {
        "python": sys.version.split()[0],
        "platform": sys.platform,
        "argv": sys.argv[:8],
        "cwd": os.getcwd(),
        "tdx_env": {k: v for k, v in sorted(os.environ.items())
                    if k.startswith(("TDX_", "CUDA_VISIBLE_DEVICES"))},
    }
    # Lazy and fault-tolerant: a dump must succeed mid-crash.  Never
    # IMPORT torch here, and never initialize CUDA: a process that has
    # not touched the card must not pay for (or break on) it.
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            fp["torch"] = torch.__version__
            fp["cuda_runtime"] = torch.version.cuda
            if torch.cuda.is_initialized():
                fp["device"] = torch.cuda.get_device_name()
                fp["device_count"] = torch.cuda.device_count()
                fp["driver"] = _driver_version()
        except Exception:
            pass
    return fp


_driver: Optional[str] = None


def _driver_version() -> Optional[str]:
    """The NVIDIA driver's version string, read once through NVML (as
    torch reads the device count), else the driver's CUDA API version."""
    global _driver
    if _driver is not None:
        return _driver
    import ctypes

    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
        buf = ctypes.create_string_buffer(96)
        if (nvml.nvmlInit_v2() == 0
                and nvml.nvmlSystemGetDriverVersion(buf, 96) == 0):
            _driver = buf.value.decode()
            return _driver
    except Exception:
        pass
    try:
        ver = ctypes.c_int()
        if ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(
                ctypes.byref(ver)) == 0:
            _driver = f"cuda {ver.value // 1000}.{ver.value % 1000 // 10}"
    except Exception:
        pass
    return _driver


def dump(reason: str, **context) -> Optional[str]:
    """Write one post-mortem bundle; returns its path (None when no
    flight dir is configured or the write failed — dump paths never
    raise: they run inside exception handlers and exit hooks).

    ``context`` lands under ``"context"`` verbatim (JSON-coerced), e.g.
    ``dump("serve_fault", step=3, active=2)``."""
    from .. import config
    from . import counters

    fdir = config.expand_path(config.get().flight_dir)
    if not fdir:
        return None
    global _seq
    now = time.monotonic()
    with _lock:
        last = _last_dump_ts.get(reason)
        if ((last is not None and now - last < _MIN_INTERVAL_S)
                or _seq >= _MAX_DUMPS
                or _reason_counts.get(reason, 0) >= _MAX_DUMPS_PER_REASON):
            counters().counter(
                "tdx.observe.flight_dumps_suppressed", reason=reason
            ).inc()
            return None
        _last_dump_ts[reason] = now
        _reason_counts[reason] = _reason_counts.get(reason, 0) + 1
        _seq += 1
        seq = _seq
    try:
        snapshot_counters()
        from .tracectx import trace_context

        ctx = trace_context()
        try:
            # Extra (non-schema) key: the request ledger's post-mortem
            # view — tail attribution, in-flight requests, occupancy.
            # validate() only flags MISSING required keys, so v1/v2
            # readers are unaffected.
            from . import reqledger

            ledger: Optional[dict] = reqledger.flight_snapshot()
        except Exception:
            ledger = None
        doc = {
            "schema": SCHEMA_VERSION,
            "reason": reason,
            "time": time.time(),
            "pid": os.getpid(),
            "host": _hostname(),
            "trace_id": ctx.trace_id,
            "trace_parent": ctx.parent,
            "events": ring_events(),
            "dropped_events": _tracer_dropped(),
            "config": _config_dict(),
            "env": _env_fingerprint(),
            "counter_snapshots": _counter_snapshots(),
            "context": _jsonable(context),
        }
        if ledger is not None:
            doc["ledger"] = ledger
        try:
            # Extra (non-schema) key: the readiness probe's body, the
            # bring-up state of each component (and the weight version
            # it serves, set_info).
            from . import health

            doc["health"] = health.readiness()[1]
        except Exception:
            pass
        os.makedirs(fdir, exist_ok=True)
        path = os.path.join(
            fdir, f"flight-{os.getpid()}-{seq:03d}-{_safe(reason)}.json"
        )
        tmp = f"{path}.tmp-{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
            f.write("\n")
        os.replace(tmp, path)
        counters().counter("tdx.observe.flight_dumps", reason=reason).inc()
        return path
    except Exception:  # noqa: BLE001 — forensics must never crash the run
        return None


def validate(doc: dict) -> List[str]:
    """Schema check of a parsed dump; returns the list of problems
    (empty = valid).  The JAX package's ``validate`` and
    ``tools/tdx_trace.py`` hold the same keys."""
    problems = [f"missing key {k!r}" for k in SCHEMA_KEYS if k not in doc]
    ver = doc.get("schema")
    if ver not in SUPPORTED_SCHEMAS:
        problems.append(f"unknown schema version {ver!r}")
    elif isinstance(ver, int) and ver >= 2:
        problems.extend(
            f"missing key {k!r}" for k in SCHEMA_KEYS_V2 if k not in doc
        )
    if not isinstance(doc.get("events"), list):
        problems.append("events is not a list")
    return problems


def install_crash_hooks() -> None:
    """Arm the unhandled-exception and exit dumpers (idempotent; called
    by ``observe`` on the first emission when a flight dir is bound).

    ``sys.excepthook`` and ``threading.excepthook`` are wrapped — an
    exception nobody caught (main thread or worker) dumps with the
    traceback in context, then falls through to the previous hook —
    and an ``atexit`` hook dumps a final ``exit`` bundle only if an
    excepthook dump already happened, so a CLEAN exit leaves no
    spurious dump."""
    global _hooks_installed, _prev_excepthook, _prev_thread_excepthook
    with _lock:
        if _hooks_installed:
            return
        _hooks_installed = True
        _prev_excepthook = sys.excepthook
        _prev_thread_excepthook = threading.excepthook

        def _dump_unhandled(exc_type, exc, tb, **extra):
            global _excepthook_dumped
            path = dump(
                "unhandled_exception",
                error=f"{exc_type.__name__}: {exc}",
                traceback="".join(
                    traceback.format_exception(exc_type, exc, tb)
                )[-4000:],
                **extra,
            )
            if path is not None:
                # Only a LANDED crash dump earns the atexit `exit`
                # bundle — after a throttled/failed one, an exit dump
                # with no traceback would misattribute the failure.
                _excepthook_dumped = True

        def _hook(exc_type, exc, tb):
            try:
                _dump_unhandled(exc_type, exc, tb)
            finally:
                (_prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

        sys.excepthook = _hook

        # Worker threads (the metrics exporter, a fleet's replica
        # threads) die through threading.excepthook, never
        # sys.excepthook: without this wrap their crash leaves no dump.
        def _thread_hook(args):
            try:
                _dump_unhandled(
                    args.exc_type, args.exc_value, args.exc_traceback,
                    thread=args.thread.name if args.thread else "?",
                )
            finally:
                _prev_thread_excepthook(args)

        threading.excepthook = _thread_hook

        # Last-resort exit bundle: only after an excepthook dump (the
        # final ring may hold cleanup evidence the mid-crash dump
        # missed) — a clean exit leaves no spurious dump.
        def _atexit_hook():
            if _excepthook_dumped:
                dump("exit")

        import atexit

        atexit.register(_atexit_hook)


def _tracer_dropped() -> int:
    from . import tracer

    try:
        return int(tracer().dropped)
    except Exception:
        return 0


def _config_dict() -> Dict[str, Any]:
    import dataclasses

    from .. import config

    try:
        return dataclasses.asdict(config.get())
    except Exception:
        return {}


def _jsonable(obj):
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        return {k: str(v) for k, v in obj.items()} if isinstance(obj, dict) \
            else str(obj)


def _hostname() -> str:
    import socket

    try:
        return socket.gethostname().split(".")[0]
    except Exception:
        return "unknown"


def _safe(reason: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "_" for c in reason)[:40]
