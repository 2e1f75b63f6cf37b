"""Runtime telemetry: spans, counters, and trace export (the port's own
copy of ``torchdistx_tpu/observe``).

Design constraints:

* **near-zero cost when disabled** — every emission point is gated on
  :func:`enabled`, a thread-local config read; :func:`span` returns a
  shared no-op object when telemetry is off;
* **thread-safe** — spans nest per thread, events/counters append under a
  lock.

Activation (see :mod:`torchdistx_tpu_torch.config`):

* ``TDX_TRACE_DIR`` / ``config.override(trace_dir=...)`` — collect spans
  and flush a Chrome-trace JSON file (loadable in ``chrome://tracing`` /
  Perfetto) into the directory at process exit or :func:`flush`;
* ``TDX_METRICS_PATH`` / ``override(metrics_path=...)`` — flush the
  counter registry there: Prometheus text format when the path ends in
  ``.prom``, JSON-lines otherwise;
* ``TDX_FLIGHT_DIR`` / ``override(flight_dir=...)`` — arm the flight
  recorder (:mod:`.flightrec`): a bounded ring of recent events, dumped
  as a post-mortem bundle on chaos injections, serve faults and
  preemptions, and unhandled exceptions;
* :func:`enable` — force telemetry on/off programmatically (tests, tools).

Quick tour::

    from torchdistx_tpu_torch import observe

    with observe.span("train.bring_up", category="train") as sp:
        ...
    observe.counter("tdx.train.restarts").inc()
    observe.gauge("tdx.train.tokens_per_s").set(52_000)
    observe.flush()          # write trace/metrics files now

The serve stack reports through :mod:`.reqledger` (per-request
timelines and the queue / prefill / decode / guardrail split),
:mod:`.slo` (latency percentile windows and the periodic exporter,
``TDX_METRICS_EXPORT_S``) and :mod:`.health` (bring-up states).

The trace files read like the JAX package's, so ``tools/tdx_trace.py``
summarizes them too.  :mod:`.httpd` serves the same state live
(``TDX_OBS_PORT``), armed on the first emission like the exporter.
"""

from __future__ import annotations

import atexit
import os
import threading
from typing import Optional

from . import costmodel, flightrec, health, httpd, reqledger, slo, tracectx
from .metrics import Counter, Counters, Gauge, Histogram
from .spans import Span, Tracer, _NOOP_SPAN, set_drop_hook, set_flight_feed
from .step import StepMeter, peak_tflops_for
from .tracectx import trace_context

__all__ = [
    "Counter",
    "Counters",
    "Gauge",
    "Histogram",
    "Span",
    "StepMeter",
    "Tracer",
    "costmodel",
    "counter",
    "counters",
    "enable",
    "enabled",
    "flight_dump",
    "flightrec",
    "flush",
    "gauge",
    "health",
    "histogram",
    "httpd",
    "instant",
    "peak_tflops_for",
    "reqledger",
    "reset",
    "slo",
    "span",
    "stop_background",
    "trace_context",
    "tracectx",
    "tracer",
]


_TRACER = Tracer()
_COUNTERS = Counters(on_sample=lambda name, value: _TRACER.counter_sample(name, value))
_FORCED: Optional[bool] = None
_flush_lock = threading.Lock()
_autoflush_armed = False
_atexit_registered = False
_flight_armed = False
_last_counters_sig: Optional[str] = None
_config = None  # cached module ref: enabled() is on every hook's path

# Silent span loss is counted: every event the tracer's bounded export
# buffer evicts increments tdx.observe.dropped_events.
set_drop_hook(
    lambda n: _COUNTERS.counter("tdx.observe.dropped_events").inc(n)
)


def enabled() -> bool:
    """Whether telemetry is being collected: forced on via :func:`enable`,
    or the effective config carries a ``trace_dir``, ``metrics_path`` or
    ``flight_dir``.  THE gate every instrumentation point checks first;
    keep it cheap."""
    if _FORCED is not None:
        return _FORCED
    global _config
    if _config is None:
        from .. import config as _config_mod

        _config = _config_mod
    cfg = _config.get()
    return bool(cfg.trace_dir or cfg.metrics_path or cfg.flight_dir)


def enable(on: Optional[bool] = True) -> None:
    """Force telemetry on (``True``), off (``False``), or back to
    config-driven (``None``)."""
    global _FORCED
    _FORCED = on


def tracer() -> Tracer:
    """The process-wide span tracer."""
    return _TRACER


def counters() -> Counters:
    """The process-wide counter/gauge/histogram registry."""
    return _COUNTERS


def span(name: str, category: str = "tdx", **attrs) -> Span:
    """A wall-clock span context manager, recorded into the tracer.

    Returns a shared no-op object when telemetry is disabled, so call
    sites need no gating of their own.  ``sp.block_on(value)`` makes the
    close wait for the CUDA work behind ``value``'s tensors."""
    if not enabled():
        return _NOOP_SPAN
    _arm_autoflush()
    return _TRACER.span(name, category, attrs)


def instant(name: str, category: str = "tdx", **attrs) -> None:
    """A zero-duration structured event (Chrome-trace instant)."""
    if not enabled():
        return
    _arm_autoflush()
    _TRACER.instant(name, category, attrs)


def counter(name: str, **labels) -> Counter:
    """Monotonic counter handle (created on first use)."""
    _arm_autoflush()
    return _COUNTERS.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    """Gauge handle; ``set`` also records a Chrome-trace counter sample so
    gauges become time series in the trace view."""
    _arm_autoflush()
    return _COUNTERS.gauge(name, **labels)


def histogram(name: str, buckets=None, **labels) -> Histogram:
    """Histogram handle (fixed buckets, Prometheus-style export)."""
    _arm_autoflush()
    return _COUNTERS.histogram(name, buckets=buckets, **labels)


def flush(
    trace_dir: Optional[str] = None, metrics_path: Optional[str] = None
) -> dict:
    """Write collected telemetry to files and return ``{kind: path}``.

    ``trace_dir``/``metrics_path`` default to the effective config; nothing
    is written for an unset destination.  The trace file embeds the final
    counter values as Chrome-trace counter events.  Safe to call
    repeatedly: span events are DRAINED into the file they land in, and
    nothing is written at all when no events or counter changes arrived
    since the last flush."""
    from .. import config

    global _last_counters_sig
    cfg = config.get()
    td = config.expand_path(trace_dir or cfg.trace_dir)
    mp = config.expand_path(metrics_path or cfg.metrics_path)
    written: dict = {}
    with _flush_lock:
        counters_sig = repr(_COUNTERS.snapshot())
        counters_changed = counters_sig != _last_counters_sig
        if td:
            # drain() takes-and-clears under ONE tracer lock, so a span
            # recorded concurrently lands either in this file or the
            # next — never in the gap between a copy and a clear.
            events = _TRACER.drain()
            if events or counters_changed:
                os.makedirs(td, exist_ok=True)
                path = os.path.join(
                    td, f"tdx-{os.getpid()}-{_TRACER.flush_seq()}.trace.json"
                )
                _TRACER.export_chrome(path, counters=_COUNTERS, events=events)
                written["trace"] = path
        if mp and counters_changed and not _COUNTERS.empty():
            # Gated on counter CHANGES alone: undrained span traffic
            # (metrics-only runs) must not re-append identical snapshots.
            parent = os.path.dirname(os.path.abspath(mp))
            os.makedirs(parent, exist_ok=True)
            if mp.endswith(".prom"):
                with open(mp, "w") as f:
                    f.write(_COUNTERS.to_prometheus())
            else:
                _COUNTERS.export_jsonl(mp)
            written["metrics"] = mp
        if written:
            _last_counters_sig = counters_sig
    return written


def flight_dump(reason: str, **context) -> Optional[str]:
    """Dump a flight-recorder post-mortem bundle (no-op returning None
    when no ``TDX_FLIGHT_DIR`` is configured): the one call every
    failure path makes; see :mod:`.flightrec`."""
    if not flightrec.armed():
        return None
    return flightrec.dump(reason, **context)


def reset() -> None:
    """Drop all collected events, metric values, the flight ring and the
    request ledger (tests)."""
    global _last_counters_sig
    _TRACER.clear()
    _COUNTERS.clear()
    costmodel.reset()
    flightrec.clear()
    reqledger.reset()
    _last_counters_sig = None


def _arm_autoflush() -> None:
    # Registered on the first emission, not at import: a process that
    # never records anything must not add an exit hook.
    global _autoflush_armed, _atexit_registered, _flight_armed
    if not _flight_armed and flightrec.armed():
        # First emission under a bound flight dir: tee the tracer into
        # the recorder's ring and install the unhandled-exception
        # dumper.  The tee stays for the process (a ring fed outside an
        # armed scope is ignored: dump() re-checks the config).
        _flight_armed = True
        set_flight_feed(flightrec.feed)
        flightrec.install_crash_hooks()
    if _autoflush_armed:
        return
    _autoflush_armed = True
    if not _atexit_registered:
        # Registered once for the process, even across stop_background():
        # re-arming must not stack duplicate hooks.
        _atexit_registered = True
        atexit.register(_atexit_flush)
    # Adopt the cross-process trace context now — the first telemetry
    # emission is exactly when a spawned child starts producing spans,
    # so its inherited flow edge binds to its first real work.
    tracectx.adopt(_TRACER)
    # The periodic exporter (no-op unless TDX_METRICS_EXPORT_S > 0;
    # ServeEngine re-calls it to attach its SLO windows).
    slo.ensure_exporter()
    # The live HTTP plane, armed the same lazy way (no-op unless
    # TDX_OBS_PORT is set).
    httpd.ensure_httpd()


def stop_background() -> None:
    """Stop and join every background thread the observe layer armed
    (the periodic exporter, the telemetry daemon) and de-latch the
    arming flag so the NEXT emission can re-arm them (tests, orderly
    shutdown)."""
    global _autoflush_armed
    slo.stop_exporter()
    httpd.stop_httpd()
    _autoflush_armed = False


def _atexit_flush() -> None:
    try:
        flush()
    except Exception:
        pass  # exit paths never raise from telemetry
    try:
        stop_background()
    except Exception:
        pass
