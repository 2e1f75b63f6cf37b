"""Span tracer: nested, thread-safe, wall-clock + device-work aware (the
port's own copy of ``torchdistx_tpu/observe/spans.py``).

Spans measure wall time with an optional ``block_on`` (a CUDA
synchronize of the devices the value's tensors live on) so asynchronous
kernel launches cannot lie, nest per thread (self-time precomputed at
close), and export as Chrome-trace JSON loadable in ``chrome://tracing``
/ Perfetto.

Timestamps are epoch-anchored microseconds measured on the monotonic clock
(``perf_counter`` delta from an import-time epoch pairing), so traces from
several processes of one run merge into a coherent timeline.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

# In-memory event cap: a run that records but never flushes (or flushes
# only metrics) must not grow memory without bound — oldest events are
# dropped and the drop count is stamped into the export.
_MAX_EVENTS = 200_000

_EPOCH0 = time.time()
_PERF0 = time.perf_counter()

# Cross-module hooks, installed by the port's observe package (this module
# stays import-cycle-free): `_flight_feed` tees every recorded event into
# the flight recorder's independent ring when one is armed; `_drop_hook`
# reports export-buffer evictions so silent span loss becomes the
# `tdx.observe.dropped_events` counter.  Plain module globals read once
# per record — None checks, no indirection cost when unused.
_flight_feed = None
_drop_hook = None

# Set by observe.tracectx when a trace context is minted/adopted: stamped
# into the Chrome export as a process label so a merged Perfetto view
# groups every process of one causal run under the same trace id.
_trace_label: Optional[str] = None


def set_flight_feed(fn) -> None:
    global _flight_feed
    _flight_feed = fn


def set_drop_hook(fn) -> None:
    global _drop_hook
    _drop_hook = fn


def set_trace_label(label: Optional[str]) -> None:
    global _trace_label
    _trace_label = label


def block_until_ready(value) -> None:
    """Wait for the device work behind ``value``'s tensors (any nesting of
    tuples, lists and dicts): a synchronize of each CUDA device they live
    on; nothing for CPU tensors."""
    import torch
    from torch.utils._pytree import tree_leaves

    devices = {t.device for t in tree_leaves(value)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


def now_us() -> float:
    """Epoch-anchored monotonic timestamp in microseconds."""
    return (_EPOCH0 + (time.perf_counter() - _PERF0)) * 1e6


class Span:
    """One traced region.  Use via ``observe.span(...)`` as a context
    manager; ``set(**attrs)`` attaches arguments, ``block_on(value)``
    makes the close wait for async device work."""

    __slots__ = (
        "name", "category", "args", "t0_us", "dur_us",
        "_tracer", "_child_us", "_blocked", "_entered",
    )

    def __init__(self, tracer: "Tracer", name: str, category: str,
                 args: Optional[Dict[str, Any]] = None):
        self.name = name
        self.category = category
        self.args: Dict[str, Any] = dict(args) if args else {}
        self.t0_us = 0.0
        self.dur_us: Optional[float] = None
        self._tracer = tracer
        self._child_us = 0.0
        self._blocked: Any = None
        self._entered = False

    def set(self, **attrs) -> "Span":
        self.args.update(attrs)
        return self

    def block_on(self, value):
        """Make ``__exit__`` wait for ``value``'s async device work before
        stamping the duration (:func:`block_until_ready`)."""
        self._blocked = value
        return value

    @property
    def elapsed(self) -> Optional[float]:
        """Seconds, once closed."""
        return None if self.dur_us is None else self.dur_us / 1e6

    def __enter__(self) -> "Span":
        self._entered = True
        self._tracer._push(self)
        self.t0_us = now_us()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._blocked is not None:
            block_until_ready(self._blocked)
            self._blocked = None  # don't pin device arrays past the scope
        self.dur_us = now_us() - self.t0_us
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self._tracer._pop(self)
        return False


class _NoopSpan:
    """Shared do-nothing span returned when telemetry is disabled — call
    sites keep one code path and pay only the ``enabled()`` check."""

    __slots__ = ()
    elapsed = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def block_on(self, value):
        return value


_NOOP_SPAN = _NoopSpan()


class Tracer:
    """Thread-safe process-wide span/event log with Chrome-trace export."""

    def __init__(self, max_events: int = _MAX_EVENTS):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._seq = 0
        self.dropped = 0
        self._pending_flow: Optional[int] = None
        self.events: "deque[dict]" = deque(maxlen=max_events)

    # -- recording -------------------------------------------------------

    def span(self, name: str, category: str = "tdx",
             args: Optional[Dict[str, Any]] = None) -> Span:
        return Span(self, name, category, args)

    def instant(self, name: str, category: str = "tdx",
                args: Optional[Dict[str, Any]] = None) -> None:
        self._record({
            "name": name, "cat": category, "ph": "i", "s": "t",
            "ts": now_us(), "pid": _pid(), "tid": _tid(),
            **({"args": dict(args)} if args else {}),
        })

    # -- flow events (causal arrows across pids/hosts) -------------------

    def flow_start(self, name: str = "tdx.flow") -> int:
        """Emit a Chrome flow-start (``ph:"s"``) at the current point —
        call inside an open span so the arrow's tail binds to it — and
        return the flow id to hand to the child (``TDX_TRACE_PARENT``).
        Ids are pid-salted so several spawners of one run cannot
        collide in the merged trace."""
        with self._lock:
            self._seq += 1
            flow_id = ((_pid() & 0x3FFFFF) << 20) | (self._seq & 0xFFFFF)
        self._record({
            "name": name, "cat": "flow", "ph": "s", "id": flow_id,
            "ts": now_us(), "pid": _pid(), "tid": _tid(),
        })
        return flow_id

    def flow_finish(self, flow_id: int, *, ts: Optional[float] = None,
                    name: str = "tdx.flow") -> None:
        """Emit the matching flow-finish (``ph:"f"``, bound to the slice
        enclosing ``ts``) — the arrow's head."""
        self._record({
            "name": name, "cat": "flow", "ph": "f", "bp": "e",
            "id": flow_id, "ts": now_us() if ts is None else ts,
            "pid": _pid(), "tid": _tid(),
        })

    def bind_flow_on_first_span(self, flow_id: int) -> None:
        """Defer the flow-finish to the FIRST span this tracer closes:
        the ``f`` event is stamped just inside that span, so the causal
        arrow from the parent's spawn span lands on the first real work
        the child did (e.g. a shard's compile span) instead of on an
        artificial adoption marker."""
        self._pending_flow = flow_id

    def counter_sample(self, name: str, value: float) -> None:
        """A Chrome-trace counter ('C') sample — gauges call this on every
        ``set`` so they graph as time series in the trace viewer."""
        if value != value:
            # NaN (a poisoned gauge): json.dump would write a bare
            # `NaN` token, which JSON.parse-based trace viewers reject.
            return
        self._record({
            "name": name, "ph": "C", "ts": now_us(), "pid": _pid(),
            "tid": _tid(), "args": {"value": value, "mtype": "gauge"},
        })

    def _push(self, span: Span) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(span)

    def _pop(self, span: Span) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()
            if stack:
                # Parent self-time = dur - children; precomputed here so
                # the summary CLI needs no containment analysis.
                stack[-1]._child_us += span.dur_us
        elif stack and span in stack:  # unwound out of order (generators)
            stack.remove(span)
        args = dict(span.args)
        args["self_us"] = round(max(0.0, span.dur_us - span._child_us), 1)
        pending = self._pending_flow
        if pending is not None:
            # Inherited trace context: land the parent's causal arrow
            # just inside this first-closed span (ts strictly within the
            # slice, so Perfetto's enclosing-slice binding resolves it).
            self._pending_flow = None
            self._record({
                "name": "tdx.flow", "cat": "flow", "ph": "f", "bp": "e",
                "id": pending,
                "ts": span.t0_us + min(1.0, max(0.0, span.dur_us) / 2),
                "pid": _pid(), "tid": _tid(),
            })
        self._record({
            "name": span.name, "cat": span.category, "ph": "X",
            "ts": span.t0_us, "dur": span.dur_us, "pid": _pid(),
            "tid": _tid(), "args": args,
        })

    def _record(self, event: dict) -> None:
        dropped = False
        with self._lock:
            if (
                self.events.maxlen is not None
                and len(self.events) == self.events.maxlen
            ):
                self.dropped += 1  # deque evicts the oldest on append
                dropped = True
            self.events.append(event)
        # Outside the tracer lock: the hooks take their own (counter,
        # ring) locks and must not nest under this one.
        if dropped and _drop_hook is not None:
            _drop_hook(1)
        if _flight_feed is not None:
            _flight_feed(event)

    # -- export ----------------------------------------------------------

    def drain(self) -> List[dict]:
        """Atomically take (and clear) the recorded events — the one
        correct way to flush without losing spans recorded concurrently
        between a copy and a separate clear."""
        with self._lock:
            events = list(self.events)
            self.events.clear()
            return events

    def chrome_events(self, counters=None,
                      events: Optional[List[dict]] = None) -> List[dict]:
        """The Chrome-trace ``traceEvents`` list: recorded events (or the
        explicit ``events`` — e.g. a :meth:`drain` result) plus, if a
        registry is given, one final 'C' sample per counter/gauge and a
        metadata record naming the process."""
        if events is None:
            with self._lock:
                out = list(self.events)
        else:
            out = list(events)
        ts = now_us()
        if counters is not None:
            for rec in counters.snapshot():
                if rec["type"] == "histogram":
                    args = {"count": rec["count"], "sum": rec["sum"],
                            "mtype": "histogram"}
                else:
                    v = rec["value"]
                    if isinstance(v, float) and v != v:
                        v = None  # NaN is not valid JSON in a trace file
                    args = {"value": v, "mtype": rec["type"]}
                labels = rec.get("labels")
                # Label sets become distinct counter names: two kinds of
                # verify_failures must not collide into one last-write
                # sample in the trace (and the summary CLI aggregates
                # them back by name prefix).
                name = rec["name"] + (
                    "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"
                    if labels else ""
                )
                out.append({
                    "name": name, "ph": "C", "ts": ts,
                    "pid": _pid(), "tid": 0, "args": args,
                })
        out.append({
            "name": "process_name", "ph": "M", "pid": _pid(), "tid": 0,
            "args": {"name": f"torchdistx_tpu pid={_pid()}"},
        })
        if _trace_label:
            # Same label on every process of one causal run: a merged
            # Perfetto view groups them (and tdx_trace.py joins dumps to
            # traces) by trace id.
            out.append({
                "name": "process_labels", "ph": "M", "pid": _pid(),
                "tid": 0, "args": {"labels": _trace_label},
            })
        with self._lock:
            dropped = self.dropped
        if dropped:
            out.append({
                "name": "tdx.trace.events_dropped", "ph": "C", "ts": ts,
                "pid": _pid(), "tid": 0, "args": {"value": dropped},
            })
        return out

    def export_chrome(self, path: str, counters=None,
                      events: Optional[List[dict]] = None) -> None:
        """Write a Chrome-trace JSON object (Perfetto-loadable)."""
        doc = {
            "traceEvents": self.chrome_events(counters, events=events),
            "displayTimeUnit": "ms",
        }
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")

    def flush_seq(self) -> int:
        """Monotone per-process sequence number for flush file names."""
        with self._lock:
            self._seq += 1
            return self._seq

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self.dropped = 0


def _pid() -> int:
    import os

    return os.getpid()


def _tid() -> int:
    return threading.get_ident() & 0x7FFFFFFF  # chrome wants small-ish ints
