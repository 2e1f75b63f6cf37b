"""Cross-process causal trace context (the port's own copy of
``torchdistx_tpu/observe/tracectx.py``).

This module threads one **trace id** through a process tree and draws
the spawn edges as Chrome flow events:

* the ROOT process mints a trace id on first use
  (:func:`trace_context`);
* a spawner calls :func:`flow_start` inside its spawn span (the arrow's
  tail) and hands the child :func:`child_env` — one env var,
  ``TDX_TRACE_PARENT="<trace_id>:<flow_id>"``;
* the child ADOPTS the context lazily on its first telemetry emission
  (``observe._arm_autoflush`` calls :func:`adopt`): it inherits the
  trace id and defers the flow-finish to the first span it closes, so
  the merged Chrome trace (``tools/tdx_trace.py chrome``) draws an
  arrow from the parent's spawn span to the child's first real work.

The context is deliberately tiny (no sampling, no baggage): its job is
causal JOINS — Perfetto arrows across pids/hosts.
"""

from __future__ import annotations

import os
import threading
import uuid
from typing import Dict, Optional

__all__ = [
    "TRACE_PARENT_ENV",
    "TraceContext",
    "adopt",
    "child_env",
    "flow_start",
    "reset",
    "trace_context",
]

TRACE_PARENT_ENV = "TDX_TRACE_PARENT"

_lock = threading.Lock()
_ctx: Optional["TraceContext"] = None


class TraceContext:
    """The process's causal identity: one ``trace_id`` per run tree,
    plus the inherited ``flow_id``/raw parent string when this process
    was spawned by an instrumented parent (both ``None`` at the root)."""

    __slots__ = ("trace_id", "flow_id", "parent")

    def __init__(self, trace_id: str, flow_id: Optional[int] = None,
                 parent: Optional[str] = None):
        self.trace_id = trace_id
        self.flow_id = flow_id
        self.parent = parent

    @property
    def inherited(self) -> bool:
        return self.parent is not None

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (f"TraceContext(trace_id={self.trace_id!r}, "
                f"flow_id={self.flow_id!r}, inherited={self.inherited})")


def _parse(raw: str) -> "TraceContext":
    """``"<trace_id>:<flow_id>"`` (flow id optional/empty).  Malformed
    values mint a fresh root context rather than raising: a stale env
    var must never break telemetry."""
    trace_id, _, flow = raw.partition(":")
    trace_id = "".join(c for c in trace_id if c.isalnum())[:32]
    if not trace_id:
        return TraceContext(_mint_id())
    flow_id: Optional[int] = None
    if flow:
        try:
            flow_id = int(flow.split(":")[0])
        except ValueError:
            flow_id = None
    return TraceContext(trace_id, flow_id, parent=raw)


def _mint_id() -> str:
    return uuid.uuid4().hex[:16]


def trace_context() -> TraceContext:
    """This process's trace context: inherited from
    ``TDX_TRACE_PARENT`` when a spawner set it, freshly minted at the
    root.  Idempotent; the first call wins for the process."""
    global _ctx
    if _ctx is not None:
        return _ctx
    with _lock:
        if _ctx is None:
            raw = os.environ.get(TRACE_PARENT_ENV, "")
            _ctx = _parse(raw) if raw else TraceContext(_mint_id())
            from .spans import set_trace_label

            set_trace_label(f"trace={_ctx.trace_id}")
    return _ctx


def adopt(tracer) -> TraceContext:
    """Resolve the context AND, when a parent handed us a flow id,
    schedule the flow-finish on the tracer's first closed span (called
    once from ``observe._arm_autoflush``)."""
    ctx = trace_context()
    if ctx.flow_id is not None:
        tracer.bind_flow_on_first_span(ctx.flow_id)
        ctx.flow_id = None  # one arrow per spawn edge
    return ctx


def flow_start(name: str = "tdx.flow") -> int:
    """Emit a flow-start at the current point (call inside the spawn
    span) and return the flow id for :func:`child_env`."""
    from . import tracer

    trace_context()
    return tracer().flow_start(name)


def child_env(flow_id: Optional[int] = None,
              base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment for a spawned child: ``base`` (default: a copy of
    ``os.environ``) with ``TDX_TRACE_PARENT`` carrying this process's
    trace id and, when given, the spawn edge's flow id."""
    ctx = trace_context()
    env = dict(os.environ if base is None else base)
    token = ctx.trace_id
    if flow_id is not None:
        token += f":{flow_id}"
    env[TRACE_PARENT_ENV] = token
    return env


def reset() -> None:
    """Forget the process context (tests only — a real process has
    exactly one causal identity)."""
    global _ctx
    with _lock:
        _ctx = None
        from .spans import set_trace_label

        set_trace_label(None)
