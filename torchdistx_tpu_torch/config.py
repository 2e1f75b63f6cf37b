"""Runtime configuration (the port's own copy of the kernel-cache,
registry, telemetry, serving, chaos, flight-recorder, reshard and
logging knobs of
``torchdistx_tpu/config.py``):
resolved from environment variables once at import and overridable per
scope::

    import torchdistx_tpu_torch.config as tdx_config
    print(tdx_config.get())                # effective config
    with tdx_config.override(trace_dir="/tmp/traces"):
        ...                                # spans + counters collected

Environment variables (read at first import):

======================  ====================================================
``TDX_CACHE_DIR``       Local directory of the nvcc-built kernel libraries
                        (:mod:`torchdistx_tpu_torch.ops._build`), each
                        beside its CRC sidecar and nvcc's log ("" means
                        ``torchdistx_tpu_torch/_build/`` in the checkout).
``TDX_REGISTRY_DIR``    Shared artifact registry directory
                        (:mod:`torchdistx_tpu_torch.registry`): when set, a
                        library missing from the local cache is fetched
                        from it before nvcc builds it, and a library built
                        here is published to it — the warm bring-up path
                        ("" disables).
``TDX_TRACE_DIR``       Directory for runtime telemetry traces: when set,
                        :mod:`torchdistx_tpu_torch.observe` collects spans
                        and flushes a Chrome-trace JSON file
                        (Perfetto-loadable) there at process exit or
                        ``observe.flush()`` ("" disables).
``TDX_METRICS_PATH``    File for the telemetry counter registry: Prometheus
                        text format if the path ends in ``.prom``, JSON
                        lines otherwise ("" disables).  ``%h``/``%p`` in the
                        path expand to hostname/pid at write time (opt-in:
                        paths without the tokens are used verbatim), so
                        concurrent hosts and subprocesses of one run cannot
                        clobber each other's file.
``TDX_FLIGHT_DIR``      Directory for flight-recorder post-mortem dumps
                        (:mod:`torchdistx_tpu_torch.observe.flightrec`):
                        when set, a bounded ring of recent telemetry events
                        is kept per process and dumped atomically there on
                        chaos injections, serve faults and preemptions, and
                        unhandled exceptions ("" disables).  ``%h``/``%p``
                        expand like ``TDX_METRICS_PATH``.  The ring holds
                        the last ``TDX_FLIGHT_EVENTS`` events (default
                        4096), read once at import.
``TDX_METRICS_EXPORT_S``
                        Period (seconds) of the background metrics-exporter
                        thread: when > 0, the counter registry (and the
                        serve SLO percentile gauges) are re-exported to
                        ``TDX_METRICS_PATH`` every interval (0 disables).
``TDX_FAULT_PLAN``      Deterministic fault-injection plan
                        (:mod:`torchdistx_tpu_torch.chaos`), e.g.
                        ``"serve@4=raise;compile@1=raise"`` ("" disables).
``TDX_PREFILL_CHUNK``   Default chunk-size cap for serving chunked prefill
                        (:mod:`torchdistx_tpu_torch.serve`): max prompt
                        tokens a lane prefills per engine tick.  0
                        (default) means the largest prefill bucket, i.e.
                        one chunk for any prompt that fits a bucket.  A
                        host-side scheduling knob: the captured program
                        set is the same at every setting.
``TDX_SPEC_DECODE``     "0" disables speculative decoding on the serving
                        hot path (:mod:`torchdistx_tpu_torch.serve`): the
                        n-gram drafter, the batched ``verify-<k>`` tick
                        and KV rollback.  On by default: greedy accept
                        keeps every float32 completion equal to the
                        unbatched oracle, so the switch trades only
                        throughput.
``TDX_SPEC_K``          Max draft length per lane per verify tick
                        (default 4, clamped to the largest verify
                        bucket).  A host-side scheduling knob: the
                        ``verify-<k>`` programs are fixed by
                        ``ServeConfig.spec_buckets``, not by this value.
``TDX_REQUEST_LEDGER``  "0" disables the per-request attribution ledger
                        (:mod:`torchdistx_tpu_torch.observe.reqledger`):
                        each request's typed event timeline and its
                        queue/prefill/decode/guardrail latency split.  On
                        by default (it runs only while telemetry is on).
``TDX_LEDGER_EVENTS``   Per-request event-timeline cap (default 128): older
                        events are dropped (and counted) once a request's
                        timeline is full.
``TDX_RESHARD_CHUNK_MB`` Host staging budget (MiB, default 64) of one
                        transfer chunk of the reshard engine
                        (:mod:`torchdistx_tpu_torch.reshard`): a shard
                        block over it is read in slabs of at most this
                        many bytes.
``TDX_LOG_LEVEL``       Level of the framework logger
                        (:func:`torchdistx_tpu_torch.utils.get_logger`),
                        default ``INFO``.
======================  ====================================================
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass, replace
from typing import Iterator, Optional

__all__ = ["Config", "bind", "expand_path", "get", "override"]


@dataclass(frozen=True)
class Config:
    cache_dir: Optional[str] = None
    registry_dir: Optional[str] = None
    trace_dir: Optional[str] = None
    metrics_path: Optional[str] = None
    flight_dir: Optional[str] = None
    metrics_export_s: float = 0.0
    fault_plan: Optional[str] = None
    prefill_chunk: int = 0
    spec_decode: bool = True
    spec_k: int = 4
    request_ledger: bool = True
    ledger_events: int = 128
    reshard_chunk_mb: float = 64.0
    log_level: str = "INFO"


def _from_env() -> Config:
    return Config(
        cache_dir=os.environ.get("TDX_CACHE_DIR", "") or None,
        registry_dir=os.environ.get("TDX_REGISTRY_DIR", "") or None,
        trace_dir=os.environ.get("TDX_TRACE_DIR", "") or None,
        metrics_path=os.environ.get("TDX_METRICS_PATH", "") or None,
        flight_dir=os.environ.get("TDX_FLIGHT_DIR", "") or None,
        metrics_export_s=float(os.environ.get("TDX_METRICS_EXPORT_S", "0")),
        fault_plan=os.environ.get("TDX_FAULT_PLAN", "") or None,
        prefill_chunk=int(os.environ.get("TDX_PREFILL_CHUNK", "0")),
        spec_decode=os.environ.get("TDX_SPEC_DECODE", "1") != "0",
        spec_k=int(os.environ.get("TDX_SPEC_K", "4")),
        request_ledger=os.environ.get("TDX_REQUEST_LEDGER", "1") != "0",
        ledger_events=int(os.environ.get("TDX_LEDGER_EVENTS", "128")),
        reshard_chunk_mb=float(os.environ.get("TDX_RESHARD_CHUNK_MB", "64")),
        log_level=os.environ.get("TDX_LOG_LEVEL", "INFO"),
    )


_base = _from_env()
_tls = threading.local()


def expand_path(path: Optional[str]) -> Optional[str]:
    """Expand the multi-process template tokens in a telemetry path:
    ``%h`` → short hostname, ``%p`` → pid.  Opt-in — a path without the
    tokens is returned verbatim.  Applied at WRITE time by
    ``observe.flush``, the metrics exporter and the flight recorder, so
    one config value fans out correctly across hosts and subprocesses."""
    if not path or "%" not in path:
        return path
    if "%h" in path:
        import socket

        path = path.replace("%h", socket.gethostname().split(".")[0])
    if "%p" in path:
        path = path.replace("%p", str(os.getpid()))
    return path


def get() -> Config:
    """The effective config (innermost :func:`override` scope, else the
    process-wide base)."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else _base


def override(**kw):
    """Thread-local scoped override: ``with override(trace_dir=d): ...``
    (a :func:`bind` of the current effective config with ``kw`` replaced)."""
    return bind(replace(get(), **kw))


@contextlib.contextmanager
def bind(cfg: Config) -> Iterator[Config]:
    """Thread-local scope binding an EXACT ``Config``: work fanned out to
    worker threads re-enters the submitting thread's ``get()`` with this,
    so per-scope knobs mean the same thing on every thread of one logical
    operation."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(cfg)
    try:
        yield cfg
    finally:
        stack.pop()
