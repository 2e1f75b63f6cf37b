"""Serve SLOs (the port's own copy of ``torchdistx_tpu/observe/slo.py``):
sliding-window latency percentiles and a periodic exporter.

An operator pages on percentiles, not means.  This module provides:

* :class:`SloWindow`: a bounded sliding window (time- and count-capped)
  of latency samples with exact small-N percentiles;
* :class:`ServeSLO`: the serve vocabulary (TTFT, per-token latency and
  queue wait), published as
  ``tdx.serve.slo.{ttft,token,queue_wait}_p{50,95,99}_s`` gauges on
  every :meth:`ServeSLO.publish`;
* :func:`ensure_exporter`: a daemon thread (armed by
  ``TDX_METRICS_EXPORT_S`` > 0) that every interval republishes the SLO
  gauges, snapshots counters into the flight recorder's history, and
  rewrites ``TDX_METRICS_PATH`` (Prometheus text or JSONL append, with
  ``%h``/``%p`` expansion).

``serve.engine.ServeEngine`` feeds the windows on every tick.
"""

from __future__ import annotations

import math
import os
import threading
import time
import weakref
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["ServeSLO", "SloWindow", "ensure_exporter", "snapshot_all",
           "stop_exporter"]

_DEFAULT_WINDOW_S = 300.0
_DEFAULT_MAX_SAMPLES = 4096
PERCENTILES = (50, 95, 99)


class SloWindow:
    """Sliding window of (timestamp, value) samples; thread-safe."""

    def __init__(self, window_s: float = _DEFAULT_WINDOW_S,
                 max_samples: int = _DEFAULT_MAX_SAMPLES):
        self.window_s = window_s
        self._lock = threading.Lock()
        self._samples: "deque[Tuple[float, float, int]]" = deque(
            maxlen=max_samples)
        self.total_count = 0

    def observe(self, value: float, *, n: int = 1,
                now: Optional[float] = None) -> None:
        """Record ``value``; ``n`` > 1 records it as n identical samples
        in ONE window entry (a W-wide decode tick is W token deliveries
        at the same latency — one entry per tick keeps the advertised
        window span instead of shrinking it W-fold under load)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._samples.append((now, float(value), int(n)))
            self.total_count += n

    def _live(self, now: Optional[float]) -> list:
        now = time.monotonic() if now is None else now
        cutoff = now - self.window_s
        with self._lock:
            # Age out the expired prefix in place (samples arrive in time
            # order), then copy the survivors.
            while self._samples and self._samples[0][0] < cutoff:
                self._samples.popleft()
            return [(v, n) for _t, v, n in self._samples]

    def percentiles(self, qs: Sequence[int] = PERCENTILES,
                    *, now: Optional[float] = None
                    ) -> Optional[Dict[int, float]]:
        """Exact weighted percentiles over the live window
        (nearest-rank), or None when the window is empty."""
        pairs = sorted(self._live(now))
        total = sum(n for _v, n in pairs)
        if not total:
            return None
        out: Dict[int, float] = {}
        for q in qs:
            # Nearest-rank is ceil, not round: round() would hand back
            # the sample BELOW the true rank on exact .5 ranks (p50 of
            # 5 samples must be the 3rd, not the 2nd).
            rank = min(total, max(1, math.ceil(q / 100.0 * total)))
            cum = 0
            for v, n in pairs:
                cum += n
                if cum >= rank:
                    out[q] = v
                    break
        return out

    def count(self, *, now: Optional[float] = None) -> int:
        return sum(n for _v, n in self._live(now))


class ServeSLO:
    """The serve loop's SLO windows and their gauge publication."""

    METRICS = ("ttft", "token", "queue_wait")

    def __init__(self, window_s: float = _DEFAULT_WINDOW_S,
                 name: str = "serve"):
        self.name = name
        self.windows: Dict[str, SloWindow] = {
            m: SloWindow(window_s) for m in self.METRICS
        }
        self._published: set = set()
        # Live-registry registration (weak: a test's short-lived engine
        # must not pin its SLO windows for the process lifetime).  The
        # /slo endpoint and snapshot_all() read it back.
        with _registry_lock:
            _registry[name] = self

    def observe_ttft(self, seconds: float) -> None:
        self.windows["ttft"].observe(seconds)

    def observe_token_latency(self, seconds: float, n: int = 1) -> None:
        self.windows["token"].observe(seconds, n=n)

    def observe_queue_wait(self, seconds: float) -> None:
        self.windows["queue_wait"].observe(seconds)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """{metric: {"p50": ..., "p95": ..., "p99": ..., "count": n}}
        for the non-empty windows."""
        out: Dict[str, Dict[str, float]] = {}
        for name, w in self.windows.items():
            pct = w.percentiles()
            if pct is None:
                continue
            out[name] = {f"p{q}": v for q, v in pct.items()}
            out[name]["count"] = w.count()
        return out

    def publish(self) -> Dict[str, Dict[str, float]]:
        """Publish the percentile gauges (when telemetry is enabled) and
        return the snapshot."""
        snap = self.snapshot()
        from . import enabled, gauge

        if enabled():
            for name, stats in snap.items():
                for q in PERCENTILES:
                    v = stats.get(f"p{q}")
                    if v is not None:
                        gauge(f"tdx.serve.slo.{name}_p{q}_s").set(round(v, 6))
                gauge(f"tdx.serve.slo.{name}_window_count").set(stats["count"])
                self._published.add(name)
            for name in self._published - set(snap):
                # The window aged out since the last publish: without
                # this, the periodic exporter would keep presenting an
                # hours-old p99 as the current window.  NaN says "no
                # live value", count 0 says why.
                for q in PERCENTILES:
                    gauge(f"tdx.serve.slo.{name}_p{q}_s").set(float("nan"))
                gauge(f"tdx.serve.slo.{name}_window_count").set(0)
            self._published &= set(snap)
        return snap


# -- live registry -----------------------------------------------------------

# name → live ServeSLO (weak values: engines come and go; the registry
# must never keep one alive).  Same-name re-registration is last-wins —
# one replica per process is the deployment shape.
_registry_lock = threading.Lock()
_registry: "weakref.WeakValueDictionary[str, ServeSLO]" = (
    weakref.WeakValueDictionary()
)


def snapshot_all() -> Dict[str, Dict[str, Dict[str, float]]]:
    """{slo_name: {metric: {"p50": ..., "count": n}}} for every live
    :class:`ServeSLO` — what the ``/slo`` endpoint serves."""
    with _registry_lock:
        slos = dict(_registry)
    return {name: slo.snapshot() for name, slo in sorted(slos.items())}


# -- periodic exporter -------------------------------------------------------

_exporter_lock = threading.Lock()
_exporter: Optional["_Exporter"] = None


class _Exporter(threading.Thread):
    def __init__(self, interval_s: float, metrics_path: Optional[str],
                 slo: Optional[ServeSLO]):
        super().__init__(daemon=True, name="tdx-metrics-exporter")
        self.interval_s = max(0.05, interval_s)
        self.metrics_path = metrics_path
        self.slo = slo
        self._stop_evt = threading.Event()
        self.exports = 0

    def stop(self) -> None:
        self._stop_evt.set()

    def run(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self.export_once()
            except Exception:  # noqa: BLE001 — the exporter never kills a run
                pass
            self._stop_evt.wait(self.interval_s)
        try:
            self.export_once()  # final values on clean shutdown
        except Exception:  # noqa: BLE001
            pass

    def export_once(self) -> None:
        from .. import config
        from . import counters
        from . import flightrec

        if self.slo is not None:
            self.slo.publish()
        flightrec.snapshot_counters()
        path = config.expand_path(self.metrics_path)
        if not path or counters().empty():
            return
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        if path.endswith(".prom"):
            # Atomic rewrite: a textfile-collector scrape must never read
            # a half-written exposition.
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(counters().to_prometheus())
            os.replace(tmp, path)
        else:
            counters().export_jsonl(path)
        self.exports += 1


def ensure_exporter(slo: Optional[ServeSLO] = None) -> Optional[_Exporter]:
    """Start the periodic exporter if ``metrics_export_s`` > 0 and none
    is running; attaches ``slo`` (first caller wins) so its gauges ride
    every export.  Returns the exporter (None when disabled)."""
    from .. import config

    cfg = config.get()
    if cfg.metrics_export_s <= 0:
        return None
    global _exporter
    with _exporter_lock:
        if _exporter is not None and _exporter.is_alive():
            if slo is not None and _exporter.slo is None:
                _exporter.slo = slo
            return _exporter
        _exporter = _Exporter(cfg.metrics_export_s, cfg.metrics_path, slo)
        _exporter.start()
        return _exporter


def stop_exporter() -> None:
    """Stop the running exporter, flushing one final export (tests and
    orderly shutdown)."""
    global _exporter
    with _exporter_lock:
        ex, _exporter = _exporter, None
    if ex is not None:
        ex.stop()
        ex.join(timeout=5.0)
