"""Counter/gauge/histogram registry with Prometheus + JSON-lines export
(the port's own copy of ``torchdistx_tpu/observe/metrics.py``).

All types are thread-safe; histograms store fixed-bucket counts (never
raw samples) so a long run cannot grow memory.
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

_DEFAULT_BUCKETS = (0.001, 0.01, 0.1, 1.0, 10.0, 60.0, 600.0)

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, Any]) -> _Key:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "labels", "_lock", "value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins value; each ``set`` also feeds the tracer a
    Chrome-trace counter sample (time series in the trace view)."""

    __slots__ = ("name", "labels", "_lock", "value", "_on_sample")

    def __init__(self, name: str, labels: Dict[str, str],
                 on_sample: Optional[Callable[[str, float], None]] = None):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self.value: Optional[float] = None
        self._on_sample = on_sample

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)
        if self._on_sample is not None:
            self._on_sample(self.name, float(value))


class Histogram:
    """Fixed-bucket histogram (Prometheus ``le`` convention: cumulative
    on export, per-bucket internally)."""

    __slots__ = ("name", "labels", "buckets", "_lock", "counts", "count",
                 "sum", "min", "max")

    def __init__(self, name: str, labels: Dict[str, str], buckets=None):
        self.name = name
        self.labels = labels
        self.buckets = tuple(buckets) if buckets else _DEFAULT_BUCKETS
        self._lock = threading.Lock()
        self.counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: float, n: int = 1) -> None:
        """Record ``value``; ``n`` > 1 records it as n identical samples
        in one lock round-trip (a W-wide decode tick is W token
        deliveries at the same latency)."""
        value = float(value)
        with self._lock:
            i = 0
            while i < len(self.buckets) and value > self.buckets[i]:
                i += 1
            self.counts[i] += n
            self.count += n
            self.sum += value * n
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)


class Counters:
    """The registry: one instance per process (``observe.counters()``)."""

    def __init__(self, on_sample: Optional[Callable[[str, float], None]] = None):
        self._lock = threading.Lock()
        self._metrics: Dict[_Key, Any] = {}
        self._on_sample = on_sample

    def _get(self, cls, name: str, labels: Dict[str, Any], **kw):
        key = _key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, dict(key[1]), **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels, on_sample=self._on_sample)

    def histogram(self, name: str, buckets=None, **labels) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def empty(self) -> bool:
        with self._lock:
            return not self._metrics

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- export ----------------------------------------------------------

    def snapshot(self) -> List[dict]:
        """Point-in-time records, one per metric (JSON-friendly).

        Each metric is read under ITS OWN lock, so a histogram observed
        concurrently can never snapshot torn (count, sum, and the bucket
        vector are copied atomically — Prometheus consumers rely on
        ``sum(buckets) == count``); different metrics may still reflect
        slightly different instants, which is inherent to any
        multi-metric scrape."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: List[dict] = []
        for m in metrics:
            rec: Dict[str, Any] = {"name": m.name}
            if m.labels:
                rec["labels"] = dict(m.labels)
            if isinstance(m, Counter):
                with m._lock:
                    rec.update(type="counter", value=m.value)
            elif isinstance(m, Gauge):
                with m._lock:
                    rec.update(type="gauge", value=m.value)
            else:
                with m._lock:
                    rec.update(
                        type="histogram", count=m.count, sum=m.sum,
                        min=m.min, max=m.max,
                        buckets=dict(zip(
                            [str(b) for b in m.buckets] + ["+Inf"],
                            list(m.counts),
                        )),
                    )
            out.append(rec)
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (names sanitized: dots and
        dashes become underscores).  Records are grouped by metric name —
        exactly ONE ``# TYPE`` line per name with its samples contiguous,
        as strict text-format parsers require when a name carries several
        label sets."""
        by_name: Dict[str, List[dict]] = {}
        order: List[str] = []
        for rec in self.snapshot():
            name = _prom_name(rec["name"])
            if name not in by_name:
                by_name[name] = []
                order.append(name)
            by_name[name].append(rec)
        lines: List[str] = []
        for name in order:
            recs = by_name[name]
            lines.append(f"# TYPE {name} {recs[0]['type']}")
            for rec in recs:
                labels = _prom_labels(rec.get("labels"))
                if rec["type"] in ("counter", "gauge"):
                    lines.append(f"{name}{labels} {_prom_num(rec['value'])}")
                else:
                    cum = 0
                    for le, n in rec["buckets"].items():
                        cum += n
                        lab = _prom_labels(
                            {**(rec.get("labels") or {}), "le": le}
                        )
                        lines.append(f"{name}_bucket{lab} {cum}")
                    lines.append(f"{name}_sum{labels} {_prom_num(rec['sum'])}")
                    lines.append(f"{name}_count{labels} {rec['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def export_jsonl(self, path: str) -> None:
        """Append one snapshot record per metric as JSON lines (NaN →
        null: bare ``NaN`` tokens are not JSON and break strict
        parsers; Prometheus text keeps ``NaN``, which IS valid there)."""
        ts = time.time()
        with open(path, "a") as f:
            for rec in self.snapshot():
                v = rec.get("value")
                if isinstance(v, float) and v != v:
                    rec = {**rec, "value": None}
                f.write(json.dumps({"ts": ts, **rec}) + "\n")


def _prom_name(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _prom_escape(value: Any) -> str:
    """Prometheus label-value escaping (text exposition format §label
    values): backslash, double-quote, and newline must be escaped or a
    value like ``He said "hi"\\n`` corrupts the whole exposition."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _prom_labels(labels: Optional[Dict[str, Any]]) -> str:
    if not labels:
        return ""
    body = ",".join(
        f'{_prom_name(str(k))}="{_prom_escape(v)}"'
        for k, v in sorted(labels.items())
    )
    return "{" + body + "}"


def _prom_num(value) -> str:
    if value is None:
        return "NaN"
    f = float(value)
    if f != f:  # NaN: repr() would emit 'nan', which parsers reject
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    return str(int(f)) if f == int(f) else repr(f)
