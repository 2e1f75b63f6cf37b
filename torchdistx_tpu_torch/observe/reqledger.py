"""Per-request tail attribution (the port's own copy of
``torchdistx_tpu/observe/reqledger.py``): request ledger, tail
aggregator and occupancy time-series for the serve stack.

* **Request ledger**: every request the engine touches carries a
  compact typed event timeline (enqueue, dispatch, admit with its prefix
  hit, each ``chunk-<bucket>`` prefill tick, coalesced decode ticks,
  coalesced speculative ``verify`` ticks with drafted/accepted tallies,
  COW copies, preemption, deadline cancel, finish) plus a stage state
  machine that splits end-to-end latency into **queue / prefill / decode
  / guardrail** time *by construction*: every wall-clock interval
  between enqueue and the terminal event lands in exactly one bucket,
  and an aborted attempt's prefill + decode time (a preemption, a fault)
  folds into ``guardrail_s``, so the four stages always sum to the
  end-to-end latency.  One pid-salted flow id
  (:meth:`~.spans.Tracer.flow_start`) is minted per request and stamped
  on every emitted instant.
* **Tail aggregator**: finished requests feed per-stage latency
  histograms (``tdx.serve.stage_{queue,prefill,decode,guardrail}_s``)
  and a bounded summary window; :func:`tail_report` renders
  p50/p95/p99 end-to-end latency and a **p99 blame** breakdown (mean
  stage share among the slowest requests).  Flight-recorder dumps carry
  it (:mod:`.flightrec`).
* **Occupancy ring**: per-engine-tick samples of decode-lane occupancy,
  free/shared pages, prefix hit rate and queue depth, ring-buffered here
  and mirrored as gauges.

Everything is bounded: per-request timelines cap at
``Config.ledger_events`` (drops counted); the live table, finished
window and occupancy ring are fixed-size deques.  The kill switch is
``TDX_REQUEST_LEDGER=0`` (every hook degrades to one enabled-check);
with telemetry off entirely the ledger costs nothing.

Hedging note (for a fleet): two replicas can run one request at once.
The stage machine tracks the request's *externally visible* stage, so
wall-clock is never double-counted, and an abort only reopens the queue
stage when it removes the LAST active attempt.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = [
    "STAGES",
    "enabled",
    "flight_snapshot",
    "flow_id",
    "occupancy_report",
    "occupancy_sample",
    "on_abort",
    "on_admit",
    "on_chunk",
    "on_cow",
    "on_decode",
    "on_enqueue",
    "on_event",
    "on_finish",
    "on_reject",
    "on_spec",
    "on_version",
    "requests_report",
    "reset",
    "summary",
    "tail_report",
]

STAGES = ("queue", "prefill", "decode", "guardrail")

_MAX_LIVE = 8192       # in-flight records (queue depth bounds this anyway)
_RECENT = 128          # finished records kept with full timelines (/requests)
_TAIL_WINDOW = 512     # finished summaries feeding tail_report()
_OCC_RING = 1024       # occupancy samples

_LOCK = threading.Lock()


def _cfg():
    from .. import config as tdx_config

    return tdx_config.get()


def enabled() -> bool:
    """Ledger hooks fire only when telemetry is on AND the
    ``TDX_REQUEST_LEDGER`` kill switch hasn't disabled them."""
    from .. import observe

    return observe.enabled() and _cfg().request_ledger


class _Record:
    """One request's ledger entry; mutated under the module lock."""

    __slots__ = (
        "rid", "t0", "flow", "events", "dropped", "stage", "stage_t",
        "acc", "att", "active", "attempts", "priority", "deadline_s",
        "n_prompt", "prefix_tokens", "hedged", "cow_copies", "tokens",
        "outcome", "e2e_s", "_decode_ev",
        "spec_drafted", "spec_accepted", "spec_ticks", "_spec_ev",
        "version",
    )

    def __init__(self, rid: str, now: float, flow: Optional[int],
                 max_events: int):
        self.rid = rid
        self.t0 = now
        self.flow = flow
        self.events: "deque[dict]" = deque(maxlen=max(8, max_events))
        self.dropped = 0
        self.stage = "queue"
        self.stage_t = now
        self.acc = {"queue": 0.0, "prefill": 0.0, "decode": 0.0,
                    "guardrail": 0.0}
        self.att = {"prefill": 0.0, "decode": 0.0}  # current attempt
        self.active: set = set()  # replicas currently running an attempt
        self.attempts = 0
        self.priority: Optional[int] = None
        self.deadline_s: Optional[float] = None
        self.n_prompt: Optional[int] = None
        self.prefix_tokens = 0
        self.hedged = False
        self.cow_copies = 0
        self.tokens = 0
        self.outcome: Optional[str] = None
        self.e2e_s: Optional[float] = None
        self._decode_ev: Optional[dict] = None
        # Speculative-decoding tallies: verify ticks coalesce like
        # decode ticks, and the
        # draft/verify/accept work all lands in DECODE stage time —
        # speculation changes how decode time is spent, not the stage
        # decomposition.
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_ticks = 0
        self._spec_ev: Optional[dict] = None
        # The weight version the serving replica ran (a fleet's rollover).
        self.version: Optional[str] = None

    # -- stage machine ---------------------------------------------------

    def touch(self, now: float, new_stage: Optional[str] = None) -> None:
        """Flush the interval since the last transition into the current
        stage's bucket (queue → final accumulator; prefill/decode → the
        attempt-local accumulator, whose fate the attempt's end
        decides), then optionally switch stage."""
        dt = max(0.0, now - self.stage_t)
        if self.stage == "queue":
            self.acc["queue"] += dt
        else:
            self.att[self.stage] += dt
        self.stage_t = now
        if new_stage is not None and new_stage != self.stage:
            self.stage = new_stage
            if new_stage == "decode":
                # Next tick opens a fresh coalesced event (plain decode
                # and verify stretches alike).
                self._decode_ev = None
                self._spec_ev = None

    def fold_attempt(self, *, ok: bool) -> None:
        """End the current attempt: its prefill/decode time becomes real
        prefill/decode (success) or guardrail time (abort)."""
        if ok:
            self.acc["prefill"] += self.att["prefill"]
            self.acc["decode"] += self.att["decode"]
        else:
            self.acc["guardrail"] += self.att["prefill"] + self.att["decode"]
        self.att = {"prefill": 0.0, "decode": 0.0}

    def add_event(self, now: float, kind: str, **attrs) -> dict:
        ev = {"t": round(now - self.t0, 6), "k": kind}
        if attrs:
            ev.update(attrs)
        if (self.events.maxlen is not None
                and len(self.events) == self.events.maxlen):
            self.dropped += 1
        self.events.append(ev)
        return ev

    # -- export ----------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        out = {
            "rid": self.rid,
            "stage": self.stage if self.outcome is None else "done",
            "outcome": self.outcome,
            "attempts": self.attempts + (1 if self.active else 0),
            "tokens": self.tokens,
            "prefix_tokens": self.prefix_tokens,
            "cow_copies": self.cow_copies,
            "hedged": self.hedged,
            "flow": self.flow,
            "queue_s": round(self.acc["queue"], 6),
            "prefill_s": round(self.acc["prefill"], 6),
            "decode_s": round(self.acc["decode"], 6),
            "guardrail_s": round(self.acc["guardrail"], 6),
        }
        if self.spec_ticks:
            # Only when speculation actually ran: requests served with
            # spec off (or all-plain ticks) keep the historical shape.
            out["spec_drafted"] = self.spec_drafted
            out["spec_accepted"] = self.spec_accepted
            out["spec_ticks"] = self.spec_ticks
        if self.priority is not None:
            out["priority"] = self.priority
        if self.n_prompt is not None:
            out["n_prompt"] = self.n_prompt
        if self.e2e_s is not None:
            out["e2e_s"] = round(self.e2e_s, 6)
        if self.dropped:
            out["events_dropped"] = self.dropped
        if self.version is not None:
            out["version"] = self.version
        return out

    def detail(self) -> Dict[str, Any]:
        out = self.summary()
        out["events"] = list(self.events)
        return out


# -- module state ----------------------------------------------------------

_LIVE: Dict[str, _Record] = {}
_RECENT_DONE: "deque[_Record]" = deque(maxlen=_RECENT)
_TAIL: "deque[dict]" = deque(maxlen=_TAIL_WINDOW)
_OCC: "deque[dict]" = deque(maxlen=_OCC_RING)
_FINISHED = 0
_RECORDS_DROPPED = 0


def _get(rid: str) -> Optional[_Record]:
    return _LIVE.get(rid)


def _new_record(rid: str, now: float) -> Optional[_Record]:
    """Create (and index) a record; the caller holds the lock.  Returns
    None when the live table is full — the request is simply not
    attributed (counted), never an error on the serve path."""
    global _RECORDS_DROPPED
    if len(_LIVE) >= _MAX_LIVE:
        _RECORDS_DROPPED += 1
        return None
    rec = _Record(rid, now, None, _cfg().ledger_events)
    _LIVE[rid] = rec
    return rec


# -- lifecycle hooks (the serve stack calls these) -------------------------


def on_enqueue(rid: str, *, priority: Optional[int] = None,
               deadline_s: Optional[float] = None,
               n_prompt: Optional[int] = None) -> None:
    """A request entered the serve stack (fleet admission queue, or a
    standalone engine's submit).  First call mints the record and its
    flow id; repeats (fleet submit then engine submit) are no-ops."""
    if not enabled():
        return
    from .. import observe

    now = time.perf_counter()
    with _LOCK:
        if rid in _LIVE:
            return
        rec = _new_record(rid, now)
        if rec is None:
            return
        rec.priority = priority
        rec.deadline_s = deadline_s
        rec.n_prompt = n_prompt
        rec.add_event(now, "enqueue",
                      **({} if priority is None else {"priority": priority}))
    # Outside the ledger lock: the tracer takes its own lock and tees
    # into the flight ring.  The flow id is the request's join key
    # across replicas/pids — every instant we emit carries it.
    rec.flow = observe.tracer().flow_start("tdx.serve.request")


def on_event(rid: str, kind: str, **attrs) -> None:
    """Append a bare typed event (dispatch, hedge, hedge_win, breaker,
    shed...) to the request's timeline — no stage change."""
    if not enabled():
        return
    now = time.perf_counter()
    with _LOCK:
        rec = _get(rid)
        if rec is None:
            return
        if kind == "hedge":
            rec.hedged = True
        rec.add_event(now, kind, **attrs)


def on_admit(rid: str, *, replica: str = "local",
             prefix_tokens: int = 0) -> None:
    """An engine mapped the request's pages and began prefill.  The
    first active attempt closes the queue stage."""
    if not enabled():
        return
    now = time.perf_counter()
    with _LOCK:
        rec = _get(rid)
        if rec is None:
            return
        first = not rec.active
        rec.active.add(replica)
        if prefix_tokens:
            rec.prefix_tokens = max(rec.prefix_tokens, prefix_tokens)
        rec.add_event(now, "admit", replica=replica,
                      **({"prefix": prefix_tokens} if prefix_tokens else {}))
        if first and rec.stage == "queue":
            rec.touch(now, "prefill")


def on_chunk(rid: str, *, bucket: int, n_tokens: int,
             replica: str = "local") -> None:
    """One chunked-prefill tick ran a ``chunk-<bucket>`` program over
    ``n_tokens`` of this request's prompt."""
    if not enabled():
        return
    now = time.perf_counter()
    with _LOCK:
        rec = _get(rid)
        if rec is None:
            return
        rec.touch(now)
        rec.add_event(now, "chunk", bucket=bucket, n=n_tokens,
                      replica=replica)


def on_decode(rid: str, *, n_lanes: int, replica: str = "local") -> None:
    """One batched decode tick produced a token for this request.  Ticks
    coalesce into ONE in-place-updated event per decode stretch, so a
    64-token generation costs one timeline slot, not 64."""
    if not enabled():
        return
    now = time.perf_counter()
    with _LOCK:
        rec = _get(rid)
        if rec is None:
            return
        rec.touch(now, "decode")
        ev = rec._decode_ev
        if ev is None or rec.events[-1] is not ev:
            # Not the latest event (a cancel/COW interleaved, or a fresh
            # stretch): open a new coalesced tick event.
            ev = rec.add_event(now, "decode", ticks=0, toks=0,
                               lanes=n_lanes, replica=replica)
            rec._decode_ev = ev
        ev["ticks"] += 1
        ev["toks"] += 1
        ev["lanes"] = n_lanes
        ev["t_last"] = round(now - rec.t0, 6)
        rec.tokens += 1


def on_spec(rid: str, *, drafted: int, accepted: int, emitted: int,
            n_lanes: int, replica: str = "local") -> None:
    """One speculative verify tick for this request: ``drafted`` tokens
    proposed, ``accepted`` of them kept, ``emitted`` tokens delivered
    (accepted + one corrected/bonus token).  Ticks coalesce into ONE
    in-place-updated ``verify`` event per decode stretch — the
    speculative sibling of :func:`on_decode` — and the time lands in
    the decode stage, so the four-stage sum-to-e2e contract is
    untouched by speculation."""
    if not enabled():
        return
    now = time.perf_counter()
    with _LOCK:
        rec = _get(rid)
        if rec is None:
            return
        rec.touch(now, "decode")
        ev = rec._spec_ev
        if ev is None or rec.events[-1] is not ev:
            ev = rec.add_event(now, "verify", ticks=0, drafted=0,
                               accepted=0, toks=0, lanes=n_lanes,
                               replica=replica)
            rec._spec_ev = ev
        ev["ticks"] += 1
        ev["drafted"] += drafted
        ev["accepted"] += accepted
        ev["toks"] += emitted
        ev["lanes"] = n_lanes
        ev["t_last"] = round(now - rec.t0, 6)
        rec.tokens += emitted
        rec.spec_drafted += drafted
        rec.spec_accepted += accepted
        rec.spec_ticks += 1


def on_cow(rid: str, *, replica: str = "local") -> None:
    """A copy-on-write page duplication on this request's write path."""
    if not enabled():
        return
    now = time.perf_counter()
    with _LOCK:
        rec = _get(rid)
        if rec is None:
            return
        rec.cow_copies += 1
        rec.add_event(now, "cow", replica=replica)


def on_version(rid: str, version: Optional[str]) -> None:
    """Stamp the weight version the request is being served under (a
    fleet's blue-green rollover), at dispatch; a re-dispatch after a
    requeue restamps (last wins)."""
    if version is None or not enabled():
        return
    with _LOCK:
        rec = _get(rid)
        if rec is None:
            return
        rec.version = version


def on_abort(rid: str, *, replica: str = "local", reason: str = "") -> None:
    """An attempt ended without finishing (preempt, replica death,
    hedge loss, mid-decode deadline cancel).  The attempt's
    prefill/decode time folds into guardrail time; when it was the LAST
    active attempt the request is back in a queue and the stage machine
    follows it there."""
    if not enabled():
        return
    now = time.perf_counter()
    with _LOCK:
        rec = _get(rid)
        if rec is None:
            return
        rec.add_event(now, "abort", replica=replica, reason=reason)
        had = replica in rec.active
        rec.active.discard(replica)
        if had and not rec.active:
            rec.touch(now)
            rec.fold_attempt(ok=False)
            rec.attempts += 1
            rec.touch(now, "queue")


def on_finish(rid: str, *, replica: str = "local", tokens: int = 0,
              outcome: str = "ok") -> None:
    """The request delivered its last token: close the stage machine,
    fold the winning attempt, and publish the attribution."""
    _finalize(rid, outcome=outcome, ok=True, replica=replica, tokens=tokens)


def on_reject(rid: str, *, reason: str, tokens: int = 0) -> None:
    """Terminal typed rejection (queue_full / deadline / invalid /
    shed): the ledger records it with the same attribution contract —
    a mid-decode deadline's spent work lands in guardrail time."""
    _finalize(rid, outcome=reason, ok=False, tokens=tokens)


def _finalize(rid: str, *, outcome: str, ok: bool,
              replica: Optional[str] = None, tokens: int = 0) -> None:
    global _FINISHED
    if not enabled():
        return
    from .. import observe

    now = time.perf_counter()
    with _LOCK:
        rec = _LIVE.pop(rid, None)
        if rec is None:
            if ok or any(r.rid == rid for r in _RECENT_DONE):
                return  # unknown, or already finalized (racing paths)
            # Rejected at the door (brownout/queue_full before any
            # enqueue bookkeeping): record a zero-duration terminal.
            rec = _Record(rid, now, None, _cfg().ledger_events)
        rec.touch(now)
        rec.fold_attempt(ok=ok)
        rec.attempts += 1
        rec.active.clear()
        rec.outcome = outcome
        rec.e2e_s = max(0.0, now - rec.t0)
        if tokens:
            rec.tokens = max(rec.tokens, tokens)
        rec.add_event(now, "finish" if ok else "reject", outcome=outcome)
        _RECENT_DONE.append(rec)
        _TAIL.append(rec.summary())
        _FINISHED += 1
        summ = rec.summary()
        detail = rec.detail()
    # Emissions outside the ledger lock (tracer/counter locks nest
    # under nothing here).
    if ok:
        for st in STAGES:
            observe.histogram(f"tdx.serve.stage_{st}_s").observe(
                summ[f"{st}_s"])
        observe.histogram("tdx.serve.request_e2e_s").observe(summ["e2e_s"])
    tr = observe.tracer()
    tr.instant("serve.request", category="serve", args=detail)
    if rec.flow is not None:
        tr.flow_finish(rec.flow, name="tdx.serve.request")


# -- queries ----------------------------------------------------------------


def flow_id(rid: str) -> Optional[int]:
    """The request's flow id (its cross-replica/pid join key), or None
    when the ledger never saw it."""
    with _LOCK:
        rec = _get(rid)
        if rec is not None:
            return rec.flow
        for done in reversed(_RECENT_DONE):
            if done.rid == rid:
                return done.flow
    return None


def summary(rid: str) -> Optional[Dict[str, Any]]:
    """The request's current attribution summary (live or recent)."""
    with _LOCK:
        rec = _get(rid)
        if rec is None:
            for done in reversed(_RECENT_DONE):
                if done.rid == rid:
                    rec = done
                    break
        return None if rec is None else rec.detail()


def requests_report(limit: int = 32) -> Dict[str, Any]:
    """The ``/requests`` document: live requests (summaries) plus the
    most recent finished requests with full timelines."""
    with _LOCK:
        live = [r.summary() for r in list(_LIVE.values())[-limit:]]
        recent = [r.detail() for r in list(_RECENT_DONE)[-limit:]]
        return {
            "live": live,
            "recent": recent,
            "finished": _FINISHED,
            "records_dropped": _RECORDS_DROPPED,
        }


def _pctl(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolated percentile over a sorted list."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = (len(sorted_vals) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


def tail_report() -> Dict[str, Any]:
    """The ``/tail`` document: end-to-end percentiles, per-stage
    percentiles and mean shares, and the p99 blame breakdown (mean
    stage share among the slowest ~5% of the window) — "which stage
    eats the tail", answerable at a glance."""
    with _LOCK:
        window = [s for s in _TAIL if s.get("e2e_s") is not None]
        finished = _FINISHED
        outcomes: Dict[str, int] = {}
        for s in _TAIL:
            o = s.get("outcome") or "?"
            outcomes[o] = outcomes.get(o, 0) + 1
    done = [s for s in window if s["outcome"] == "ok"]
    out: Dict[str, Any] = {
        "finished": finished,
        "window": len(window),
        "completed": len(done),
        "outcomes": outcomes,
        "hedged": sum(1 for s in window if s.get("hedged")),
        "retried": sum(1 for s in window if s.get("attempts", 1) > 1),
    }
    if not done:
        return out
    e2e = sorted(s["e2e_s"] for s in done)
    out["e2e_s"] = {f"p{int(q * 100)}": round(_pctl(e2e, q), 6)
                    for q in (0.5, 0.95, 0.99)}
    stages: Dict[str, Any] = {}
    for st in STAGES:
        vals = sorted(s[f"{st}_s"] for s in done)
        share = [s[f"{st}_s"] / s["e2e_s"] for s in done if s["e2e_s"] > 0]
        stages[st] = {
            "p50": round(_pctl(vals, 0.5), 6),
            "p99": round(_pctl(vals, 0.99), 6),
            "mean_share": round(sum(share) / len(share), 4) if share else 0.0,
        }
    out["stages"] = stages
    # p99 blame: among the slowest ~5% (at least one request), the mean
    # fraction of end-to-end each stage consumed.
    k = max(1, len(done) // 20)
    slow = sorted(done, key=lambda s: s["e2e_s"])[-k:]
    blame = {}
    for st in STAGES:
        shares = [s[f"{st}_s"] / s["e2e_s"] for s in slow if s["e2e_s"] > 0]
        blame[st] = round(sum(shares) / len(shares), 4) if shares else 0.0
    out["p99_blame"] = blame
    out["p99_sample"] = k
    # Per-weight-version split (a fleet's rollover): old against new.
    by_ver: Dict[str, List[float]] = {}
    for s in done:
        if s.get("version") is not None:
            by_ver.setdefault(s["version"], []).append(s["e2e_s"])
    if by_ver:
        out["by_version"] = {
            v: {"completed": len(vals),
                "p50": round(_pctl(sorted(vals), 0.5), 6),
                "p95": round(_pctl(sorted(vals), 0.95), 6)}
            for v, vals in by_ver.items()}
    return out


# -- occupancy time-series --------------------------------------------------

def occupancy_sample(*, replica: str = "local", decode_busy: int = 0,
                     decode_lanes: int = 0, kv_pages_free: int = 0,
                     kv_pages_shared: int = 0, prefix_hit_rate: float = 0.0,
                     queue_depth: int = 0) -> None:
    """One engine-tick occupancy sample: ring-buffered here (for
    ``/tail`` and flight dumps) and mirrored as gauges — which makes
    them Chrome counter tracks and ``/metrics`` lines for free."""
    if not enabled():
        return
    from .. import observe

    with _LOCK:
        _OCC.append({
            "t": round(time.time(), 3), "replica": replica,
            "busy": decode_busy, "lanes": decode_lanes,
            "free": kv_pages_free, "shared": kv_pages_shared,
            "hit_rate": round(prefix_hit_rate, 4), "depth": queue_depth,
        })
    lanes = max(1, decode_lanes)
    observe.gauge("tdx.serve.decode_occupancy").set(
        round(decode_busy / lanes, 4))


def occupancy_report(limit: int = 256) -> Dict[str, Any]:
    with _LOCK:
        samples = list(_OCC)[-limit:]
    return {"samples": samples, "count": len(samples)}


# -- export / lifecycle -----------------------------------------------------


def flight_snapshot() -> Dict[str, Any]:
    """What a flight-recorder dump carries: the tail report, the most
    recent occupancy samples, and the live in-flight summaries — the
    post-mortem view of "who was where when it died"."""
    with _LOCK:
        live = [r.summary() for r in list(_LIVE.values())[-32:]]
        occ = list(_OCC)[-64:]
    return {"tail": tail_report(), "live": live, "occupancy": occ}


def reset() -> None:
    """Drop all ledger state (tests / ``observe.reset``)."""
    global _FINISHED, _RECORDS_DROPPED
    with _LOCK:
        _LIVE.clear()
        _RECENT_DONE.clear()
        _TAIL.clear()
        _OCC.clear()
        _FINISHED = 0
        _RECORDS_DROPPED = 0
