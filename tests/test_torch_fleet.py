"""The fleet's pure policies against the JAX package's classes: the same
operation sequence goes into the JAX object and the port's, and both
must reach the same observable state.

Covered: ``GuardrailConfig``'s validation, ``CircuitBreaker``'s sliding
window, ``QuarantineEntry``'s backoff, ``Brownout``'s hysteresis,
``should_hedge``; ``AdmissionQueue``'s bound, deadlines, requeue lane
and shedding (and its requeue order under concurrent pushes and
expiries); ``least_outstanding`` and ``prefix_affinity``;
``Autoscaler``'s hysteresis, cooldown and backfill below the floor; the
``fleet`` chaos site's executor (a replica-thread ``preempt``, a
cancellable hang, ``corrupt`` with no target).  The cases are those of
``tests/test_guardrails.py`` and ``tests/test_fleet.py`` that pass here,
driven through both implementations.
"""

import threading
import time

import pytest

from torchdistx_tpu import chaos as jax_chaos
from torchdistx_tpu import serve as jax_serve
from torchdistx_tpu.serve import router as jax_router
from torchdistx_tpu_torch import chaos
from torchdistx_tpu_torch import serve
from torchdistx_tpu_torch.serve import router

# (kwargs) cases for GuardrailConfig: the valid ones and every refusal.
GC_CASES = [
    {}, dict(breaker_window_s=0.0), dict(breaker_trip_faults=0),
    dict(quarantine_s=0.0), dict(quarantine_s=5.0, quarantine_max_s=1.0),
    dict(hedge_wait_frac=-0.1), dict(brownout_enter_consecutive=0),
    dict(brownout_exit_consecutive=0), dict(backoff_cap_s=0.0),
    dict(backoff_cap_s=5.0, quarantine_max_s=60.0),
]


def _both(name):
    return getattr(jax_serve, name), getattr(serve, name)


def _build(cls, kw):
    try:
        return cls(**kw), None
    except ValueError as e:
        return None, str(e)


@pytest.mark.parametrize("kw", GC_CASES, ids=[str(k) for k in GC_CASES])
def test_guardrail_config_validation_matches_jax(kw):
    (jax_obj, jax_err), (obj, err) = (_build(c, kw)
                                      for c in _both("GuardrailConfig"))
    assert err == jax_err
    if obj is not None:
        assert vars(obj) == vars(jax_obj)


def test_circuit_breaker_window_matches_jax():
    """Observations in and out of the window, out of order in time."""
    ops = [("record", 0.0, "flap"), ("record", 1.0, "flap"),
           ("tripped", 2.0), ("record", 2.0, "slow"), ("tripped", 2.0),
           ("count", 11.5), ("tripped", 11.5), ("record", 12.0, "hang"),
           ("record", 12.5, "flap"), ("tripped", 12.5), ("count", 30.0)]
    out = []
    for gc_cls, cb_cls in zip(_both("GuardrailConfig"),
                              _both("CircuitBreaker")):
        b = cb_cls(gc_cls(breaker_trip_faults=3, breaker_window_s=10.0))
        out.append([getattr(b, op)(*args) for op, *args in ops])
    assert out[0] == out[1]
    assert out[1][2:7] == [False, None, True, 1, False]


@pytest.mark.parametrize("caps", [dict(quarantine_s=2.0, quarantine_max_s=6.0),
                                  dict(quarantine_s=2.0, quarantine_max_s=60.0,
                                       backoff_cap_s=5.0)])
def test_quarantine_backoff_matches_jax(caps):
    states = []
    for gc_cls, q_cls in zip(_both("GuardrailConfig"),
                             _both("QuarantineEntry")):
        gc = gc_cls(**caps)
        q = q_cls(origin_idx=2, until=2.0, backoff_s=2.0, probe_idx=5)
        seen = []
        for now in (10.0, 20.0, 30.0, 40.0):
            q.fail_probe(now, gc)
            seen.append((q.backoff_s, q.until, q.probe_idx))
        states.append(seen)
    assert states[0] == states[1]


def test_brownout_hysteresis_matches_jax():
    obs = [dict(queued=9, serving=2), dict(queued=0, serving=2),
           dict(queued=9, serving=2), dict(queued=9, serving=2),
           dict(queued=0, serving=2), dict(queued=0, serving=2),
           dict(queued=100, serving=0), dict(queued=0, serving=1,
                                             ttft_p95=0.9),
           dict(queued=0, serving=1, ttft_p95=0.9),
           dict(queued=0, serving=1, ttft_p95=0.1)]
    runs = []
    for gc_cls, bo_cls in zip(_both("GuardrailConfig"), _both("Brownout")):
        bo = bo_cls(gc_cls(brownout_queue_per_replica=4.0,
                           brownout_ttft_p95_s=0.5,
                           brownout_enter_consecutive=2,
                           brownout_exit_consecutive=2))
        runs.append([(bo.observe(**o), bo.active) for o in obs])
    assert runs[0] == runs[1]
    assert [a for a, _ in runs[1]][:6] == [False, False, False, True, True,
                                           False]


def test_should_hedge_matches_jax():
    cases = [(0.6, 1.0, {}), (0.4, 1.0, {}), (99.0, None, {}),
             (1.5, None, dict(hedge_wait_s=1.0)),
             (0.5, None, dict(hedge_wait_s=1.0)),
             (99.0, 0.1, dict(hedging=False)),
             (0.3, 1.0, dict(hedge_wait_frac=0.25))]
    got = [[fn(w, d, gc_cls(**kw)) for w, d, kw in cases]
           for fn, gc_cls in zip(_both("should_hedge"),
                                 _both("GuardrailConfig"))]
    assert got[0] == got[1] == [True, False, False, True, False, False, True]


def _queue_trace(mod, req_cls):
    """One operation sequence on an ``AdmissionQueue``: the bound, the
    requeue lane, deadlines, shedding, drain; every observable result."""
    R = lambda rid, prio=1: req_cls(rid, [1], max_new_tokens=1,  # noqa: E731
                                    priority=prio)
    out = []
    q = mod.AdmissionQueue(max_depth=3)
    q.push(R("a"), now=0.0)
    q.push(R("lo1", 0), now=0.0, deadline_s=5.0)
    q.push(R("b"), now=1.0, deadline_s=0.5)
    try:
        q.push(R("c"), now=1.0)
    except mod.FleetRejected as e:
        out.append(("rejected", e.rejection.rid, e.rejection.reason,
                    e.rejection.detail, str(e)))
    q.requeue(R("dead"))
    q.requeue(R("rq-lo", 0))
    out.append(("depth", q.depth(), len(q)))
    out.append(("pop", q.pop(now=1.2).req.rid))
    out.append(("expire", [(r.rid, r.reason) for r in q.expire(now=2.0)]))
    out.append(("shed", [(r.rid, r.reason, r.detail)
                         for r in q.shed_low_priority(1)]))
    out.append(("pop", q.pop(now=2.0).req.rid, q.pop(now=2.0).req.rid))
    q.push(R("late"), now=0.0, deadline_s=0.001)
    out.append(("pop_expired", q.pop(now=1.0)))
    q.push(R("x"), now=5.0)
    out.append(("drain", [e.req.rid for e in q.drain()], q.depth()))
    try:
        mod.AdmissionQueue(max_depth=0)
    except ValueError as e:
        out.append(("bad_depth", str(e)))
    return out


def test_admission_queue_matches_jax():
    want = _queue_trace(jax_router, jax_serve.Request)
    got = _queue_trace(router, serve.Request)
    assert got == want
    assert router.REJECT_REASONS == jax_router.REJECT_REASONS
    assert ("pop", "dead") in got and ("pop_expired", None) in got


def test_requeue_order_under_concurrent_push_and_expire():
    """Requeues from many threads keep their per-thread order and are
    exempt from the bound and the deadline, while regular pushes
    overflow and expire around them."""
    q = router.AdmissionQueue(max_depth=4)
    n_requeuers, per = 4, 50
    errors, expired = [], []
    stop = threading.Event()

    def requeuer(t):
        for i in range(per):
            q.requeue(serve.Request(f"rq-{t}-{i}", [1], max_new_tokens=1))

    def pusher(t):
        for i in range(per):
            try:
                q.push(serve.Request(f"push-{t}-{i}", [1], max_new_tokens=1),
                       deadline_s=0.0005)
            except router.FleetRejected as e:
                if e.rejection.reason != "queue_full":
                    errors.append(e)

    def expirer():
        while not stop.is_set():
            expired.extend(q.expire())

    workers = [threading.Thread(target=requeuer, args=(t,))
               for t in range(n_requeuers)]
    workers += [threading.Thread(target=pusher, args=(t,)) for t in range(2)]
    exp_t = threading.Thread(target=expirer)
    exp_t.start()
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    stop.set()
    exp_t.join()
    assert not errors, errors
    future = time.monotonic() + 1.0
    expired.extend(q.expire(now=future))
    popped = []
    while (entry := q.pop(now=future)) is not None:
        popped.append(entry.req.rid)
    assert len(popped) == n_requeuers * per
    assert all(rid.startswith("rq-") for rid in popped)
    assert not any(r.rid.startswith("rq-") for r in expired)
    for t in range(n_requeuers):
        mine = [int(rid.split("-")[2]) for rid in popped
                if rid.startswith(f"rq-{t}-")]
        assert mine == list(range(per))


def test_dispatch_policies_match_jax():
    loads = {"a": 64, "b": 4, "c": 9, "d": 4}
    match = {"a": 8, "b": 0, "c": 8, "d": 0}
    cases = [["a", "b", "c"], ["a", "b"], [], ["c", "a"], ["b", "d"],
             ["a", "c", "d"]]
    for jax_fn, fn in ((jax_router.least_outstanding,
                        router.least_outstanding),):
        for cand in cases:
            assert fn(cand, loads.get) == jax_fn(cand, loads.get)
        assert fn(["a", "b"], lambda h: 7) == "a"
    for cand in cases + [["b", "d"]]:
        for m in (match.get, lambda h: 0):
            assert router.prefix_affinity(cand, loads.get, m) == \
                jax_router.prefix_affinity(cand, loads.get, m)
    assert router.prefix_affinity(["a", "c", "d"], loads.get,
                                  match.get) == ("c", True)


AUTOSCALE_TRACES = {
    # A step load change: one scale-up (streak + cooldown), sustained
    # pressure past the cooldown may fire again.
    "step_load": (dict(min_replicas=1, max_replicas=4,
                       up_queue_per_replica=2.0, up_consecutive=3,
                       down_consecutive=4, cooldown_s=10.0),
                  [(t, 10, 30, s, s) for t, s in
                   ((1.0, 1), (2.0, 1), (3.0, 1), (4.0, 2), (5.0, 2),
                    (6.0, 2), (14.0, 2), (15.0, 4), (30.0, 4))]),
    # Idle dips: a busy tick resets the streak; never below the floor.
    "idle": (dict(min_replicas=1, down_consecutive=4, cooldown_s=0.0),
             [(float(t), q, q * 5, 2, 2) for t, q in
              enumerate((0, 0, 0, 1, 0, 0, 0, 0, 0), 1)]
             + [(20.0, 0, 0, 1, 1)]),
    # The latency signal, and backfill below the floor with autoscale
    # off (the floor is availability, not load policy).
    "ttft": (dict(min_replicas=1, up_ttft_p95_s=0.5, up_consecutive=2,
                  cooldown_s=0.0),
             [(1.0, 0, 0, 1, 1, 0.9), (2.0, 0, 0, 1, 1, 0.9),
              (3.0, 0, 0, 2, 2, 0.1)]),
    "floor": (dict(min_replicas=2, autoscale=False),
              [(0.0, 0, 0, 1, 1), (0.0, 99, 99, 2, 2), (1.0, 0, 0, 0, 0)]),
}


@pytest.mark.parametrize("name", list(AUTOSCALE_TRACES))
def test_autoscaler_matches_jax(name):
    fc_kw, trace = AUTOSCALE_TRACES[name]
    runs = []
    for fc_cls, a_cls in zip(_both("FleetConfig"), _both("Autoscaler")):
        a = a_cls(fc_cls(**fc_kw))
        runs.append([a.decide(now=t, queued=q, outstanding=o, serving=s,
                              total=n, ttft_p95=(p[0] if p else None))
                     for t, q, o, s, n, *p in trace])
    assert runs[0] == runs[1]
    assert any(runs[1]), runs[1]


def test_fleet_site_executor():
    """``preempt`` at the ``fleet`` site ends only the calling thread
    (:class:`ReplicaPreempted`, an injected runtime error), ``raise``
    is the injected device failure, a hang stays cancellable, and
    ``corrupt`` there has no target (as in the JAX executor)."""
    fault = lambda spec: chaos.parse_plan(spec).faults[0]  # noqa: E731
    with pytest.raises(chaos.ReplicaPreempted):
        chaos.execute_replica_fault(fault("fleet@1=preempt"))
    assert issubclass(chaos.ReplicaPreempted, chaos.InjectedRuntimeError)
    with pytest.raises(chaos.InjectedRuntimeError):
        chaos.execute_replica_fault(fault("fleet@1=raise"))
    for mod in (chaos, jax_chaos):
        with pytest.raises(ValueError, match="target path"):
            mod.execute_replica_fault(mod.parse_plan(
                "fleet@2=corrupt:flip").faults[0])
    ev, took = threading.Event(), []

    def hung():
        chaos.set_cancel_event(ev)
        t0 = time.perf_counter()
        chaos.execute_replica_fault(fault("fleet@1=hang:30"))
        took.append(time.perf_counter() - t0)

    th = threading.Thread(target=hung)
    th.start()
    time.sleep(0.05)
    ev.set()
    th.join(timeout=5)
    assert not th.is_alive() and took and took[0] < 5
