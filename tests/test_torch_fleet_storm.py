"""The port's serve fleet on tiny float32 replicas (``tests/test_fleet.py``'s
LLAMA and SCFG, on the CPU): the fleet keeps the single-engine oracle
contract through storms, replica kills, hangs, drains and scale
transitions.

Held: every request either completes with tokens equal to the
unbatched ``oracle_generate`` under the fleet's weights (final logits
within 1e-4) or gets exactly one typed rejection; no KV page leaks (a
live replica's pages in use are its prefix cache's); ``fleet@2=raise``
and ``fleet@2=preempt`` requeue onto a survivor; a hang past
``stall_s`` declares the replica dead; a drain completes its in-flight
lanes; each rejection path (``invalid``, ``queue_full``, ``deadline``,
``shed``) is typed and counted; two replicas spun up at once on two
threads hold bitwise-equal parameters; and, anchored to the JAX package,
a fleet serving flax weights (``from_flax_params``) gives the JAX
``oracle_generate``'s tokens.
"""

import threading
import time

import numpy as np
import pytest
import torch

from torchdistx_tpu_torch import chaos, observe
from torchdistx_tpu_torch.models import TransformerConfig, from_flax_params
from torchdistx_tpu_torch.parallel.mesh import VirtualMesh
from torchdistx_tpu_torch.serve import (
    FleetConfig,
    FleetRejected,
    GuardrailConfig,
    Request,
    ServeConfig,
    ServeFleet,
    spin_up_replica,
)
from torchdistx_tpu_torch.serve.router import REJECT_REASONS

torch.set_num_threads(2)

LLAMA = TransformerConfig(
    vocab_size=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=64, max_seq_len=64, dtype=torch.float32,
)
SCFG = ServeConfig(max_batch=2, page_size=8, n_pages=16,
                   max_pages_per_seq=3, prefill_buckets=(8, 16))
TIMEOUT = 120.0


def _fleet(**fc_kw):
    fc_kw.setdefault("stall_s", 60.0)
    return ServeFleet(LLAMA, family="llama", serve_cfg=SCFG,
                      fleet_cfg=FleetConfig(**fc_kw), device="cpu")


def _check_oracle(fl, reqs, out=None):
    """Each request: completed oracle-exact, or exactly one typed
    rejection whose delivered tokens are an oracle prefix."""
    out = fl.results if out is None else out
    for r in reqs:
        want, want_logits = fl.oracle_generate(fl.params, r.tokens,
                                               r.max_new_tokens, r.eos_id)
        if r.rid in out:
            assert r.rid not in fl.rejected, r.rid
            assert out[r.rid] == want, (r.rid, out[r.rid], want)
            np.testing.assert_allclose(fl.final_logits[r.rid], want_logits,
                                       atol=1e-4, err_msg=r.rid)
        else:
            rej = fl.rejected[r.rid]
            assert rej.reason in REJECT_REASONS, rej
            assert list(rej.tokens) == want[:len(rej.tokens)], rej


def _check_kv_clean(fl):
    for h in fl.handles:
        eng = h.engine
        if eng is not None and eng.k_pages is not None:
            assert eng.kv.pages_in_use == eng.prefix.page_count(), h.idx


def _counters():
    out = {}
    for r in observe.counters().snapshot():
        if r["type"] == "counter":
            out[r["name"]] = out.get(r["name"], 0.0) + r["value"]
    return out


@pytest.fixture
def telemetry():
    observe.enable(True)
    base = _counters()
    yield lambda name: _counters().get(name, 0.0) - base.get(name, 0.0)
    chaos.clear()
    observe.enable(None)
    observe.health.reset()


def test_storm_across_scale_transitions(telemetry):
    """A staggered storm over 2 replicas with a chaos kill, a scale-up and
    a drain during the run, an invalid request and one whose deadline
    cannot be met: every request completes oracle-exact or carries one
    typed rejection; no page leaks."""
    with _fleet(min_replicas=1, max_replicas=4, autoscale=False) as fl:
        fl.start(2, timeout=TIMEOUT)
        chaos.install("fleet@2=raise")
        reqs = [Request(f"s{i}", [(5 * i + j) % 128 for j in range(2 + i % 6)],
                        max_new_tokens=4 + (i % 5), arrival_step=i)
                for i in range(12)]
        reqs.append(Request("late", [1, 2, 3], max_new_tokens=8,
                            deadline_s=1e-4, arrival_step=3))
        bad = Request("bad", [], max_new_tokens=4)
        with pytest.raises(FleetRejected):
            fl.submit(bad)
        did_up = did_down = False
        i, deadline = 0, time.monotonic() + TIMEOUT
        while i < len(reqs) or fl._pending:
            while i < len(reqs) and reqs[i].arrival_step <= fl._tick_no:
                fl.submit(reqs[i])
                i += 1
            fl.tick()
            serving = sum(1 for h in fl.handles if h.state == "serving")
            if not did_up and i >= 6:
                fl.scale_up()
                did_up = True
            if did_up and not did_down and serving > 1 and i >= 10:
                did_down = fl.scale_down() is not None
            assert time.monotonic() < deadline, fl._pending
            time.sleep(0.001)
        assert did_up and did_down
        done = set(fl.results) | set(fl.rejected)
        assert done == {r.rid for r in reqs} | {"bad"}
        assert not set(fl.results) & set(fl.rejected)
        assert fl.rejected["bad"].reason == "invalid"
        assert fl.rejected["late"].reason == "deadline"
        _check_oracle(fl, reqs)
        _check_kv_clean(fl)
        assert telemetry("tdx.fleet.requeued_requests") >= 1
        assert telemetry("tdx.fleet.scale_ups") >= 3
        assert telemetry("tdx.fleet.scale_downs") >= 1
        assert telemetry("tdx.fleet.rejected_requests") == 2


@pytest.mark.parametrize("kind", ["raise", "preempt"])
def test_chaos_kill_requeues_onto_survivor(telemetry, kind):
    with _fleet(min_replicas=1, max_replicas=2, autoscale=False) as fl:
        fl.start(2, timeout=TIMEOUT)
        chaos.install(f"fleet@2={kind}")
        reqs = [Request(f"k{i}", [3 + i, 7, (11 * i) % 128],
                        max_new_tokens=5, arrival_step=i) for i in range(8)]
        out = fl.run(reqs, max_seconds=TIMEOUT)
        chaos.clear()
        assert set(out) == {r.rid for r in reqs} and not fl.rejected
        _check_oracle(fl, reqs, out)
        assert all(h.idx != 2 for h in fl.handles)
        assert telemetry("tdx.fleet.requeued_requests") >= 1
        assert telemetry("tdx.chaos.injected") == 1


def test_hang_past_stall_declares_replica_dead(telemetry):
    """``fleet@1=hang``: r1 stops beating; past ``stall_s`` the controller
    requeues its work onto the floor's backfill."""
    with _fleet(min_replicas=1, max_replicas=2, autoscale=False,
                stall_s=0.5) as fl:
        fl.start(1, timeout=TIMEOUT)
        hung = fl.handles[0]
        chaos.install("fleet@1=hang:3600")
        reqs = [Request(f"h{i}", [2 + i, 4, 6], max_new_tokens=4)
                for i in range(3)]
        out = fl.run(reqs, max_seconds=TIMEOUT)
        chaos.clear()
        assert set(out) == {r.rid for r in reqs}
        _check_oracle(fl, reqs, out)
        assert all(h.idx != 1 for h in fl.handles)
    hung.thread.join(timeout=10.0)  # the stop event cut its hang
    assert not hung.thread.is_alive()


def test_drain_completes_inflight_bitwise():
    with _fleet(min_replicas=1, max_replicas=2, autoscale=False) as fl:
        fl.start(2, timeout=TIMEOUT)
        reqs = [Request(f"d{i}", [9 + i, 2, 5], max_new_tokens=12)
                for i in range(4)]
        for r in reqs:
            fl.submit(r)
        deadline = time.monotonic() + TIMEOUT
        while not any(h.engine is not None and h.engine.active
                      for h in fl.handles):
            fl.tick()
            assert time.monotonic() < deadline
            time.sleep(0.001)
        h = fl.scale_down()
        inflight = {ln.req.rid for ln in list(h.engine.active.values())}
        out = fl.run(max_seconds=TIMEOUT)
        assert set(out) == {r.rid for r in reqs}
        _check_oracle(fl, reqs, out)
        while any(x is h for x in fl.handles):
            fl.tick()
            assert time.monotonic() < deadline, h.state
            time.sleep(0.001)
        assert h.state == "drained" and inflight <= set(out)
        assert h.engine.k_pages is None and h.engine.kv.pages_in_use == 0


def test_rejection_paths_typed_and_counted(telemetry):
    """``invalid`` at the door (an empty prompt; a budget past
    max_context), ``queue_full`` at the bound, ``deadline`` in the
    queue, ``shed`` under brownout: each raised typed, recorded once and
    counted."""
    fl = ServeFleet(LLAMA, family="llama", serve_cfg=SCFG, device="cpu",
                    fleet_cfg=FleetConfig(min_replicas=0, max_queue=2,
                                          autoscale=False,
                                          guardrails=GuardrailConfig()))
    reasons = []
    for req, kw in ((Request("bad", [], max_new_tokens=4), {}),
                    (Request("huge", [1] * 23, max_new_tokens=2), {}),
                    (Request("q1", [1, 2], max_new_tokens=2), {}),
                    (Request("q2", [1, 2], max_new_tokens=2), {}),
                    (Request("q3", [1, 2], max_new_tokens=2), {})):
        try:
            fl.submit(req, **kw)
        except FleetRejected as e:
            reasons.append((e.rejection.rid, e.rejection.reason))
    assert reasons == [("bad", "invalid"), ("huge", "invalid"),
                       ("q3", "queue_full")]
    assert "max_context" in fl.rejected["huge"].detail
    fl.queue.drain()
    fl._pending.clear()
    fl.submit(Request("late", [1, 2], max_new_tokens=2), deadline_s=0.001)
    time.sleep(0.02)
    fl.tick()
    fl.brownout.active = True
    with pytest.raises(FleetRejected) as ei:
        fl.submit(Request("low", [1, 2], max_new_tokens=2, priority=0))
    assert ei.value.rejection.reason == "shed"
    got = {rid: r.reason for rid, r in fl.rejected.items()}
    assert got == {"bad": "invalid", "huge": "invalid", "q3": "queue_full",
                   "late": "deadline", "low": "shed"}
    assert telemetry("tdx.fleet.rejected_requests") == 5
    assert telemetry("tdx.fleet.shed_requests") == 1


def test_concurrent_spin_ups_hold_equal_parameters():
    """Two replicas of one seed spun up at once on two threads: their
    parameters are bitwise equal (the keyed materializer's values are a
    function of the seed and the recording alone)."""
    engines, errors = [None, None], []

    def up(i):
        try:
            engines[i] = spin_up_replica(LLAMA, family="llama",
                                         serve_cfg=SCFG, seed=3,
                                         device="cpu",
                                         health_component=f"t/{i}")
        except BaseException as e:  # noqa: BLE001 — reraised below
            errors.append(e)

    threads = [threading.Thread(target=up, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    a, b = (e.model.state_dict() for e in engines)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    observe.health.reset()


def test_mesh_is_a6_6():
    """A fleet takes a mesh this process holds alone (A6.6); over a mesh
    of several processes it raises, naming what is left (A6.7)."""
    with pytest.raises(NotImplementedError, match="A6.7"):
        ServeFleet(LLAMA, family="llama", serve_cfg=SCFG,
                   mesh=VirtualMesh({"tp": 2}, {"tp": 0}), device="cpu")


def test_fleet_serves_jax_oracle_tokens():
    """The JAX anchor: a fleet whose replicas serve the flax weights
    (carried across by ``from_flax_params``) gives the JAX package's
    ``oracle_generate`` tokens and final logits within 1e-4."""
    from test_torch_serve import Pair

    pair = Pair("llama")
    sd = from_flax_params("llama", LLAMA, pair.params)
    with _fleet(min_replicas=1, max_replicas=2, autoscale=False) as fl:
        for _ in range(2):
            fl.scale_up(params=sd, wait=True, timeout=TIMEOUT)
        reqs = [Request(f"j{i}", [5 + i, 9, 2, (7 * i) % 128][:2 + i % 3],
                        max_new_tokens=6, arrival_step=i) for i in range(4)]
        out = fl.run(reqs, max_seconds=TIMEOUT)
    for r in reqs:
        want, want_logits = pair.oracle(r.tokens, r.max_new_tokens)
        assert out[r.rid] == want, r.rid
        np.testing.assert_allclose(fl.final_logits[r.rid], want_logits,
                                   atol=1e-4)
