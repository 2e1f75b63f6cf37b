"""Blue-green weight rollover on the port's fleet (tiny float32 replicas on
the CPU, ``tests/test_rollover.py``'s LLAMA and SCFG, checkpoints of a
few kB under ``tmp_path``).

Held: a roll completes mid-storm without the serving count dipping
below the floor, and every request is served by exactly one weight
version, oracle-exact under it (or carries one typed rejection whose
tokens are an oracle prefix of its version); only one roll is in
flight; ``rollover@1=corrupt:flip`` (caught by verification),
``rollover@2=preempt`` (GREEN killed) and a canary mismatch each abort
the roll, quarantine the checkpoint and leave BLUE serving unharmed; a
shutdown that races GREEN's bring-up joins every thread and frees every
pool.  The canary's gate keeps the JAX package's bounds: tokens exact,
final logits within 1e-4.
"""

import os
import time

import numpy as np
import pytest
import torch

from torchdistx_tpu_torch import chaos, observe
from torchdistx_tpu_torch.models import TransformerConfig
from torchdistx_tpu_torch.serve import (
    FleetConfig,
    Request,
    RolloverConfig,
    ServeConfig,
    ServeFleet,
)
from torchdistx_tpu_torch.serve import rollover as rollover_mod
from torchdistx_tpu_torch.serve.router import REJECT_REASONS
from torchdistx_tpu_torch.utils.checkpoint import (
    QUARANTINE_SUFFIX,
    checkpoint_version,
    save_checkpoint,
)

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
    fc_kw.setdefault("autoscale", False)
    return ServeFleet(LLAMA, family="llama", serve_cfg=SCFG,
                      fleet_cfg=FleetConfig(**fc_kw), device="cpu")


def _save_next(fl, tmp_path, *, scale=1.05, name="step_2"):
    """A next-step checkpoint: the serving weights scaled, so its oracle
    differs from BLUE's."""
    path = str(tmp_path / name)
    save_checkpoint(path, {k: v * scale for k, v in fl.params.items()})
    return path


def _drive(fl, ctl, reqs, *, floor=None):
    """Submit ``reqs`` and tick until the storm and the roll are done;
    returns the least serving count seen."""
    for r in reqs:
        fl.submit(r)
    deadline = time.monotonic() + TIMEOUT
    least = len(fl.handles)
    while fl._pending or ctl.outcome is None:
        fl.tick()
        n = sum(1 for h in fl.handles if h.state == "serving")
        least = min(least, n)
        if floor is not None:
            assert n >= floor, (n, ctl.stage)
        assert time.monotonic() < deadline, (ctl.stage, len(fl._pending))
        time.sleep(0.001)
    return least


def _roll_to_end(fl, ctl):
    deadline = time.monotonic() + TIMEOUT
    while ctl.outcome is None:
        assert time.monotonic() < deadline, ctl.stage
        fl.tick()
        time.sleep(0.001)


def _check_versioned_oracle(fl, reqs):
    for r in reqs:
        if r.rid in fl.results:
            assert r.rid not in fl.rejected, r.rid
            v = fl.served_version[r.rid]
            want, want_logits = fl.oracle_generate(
                fl.version_params[v], r.tokens, r.max_new_tokens, r.eos_id)
            assert fl.results[r.rid] == want, (r.rid, v)
            np.testing.assert_allclose(fl.final_logits[r.rid], want_logits,
                                       atol=1e-4, err_msg=f"{r.rid} {v}")
        else:
            rej = fl.rejected[r.rid]
            assert rej.reason in REJECT_REASONS, rej
            if rej.tokens:
                v = fl.served_version.get(r.rid)
                want, _ = fl.oracle_generate(fl.version_params[v], r.tokens,
                                             r.max_new_tokens, r.eos_id)
                assert list(rej.tokens) == want[:len(rej.tokens)], rej


def _check_kv_clean(fl):
    for h in fl.handles:
        eng = h.engine
        if eng is not None and eng.k_pages is not None:
            assert eng.kv.pages_in_use == eng.prefix.page_count(), h.idx


def _storm(tag, n=14, new_tokens=6):
    rng = np.random.RandomState(13)
    return [Request(f"{tag}{i}",
                    [int(t) for t in rng.randint(0, 128,
                                                 size=1 + int(rng.randint(8)))],
                    max_new_tokens=2 + int(rng.randint(new_tokens)),
                    arrival_step=i)
            for i in range(n)]


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


def test_rollover_mid_storm_completes(telemetry, tmp_path):
    """Storm traffic arrives before, during and after the shift; the roll
    completes without the serving count dipping below the floor; every
    request is oracle-exact under the ONE version that served it, and
    both versions served some."""
    with _fleet(min_replicas=2, max_replicas=4) as fl:
        fl.start(2, timeout=TIMEOUT)
        ckpt = _save_next(fl, tmp_path)
        ctl = fl.start_rollover(ckpt)
        reqs = _storm("r", n=24)
        for r in reqs:
            r.arrival_step = 0
        first, rest = reqs[:8], reqs[8:]
        for r in first:
            fl.submit(r)
        deadline = time.monotonic() + TIMEOUT
        while ctl.stage in ("fetch", "canary"):
            fl.tick()
            assert time.monotonic() < deadline, ctl.stage
            time.sleep(0.001)
        _drive(fl, ctl, rest, floor=2)
        assert ctl.outcome == "completed", ctl.digest()
        assert ctl.version == checkpoint_version(ckpt)
        assert fl.active_version == ctl.version
        assert all(h.weight_version == ctl.version for h in fl.handles)
        assert set(fl.results) == {r.rid for r in reqs} and not fl.rejected
        _check_versioned_oracle(fl, reqs)
        served = {fl.served_version[r.rid] for r in reqs}
        assert served == {None, ctl.version}, served
        _check_kv_clean(fl)
        digest = ctl.digest()
        assert set(digest["stages_s"]) == {"fetch", "canary", "shift",
                                           "drain"}
        assert telemetry("tdx.fleet.rollover_completed") == 1
        assert telemetry("tdx.fleet.rollover_blue_drains") == 2
        assert not any(r.startswith("~rollover") for r in fl.results)


def test_only_one_rollover_in_flight(tmp_path):
    with _fleet(min_replicas=1, max_replicas=3) as fl:
        fl.start(1, timeout=TIMEOUT)
        ckpt = _save_next(fl, tmp_path)
        ctl = fl.start_rollover(ckpt)
        with pytest.raises(RuntimeError, match="already in flight"):
            fl.start_rollover(ckpt)
        _roll_to_end(fl, ctl)
        assert ctl.outcome == "completed"
        assert fl.rollover is None


def test_fetch_corrupt_chaos_caught_by_verify(telemetry, tmp_path):
    """``rollover@1=corrupt:flip`` bit-flips the incoming checkpoint at
    fetch: verification catches it, the roll aborts, the checkpoint is
    quarantined, no GREEN spawns."""
    with _fleet(min_replicas=1, max_replicas=2) as fl:
        fl.start(1, timeout=TIMEOUT)
        blues = list(fl.handles)
        ckpt = _save_next(fl, tmp_path)
        chaos.install("rollover@1=corrupt:flip")
        ctl = fl.start_rollover(ckpt)
        _roll_to_end(fl, ctl)
        chaos.clear()
        assert (ctl.outcome, ctl.failed_stage) == ("aborted", "fetch")
        assert "verification" in str(ctl.error) and ctl.quarantined
        assert os.path.exists(ckpt + QUARANTINE_SUFFIX)
        assert ctl.green is None and fl.handles == blues
        reqs = _storm("c", n=6)
        fl.run(reqs, max_seconds=TIMEOUT)
        _check_versioned_oracle(fl, reqs)
        assert {fl.served_version[r.rid] for r in reqs} == {None}


def test_green_preempt_aborts_blue_unharmed(telemetry, tmp_path):
    """``rollover@2=preempt`` kills GREEN at the canary stage: the roll
    aborts, the checkpoint is quarantined, BLUE serves the storm on the
    old weights."""
    with _fleet(min_replicas=2, max_replicas=4) as fl:
        fl.start(2, timeout=TIMEOUT)
        blues = list(fl.handles)
        ckpt = _save_next(fl, tmp_path)
        chaos.install("rollover@2=preempt")
        ctl = fl.start_rollover(ckpt)
        reqs = _storm("p", n=10)
        _drive(fl, ctl, reqs, floor=2)
        chaos.clear()
        assert (ctl.outcome, ctl.failed_stage) == ("aborted", "canary")
        assert "GREEN" in str(ctl.error) and ctl.quarantined
        assert ctl.green.state == "preempted"
        assert fl.handles == blues and not fl.rejected
        _check_versioned_oracle(fl, reqs)
        assert {fl.served_version[r.rid] for r in reqs} == {None}
        _check_kv_clean(fl)
        assert telemetry("tdx.fleet.rollover_aborts") == 1


def test_canary_mismatch_aborts_quarantines_blue_unharmed(
        telemetry, tmp_path, monkeypatch):
    """A GREEN that cannot reproduce the new oracle (forced by a poisoned
    oracle) never takes traffic: abort, quarantine, BLUE's stream
    oracle-exact on the old weights, probe bookkeeping scrubbed."""
    real = rollover_mod.oracle_generate

    def poisoned(model, prompt, max_new_tokens, eos_id=None):
        toks, logits = real(model, prompt, max_new_tokens, eos_id)
        return [t + 1 for t in toks], logits

    monkeypatch.setattr(rollover_mod, "oracle_generate", poisoned)
    with _fleet(min_replicas=2, max_replicas=4) as fl:
        fl.start(2, timeout=TIMEOUT)
        blues = list(fl.handles)
        ckpt = _save_next(fl, tmp_path)
        ctl = fl.start_rollover(ckpt)
        reqs = _storm("m", n=10)
        _drive(fl, ctl, reqs)
        assert (ctl.outcome, ctl.failed_stage) == ("aborted", "canary")
        assert "MISMATCH" in str(ctl.error) and ctl.quarantined
        assert os.path.exists(ckpt + QUARANTINE_SUFFIX)
        assert fl.handles == blues and not fl.rejected
        _check_versioned_oracle(fl, reqs)
        _check_kv_clean(fl)
        assert not any(r.startswith("~rollover") for r in
                       list(fl.results) + list(fl._pending)
                       + list(fl.partial) + list(fl._requests))
        assert telemetry("tdx.fleet.rollover_canary_mismatch") == 1


def test_rollover_config_and_version_stamp(tmp_path):
    with pytest.raises(ValueError, match="probe_prompts"):
        RolloverConfig(probe_prompts=())
    with pytest.raises(ValueError, match="probe_new_tokens"):
        RolloverConfig(probe_new_tokens=0)
    assert RolloverConfig().logits_atol == 1e-4
    assert "stale_version" in REJECT_REASONS
    path = str(tmp_path / "step_7")
    save_checkpoint(path, {"w": torch.ones(4, 4)})
    v = checkpoint_version(path)
    assert v.startswith("step_7@") and len(v.split("@")[1]) == 8


def test_shutdown_races_green_bring_up(tmp_path):
    """``shutdown()`` during GREEN's bring-up joins every replica thread
    and leaves no page in use and no pool held."""
    fl = _fleet(min_replicas=1, max_replicas=3)
    try:
        fl.start(1, timeout=TIMEOUT)
        ckpt = _save_next(fl, tmp_path)
        ctl = fl.start_rollover(ckpt)
        deadline = time.monotonic() + TIMEOUT
        while ctl.green is None:
            assert time.monotonic() < deadline, ctl.stage
            fl.tick()
            time.sleep(0.001)
        green, handles = ctl.green, list(fl.handles)
    finally:
        fl.shutdown()
    assert green in handles
    for h in handles:
        h.thread.join(timeout=TIMEOUT)
        assert not h.thread.is_alive(), h.idx
        if h.engine is not None:
            assert h.engine.kv.pages_in_use == 0 and h.engine.k_pages is None
    observe.health.reset()
