"""The port's serving engine under injected faults, held against the JAX
engine on the same requests, the same fault plan and identical float32
weights (``from_flax_params``).

Two runs per package, each from a fresh plan:

* ``compile``: ``compile@1=raise`` on engines with no program built yet,
  so the fault fires at the first lazy build, inside the first prefill;
* ``serve``: four requests on a two-lane replica with the prefix cache,
  chunked prefill (chunks of 6) and speculation on, under
  ``serve@2=raise;serve@4=slow:0.01;serve@7=raise:chunk;
  serve@10=flap:1.0;serve@15=raise:verify`` — a fault on a plain tick,
  a slow tick, a fault deferred to the boundary between two chunks of
  the 20-token prompt, a flapping fault, and one deferred to a verify
  tick (the JAX engine borrows the programs the ``compile`` run built).

Held, run by run: tokens equal each other and the JAX reference (from
``test_torch_jax_oracle.JaxOracle``, which that file holds against
``oracle_generate`` on this file's first request, ``FIRST_REQUEST``);
the ``tdx.serve.preempted_requests`` deltas are equal; each request's ledger timeline (event kinds in order), outcome,
attempts and tokens are equal, and on each side its four stages sum to
its end-to-end latency; the ``ServeSLO`` sample counts are equal; the
flight-dump reasons, in order, are equal and each port bundle passes
both packages' ``validate``; ``pages_in_use`` after ``drain`` is equal;
``on_token`` saw each position once.  Beside them: a ``ValueError``
leaves the JAX engine's ``step`` without a requeue, as
``tests/test_torch_serve_errors.py`` holds the port's to.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_jax_oracle import SHAPES, JaxOracle, flax_params
from torchdistx_tpu import chaos as jax_chaos
from torchdistx_tpu import config as jax_config
from torchdistx_tpu import observe as jax_observe
from torchdistx_tpu.models import TransformerConfig as JaxConfig
from torchdistx_tpu.observe import flightrec as jax_flightrec
from torchdistx_tpu.observe import reqledger as jax_reqledger
from torchdistx_tpu.serve import Request as JaxRequest
from torchdistx_tpu.serve import ServeConfig as JaxServeConfig
from torchdistx_tpu.serve import ServeEngine as JaxServeEngine
from torchdistx_tpu_torch import chaos, config, observe
from torchdistx_tpu_torch.models import TransformerConfig, from_flax_params
from torchdistx_tpu_torch.observe import flightrec, reqledger
from torchdistx_tpu_torch.serve import (
    Request,
    ServeConfig,
    ServeEngine,
    make_model,
)

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

FAMILY = "llama"
SERVE = dict(max_batch=2, page_size=8, n_pages=16, max_pages_per_seq=4,
             prefill_buckets=(8, 16), prefill_chunk=6)
LONG = [(11 * i + 5) % 128 for i in range(20)]
PLANS = {
    "compile": "compile@1=raise",
    "serve": ("serve@2=raise;serve@4=slow:0.01;serve@7=raise:chunk;"
              "serve@10=flap:1.0;serve@15=raise:verify"),
}
RUNS = list(PLANS)
# The first request this file serves (prompt, new tokens).
FIRST_REQUEST = ([8, 6, 4], 3)


def requests(run):
    """(rid, prompt, max_new_tokens, arrival_step) of each run; x2 repeats
    x after it finished, so the drafter proposes x's continuation."""
    if run == "compile":
        return [("pf", *FIRST_REQUEST, 0), ("pg", [1, 2, 3, 4], 2, 0)]
    return [("x", [5, 9, 2], 5, 0), ("y", [9, 8, 7, 6], 4, 0),
            ("l", LONG, 3, 1), ("r", [7] * 6, 8, 1), ("x2", [5, 9, 2], 5, 9)]


def _ledger(mod, rids):
    """Per rid: (event kinds, outcome, attempts, tokens), and the gap
    between its stage sum and its end-to-end latency (raw, unrounded)."""
    records = {r.rid: r for r in mod._RECENT_DONE}
    out, gaps = {}, {}
    for rid in rids:
        rec = records[rid]
        out[rid] = ([e["k"] for e in rec.events], rec.outcome, rec.attempts,
                    rec.tokens)
        gaps[rid] = abs(sum(rec.acc.values()) - rec.e2e_s)
    return out, gaps


def _flight(tmp):
    """(reasons in dump order, parsed bundles)."""
    files = sorted(tmp.glob("flight-*.json"),
                   key=lambda f: int(f.name.split("-")[2]))
    docs = [json.loads(f.read_text()) for f in files]
    return [d["reason"] for d in docs], docs


def _drive(obs, ledger, eng, reqs, plan_text, install, flight_dir, cfg_mod):
    """Run ``reqs`` through ``eng`` under a fresh plan, then drain."""
    streamed = {}
    eng.on_token = lambda rid, tok: streamed.setdefault(rid, []).append(tok)
    obs.reset()
    before = obs.counter("tdx.serve.preempted_requests").value
    plan = install(plan_text)
    try:
        with cfg_mod.override(flight_dir=str(flight_dir)):
            out = eng.run(reqs)
            eng.drain()
    finally:
        install(None)
    rids = [r.rid for r in reqs]
    summary, gaps = _ledger(ledger, rids)
    reasons, docs = _flight(flight_dir)
    return dict(
        out=out, streamed=streamed, fired=list(plan.fired),
        pending=[f.spec() for f in plan.pending()],
        preempted=obs.counter("tdx.serve.preempted_requests").value - before,
        ledger=summary, gaps=gaps, reasons=reasons, docs=docs,
        slo={m: w.total_count for m, w in eng.slo.windows.items()},
        pages=eng.kv.pages_in_use, final_logits=dict(eng.final_logits),
    )


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both engines through both runs; the JAX engine of the ``compile``
    run lends the programs it built to the ``serve`` run's."""
    jcfg = JaxConfig(dtype=jnp.float32, **SHAPES[FAMILY])
    tcfg = TransformerConfig(dtype=torch.float32, **SHAPES[FAMILY])
    params = flax_params(FAMILY, jcfg)
    model = make_model(FAMILY, tcfg, device="cpu")
    model.load_state_dict(from_flax_params(FAMILY, tcfg, params))
    model.eval()
    jparams = jax.tree.map(jnp.asarray, params)
    mp = pytest.MonkeyPatch()
    # Every dump lands: no per-reason time throttle in either package.
    mp.setattr(flightrec, "_MIN_INTERVAL_S", 0.0)
    mp.setattr(jax_flightrec, "_MIN_INTERVAL_S", 0.0)
    observe.enable(True)
    jax_observe.enable(True)
    results = {}
    try:
        programs = {}
        for run in RUNS:
            jeng = JaxServeEngine(FAMILY, jcfg, jparams,
                                  serve_cfg=JaxServeConfig(**SERVE))
            jeng._programs.update(programs)
            jax_reqs = [JaxRequest(rid, list(toks), max_new_tokens=n,
                                   arrival_step=a)
                        for rid, toks, n, a in requests(run)]
            jres = _drive(jax_observe, jax_reqledger, jeng, jax_reqs,
                          PLANS[run], jax_chaos.install,
                          tmp_path_factory.mktemp(f"jax_{run}"), jax_config)
            programs = dict(jeng._programs)
            eng = ServeEngine(FAMILY, tcfg, model,
                              serve_cfg=ServeConfig(**SERVE), device="cpu")
            reqs = [Request(rid, list(toks), max_new_tokens=n, arrival_step=a)
                    for rid, toks, n, a in requests(run)]
            res = _drive(observe, reqledger, eng, reqs, PLANS[run],
                         chaos.install, tmp_path_factory.mktemp(f"port_{run}"),
                         config)
            results[run] = (res, jres, reqs)
    finally:
        observe.enable(None)
        jax_observe.enable(None)
        mp.undo()
    world = dict(programs=programs, jcfg=jcfg, jparams=jparams)
    return JaxOracle(FAMILY, jcfg, params), results, world


@pytest.mark.parametrize("run", RUNS)
def test_tokens_match_and_stream_once(world, run):
    """Tokens equal each other and the JAX reference, final logits within
    1e-4, and ``on_token`` saw each position once on both sides."""
    oracle, results, _ = world
    res, jres, reqs = results[run]
    assert res["out"] == jres["out"]
    for r in reqs:
        want, want_logits = oracle(r.tokens, r.max_new_tokens)
        assert res["out"][r.rid] == want, r.rid
        np.testing.assert_allclose(res["final_logits"][r.rid], want_logits,
                                   atol=1e-4, err_msg=r.rid)
    assert res["streamed"] == res["out"]
    assert jres["streamed"] == jres["out"]


@pytest.mark.parametrize("run", RUNS)
def test_faults_fire_and_requeue_alike_without_leaking_pages(world, run):
    res, jres, _ = world[1][run]
    assert res["fired"] == jres["fired"] == PLANS[run].split(";")
    # The flap entry stays live (never spent); nothing else is pending.
    assert res["pending"] == jres["pending"] == [
        s for s in PLANS[run].split(";") if "flap" in s]
    assert res["preempted"] == jres["preempted"] > 0
    assert res["pages"] == jres["pages"] == 0


@pytest.mark.parametrize("run", RUNS)
def test_ledger_and_slo_counts_match(world, run):
    res, jres, reqs = world[1][run]
    assert res["ledger"] == jres["ledger"]
    for side in (res, jres):
        assert all(g < 1e-9 for g in side["gaps"].values()), side["gaps"]
        assert all(v[1] == "ok" for v in side["ledger"].values())
    if run == "serve":
        # The chunk fault landed between two chunks of the long prompt.
        kinds = res["ledger"]["l"][0]
        i = kinds.index("abort")
        assert kinds[i - 1] == "chunk" and "chunk" in kinds[i + 1:]
        assert res["ledger"]["l"][2] > 1  # attempts
    else:
        assert res["ledger"]["pf"][0][:5] == [
            "enqueue", "dispatch", "admit", "abort", "admit"]
    assert res["slo"] == jres["slo"]
    assert res["slo"]["ttft"] == len(reqs)


@pytest.mark.parametrize("run", RUNS)
def test_flight_dumps_match_and_validate(world, run):
    res, jres, _ = world[1][run]
    assert res["reasons"] == jres["reasons"]
    assert {"chaos_injected", "serve_fault"} <= set(res["reasons"])
    for doc in res["docs"]:
        assert flightrec.validate(doc) == []
        assert jax_flightrec.validate(doc) == []
        assert doc["env"]["torch"] == torch.__version__


def test_jax_engine_lets_a_value_error_through(world):
    """The same contract on the JAX side: only its retryable errors
    requeue."""
    jax_side = world[2]
    jeng = JaxServeEngine(FAMILY, jax_side["jcfg"], jax_side["jparams"],
                          serve_cfg=JaxServeConfig(**SERVE))
    jeng._programs.update(jax_side["programs"])
    jeng.submit(JaxRequest("e", [9, 2], max_new_tokens=4))
    jeng.step()

    def boom():
        raise ValueError("not a device fault")

    jeng._decode_step = boom
    with pytest.raises(ValueError):
        jeng.step()
    assert len(jeng.active) == 1
