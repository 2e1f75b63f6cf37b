"""The port's prefix cache, copy-on-write pages, chunked prefill and
speculative decoding on the CPU, held against the JAX package on
identical float32 weights (carried across by ``from_flax_params``).

* the ``chunk-<bucket>``, ``verify-<k>`` and ``cow`` programs against the
  JAX ``build_chunk_prefill_fn`` / ``build_verify_fn`` / ``build_cow_fn``
  on equal pools, with a shared first page and padded lanes: logits
  within 1e-5, pools within 1e-6;
* one request mix through the engine (a shared-preamble storm, a fully
  cached page-aligned prompt sent twice, a prompt longer than the
  largest bucket at a small ``prefill_chunk`` with a short request
  behind it, repetitive prompts for the drafter): every request's tokens
  equal the JAX ``oracle_generate`` and its final logits agree within
  1e-4; the features really ran (prefix hits, reused tokens, a COW copy,
  chunks interleaved with decode, verify ticks); ``spec_decode=False``
  gives the same tokens; the JAX ``ServeEngine`` on the same requests and
  ``ServeConfig`` takes the same host decisions (tokens, drafted,
  accepted, verify ticks, prefix hits, COW copies);
* speculation through page-exhaustion preemption, and the engine's
  lifecycle: cancel, deadlines, drain, install_params, release_kv.

The configs are those of tests/test_torch_serve.py.
"""

import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torchdistx_tpu import observe as jax_observe
from torchdistx_tpu.models import TransformerConfig as JaxConfig
from torchdistx_tpu.models import make_gpt2, make_llama
from torchdistx_tpu.serve import Request as JaxRequest
from torchdistx_tpu.serve import ServeConfig as JaxServeConfig
from torchdistx_tpu.serve import ServeEngine as JaxServeEngine
from torchdistx_tpu.serve import oracle_generate as jax_oracle_generate
from torchdistx_tpu.serve.programs import build_chunk_prefill_fn as jax_chunk_fn
from torchdistx_tpu.serve.programs import build_cow_fn as jax_cow_fn
from torchdistx_tpu.serve.programs import build_verify_fn as jax_verify_fn
from torchdistx_tpu_torch.models import TransformerConfig, from_flax_params
from torchdistx_tpu_torch.serve import (
    Request,
    ServeConfig,
    ServeEngine,
    make_model,
    oracle_generate,
)
from torchdistx_tpu_torch.serve.programs import (
    build_chunk_prefill_fn,
    build_cow_fn,
    build_verify_fn,
)

SHAPES = {
    "llama": dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_ff=64, max_seq_len=64),
    "gpt2": dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                 max_seq_len=64, use_bias=True, activation="gelu",
                 norm="layernorm", positions="learned", tie_embeddings=True),
}
# Two lanes, pages of 8, a context of 4 pages, prompts chunked by 6.
FEAT = dict(max_batch=2, page_size=8, n_pages=16, max_pages_per_seq=4,
            prefill_buckets=(8, 16), prefill_chunk=6)
# A pool too small for two long generations: forces preemption.
TIGHT = dict(max_batch=2, page_size=4, n_pages=7, max_pages_per_seq=6,
             prefill_buckets=(8,))


class Pair:
    """One family's flax params and the port's model on the same f32
    weights, with the JAX oracle memoized per request."""

    def __init__(self, family):
        self.family = family
        self.jcfg = JaxConfig(dtype=jnp.float32, **SHAPES[family])
        self.tcfg = TransformerConfig(dtype=torch.float32, **SHAPES[family])
        flax_model = (make_llama if family == "llama" else make_gpt2)(self.jcfg)
        params = flax_model.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))
        self.params = jax.tree.map(np.asarray, params)
        self.model = make_model(family, self.tcfg, device="cpu")
        self.model.load_state_dict(
            from_flax_params(family, self.tcfg, self.params))
        self.model.eval()
        self._oracle = {}

    def engine(self, **serve):
        return ServeEngine(self.family, self.tcfg, self.model,
                           serve_cfg=ServeConfig(**serve), device="cpu")

    def oracle(self, r):
        key = (tuple(r.tokens), r.max_new_tokens, r.eos_id)
        if key not in self._oracle:
            self._oracle[key] = jax_oracle_generate(
                self.family, self.jcfg, self.params, r.tokens,
                r.max_new_tokens, r.eos_id)
        return self._oracle[key]

    def check(self, eng, reqs, out):
        for r in reqs:
            want, want_logits = self.oracle(r)
            assert out[r.rid] == want, (r.rid, out[r.rid], want)
            np.testing.assert_allclose(eng.final_logits[r.rid], want_logits,
                                       atol=1e-4, err_msg=r.rid)


@pytest.fixture(scope="module", params=["llama", "gpt2"])
def pair(request):
    return Pair(request.param)


# ---------------------------------------------------------------------------
# the programs against the JAX builders
# ---------------------------------------------------------------------------


def _pools(pair, seed):
    """Random f32 pools standing for written context (incl. a cached
    prefix page), the same on both sides."""
    kv = JaxServeConfig(**FEAT).resolve(pair.jcfg).kv_config(pair.jcfg)
    rng = np.random.RandomState(seed)
    return (rng.standard_normal(kv.pool_shape()).astype(np.float32),
            rng.standard_normal(kv.pool_shape()).astype(np.float32))


def _run_both(pair, jax_fn, port_fn, seed, *operands):
    kp, vp = _pools(pair, seed)
    jparams = jax.tree.map(jnp.asarray, pair.params)
    jout = jax.jit(jax_fn)(jparams, jnp.asarray(kp), jnp.asarray(vp),
                           *map(jnp.asarray, operands))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tout = port_fn(tk, tv, *map(torch.from_numpy, operands))
    return jout, (tout, tk.numpy(), tv.numpy())


def _check_pools(jout, tout):
    # Page 0 is the null page: padded positions write it in any order.
    for j, t in zip(jout[-2:], tout[1:]):
        np.testing.assert_allclose(t[:, 1:], np.asarray(j)[:, 1:], atol=1e-6)


def test_chunk_program_matches_jax(pair):
    """A 5-token chunk at position 8, padded to bucket 8, behind a
    cached first page (page 3) its attention reads through the table."""
    jscfg = JaxServeConfig(**FEAT).resolve(pair.jcfg)
    toks = np.zeros((1, 8), np.int32)
    toks[0, :5] = [11, 3, 90, 4, 27]
    table = np.asarray([[3, 7, 5, 0]], np.int32)
    jout, tout = _run_both(
        pair, jax_chunk_fn(pair.family, pair.jcfg, jscfg, 8),
        build_chunk_prefill_fn(pair.model), 1,
        toks, np.asarray([8], np.int32), np.asarray([13], np.int32), table)
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               atol=1e-5)
    _check_pools(jout, tout)


def test_verify_program_matches_jax(pair):
    """verify-2 over three lanes: a full draft, a one-token row sharing
    the first lane's first page, and an idle lane."""
    jscfg = JaxServeConfig(max_batch=3, **{
        k: v for k, v in FEAT.items() if k != "max_batch"}).resolve(pair.jcfg)
    toks = np.asarray([[5, 17, 2], [40, 0, 0], [0, 0, 0]], np.int32)
    start = np.asarray([10, 9, 0], np.int32)
    end = np.asarray([13, 10, 0], np.int32)
    table = np.asarray([[2, 4, 0, 0], [2, 9, 0, 0], [0, 0, 0, 0]], np.int32)
    jout, tout = _run_both(
        pair, jax_verify_fn(pair.family, pair.jcfg, jscfg, 2),
        build_verify_fn(pair.model), 2, toks, start, end, table)
    got, want = tout[0].numpy(), np.asarray(jout[0])
    assert got.shape == want.shape == (3, 3, pair.tcfg.vocab_size)
    for b in range(3):  # rows past a lane's end are padding
        n = end[b] - start[b]
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-5)
    _check_pools(jout, tout)


def test_cow_program_matches_jax(pair):
    src, dst = np.asarray([3], np.int32), np.asarray([11], np.int32)
    kp, vp = _pools(pair, 3)
    jk, jv = jax.jit(jax_cow_fn())(jnp.asarray(kp), jnp.asarray(vp),
                                   jnp.asarray(src), jnp.asarray(dst))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    assert build_cow_fn()(tk, tv, torch.from_numpy(src),
                          torch.from_numpy(dst)) is None
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk[:, 11].numpy(), kp[:, 3])


# ---------------------------------------------------------------------------
# the engine: one request mix, three engines
# ---------------------------------------------------------------------------

PREAMBLE = [(3 * i + 1) % 128 for i in range(8)]        # one full page
CACHED = [(7 * i + 11) % 128 for i in range(16)]        # two full pages
LONG = [(11 * i + 5) % 128 for i in range(20)]          # > bucket 16


def mix():
    """Arrivals spaced so each follower admits after its leader's
    prefill published the shared pages (a 10-token prompt takes two
    chunks of 6, a 16-token one three)."""
    return [
        Request("s0", PREAMBLE + [1, 2], max_new_tokens=4),
        Request("s1", PREAMBLE + [2, 3], max_new_tokens=4, arrival_step=2),
        Request("s2", PREAMBLE + [3, 4], max_new_tokens=4, arrival_step=4),
        Request("c0", CACHED, max_new_tokens=5, arrival_step=6),
        Request("c1", CACHED, max_new_tokens=5, arrival_step=16),
        Request("l0", LONG, max_new_tokens=3, arrival_step=24),
        Request("sh", [9, 2, 9], max_new_tokens=4, arrival_step=25),
        Request("r0", [7] * 6, max_new_tokens=6, arrival_step=26),
    ]


@pytest.fixture(scope="module")
def served(pair):
    """The mix through the port's engine with speculation on, recording
    the step of each request's first token."""
    eng = pair.engine(**FEAT)
    first = {}
    eng.on_token = lambda rid, tok: first.setdefault(rid, eng._step_no)
    reqs = mix()
    out = eng.run(reqs)
    return eng, reqs, out, first


def test_mix_matches_jax_oracle(pair, served):
    eng, reqs, out, _ = served
    assert eng.scfg.prefix_cache and eng.scfg.spec_decode
    pair.check(eng, reqs, out)


def test_mix_runs_every_feature(served):
    eng, _, _, first = served
    # s1, s2 on the preamble and c1 on the whole cached prompt.
    assert eng.prefix_hits >= 3, eng.prefix_hits
    assert eng.prefix_tokens_reused >= 2 * 8 + 15
    assert eng.cow_copies >= 1  # c1 recomputes its last position
    assert eng.prefill_chunks >= 2 + 4  # s0 (10 at 6) and l0 (20 at 6)
    # The short request behind the long prompt streams first.
    assert first["sh"] < first["l0"], first
    assert eng.spec_verify_ticks >= 1 and eng.spec_drafted >= 1
    assert eng.spec_accepted >= 1  # c1 repeats c0's chain
    eng.drain()
    assert eng.kv.pages_in_use == 0 and not eng.kv._ref


def test_spec_off_gives_identical_tokens(pair, served):
    _, _, out, _ = served
    eng = pair.engine(spec_decode=False, **FEAT)
    assert eng._drafter is None
    assert eng.run(mix()) == out
    assert eng.spec_verify_ticks == 0 and eng.spec_drafted == 0


def test_jax_engine_takes_the_same_decisions(pair, served):
    eng, _, out, _ = served
    jeng = JaxServeEngine(
        pair.family, pair.jcfg, jax.tree.map(jnp.asarray, pair.params),
        serve_cfg=JaxServeConfig(**FEAT))
    names = ("prefix_hits", "prefix_tokens_reused", "cow_copies",
             "prefill_chunks")
    jax_observe.enable(True)
    try:
        before = {n: jax_observe.counter(f"tdx.serve.{n}").value
                  for n in names}
        jout = jeng.run([JaxRequest(r.rid, list(r.tokens),
                                    max_new_tokens=r.max_new_tokens,
                                    arrival_step=r.arrival_step)
                         for r in mix()])
        jcounts = {n: jax_observe.counter(f"tdx.serve.{n}").value - before[n]
                   for n in names}
    finally:
        jax_observe.enable(None)
    assert jout == out
    assert jcounts == {n: getattr(eng, n) for n in names}
    for n in ("spec_drafted", "spec_accepted", "spec_verify_ticks"):
        assert getattr(jeng, n) == getattr(eng, n), n


def test_spec_through_preemption_matches_jax_oracle(pair):
    eng = pair.engine(**TIGHT)
    reqs = [Request("pp0", [7] * 6, max_new_tokens=8),
            Request("pp1", [7, 7, 7, 9, 9, 9], max_new_tokens=8)]
    out = eng.run(reqs)
    assert eng.preemptions > 0 and eng.spec_drafted > 0
    pair.check(eng, reqs, out)
    eng.drain()
    assert eng.kv.pages_in_use == 0


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------


def test_cancel_frees_pages_and_spares_the_survivor(pair):
    eng = pair.engine(**FEAT)
    keep = Request("keep", [5, 9, 2], max_new_tokens=6)
    drop = Request("drop", [17, 3, 3, 8, 1], max_new_tokens=6)
    eng.submit(keep)
    eng.submit(drop)
    eng.step()
    eng.step()
    held = eng.kv.pages_in_use
    toks = eng.cancel("drop")
    assert toks and eng.cancelled["drop"] == toks
    assert eng.kv.pages_in_use < held
    assert eng.cancel("nobody") is None
    out = eng.run()
    assert "drop" not in out
    pair.check(eng, [keep], out)


def test_past_deadline_expires_and_calls_on_cancel(pair):
    told = []
    eng = pair.engine(**FEAT)
    eng.on_cancel = lambda rid, toks, active: told.append((rid, active))
    late = Request("late", [4, 8, 15], max_new_tokens=6, deadline_s=0.0)
    eng.submit(late)
    time.sleep(0.01)
    out = eng.run()
    assert "late" not in out and told == [("late", False)]
    assert eng.kv.pages_in_use == 0


def test_install_params_in_place_and_release_kv(pair):
    eng = pair.engine(**FEAT)
    r = Request("w0", PREAMBLE + [1, 2], max_new_tokens=3)
    eng.submit(r)
    eng.step()
    with pytest.raises(RuntimeError, match="active"):
        eng.install_params(pair.model.state_dict())
    eng.run()
    assert len(eng.prefix) == 1
    ptrs = [p.data_ptr() for p in pair.model.parameters()]
    new = {k: v * 1.5 for k, v in pair.model.state_dict().items()}
    old = {k: v.clone() for k, v in pair.model.state_dict().items()}
    try:
        eng.install_params(new, version="x1.5")
        assert len(eng.prefix) == 0 and eng.weight_version == "x1.5"
        assert [p.data_ptr() for p in pair.model.parameters()] == ptrs
        r2 = Request("w1", PREAMBLE + [1, 2], max_new_tokens=3)
        out = eng.run([r2])
        want, _ = oracle_generate(pair.model, r2.tokens, 3)
        assert out["w1"] == want
    finally:
        pair.model.load_state_dict(old)
    eng.drain()
    eng.release_kv()
    assert eng.k_pages is None and eng.kv.pages_in_use == 0
    assert eng.results["w0"]
    with pytest.raises(RuntimeError, match="release_kv"):
        eng.run([Request("w2", [1, 2, 3], max_new_tokens=2)])
