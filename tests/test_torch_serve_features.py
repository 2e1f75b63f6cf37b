"""The port's prefix cache, copy-on-write pages, chunked prefill and
speculative decoding on the CPU, held against the JAX package on
identical float32 weights (carried across by ``from_flax_params``).

One request mix through the engine (a shared-preamble storm, a fully
cached page-aligned prompt sent twice, a prompt longer than the largest
bucket at a small ``prefill_chunk`` with a short request behind it,
repetitive prompts for the drafter): every request's tokens equal the JAX ``oracle_generate`` (from ``test_torch_jax_oracle.JaxOracle``,
which that file holds against ``oracle_generate`` itself on the mix's
first request, ``FIRST_REQUEST``) and its final logits agree within
1e-4; the features really ran (prefix hits, reused tokens, a COW copy,
chunks interleaved with decode, verify ticks); ``spec_decode=False``
gives the same tokens; the JAX ``ServeEngine`` on the same requests and
``ServeConfig`` takes the same host decisions (tokens, drafted,
accepted, verify ticks, prefix hits, COW copies).

The programs against the JAX builders: ``test_torch_serve_programs.py``;
speculation through preemption and the engine's lifecycle:
``test_torch_serve_lifecycle.py``.

The configs are those of tests/test_torch_serve.py.
"""


import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_jax_oracle import JaxOracle, flax_params
from torchdistx_tpu import observe as jax_observe
from torchdistx_tpu.models import TransformerConfig as JaxConfig
from torchdistx_tpu.serve import Request as JaxRequest
from torchdistx_tpu.serve import ServeConfig as JaxServeConfig
from torchdistx_tpu.serve import ServeEngine as JaxServeEngine
from torchdistx_tpu_torch.models import TransformerConfig, from_flax_params
from torchdistx_tpu_torch.serve import (
    Request,
    ServeConfig,
    ServeEngine,
    make_model,
)

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

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
    weights, with the JAX reference memoized per request."""

    def __init__(self, family):
        self.family = family
        self.jcfg = JaxConfig(dtype=jnp.float32, **SHAPES[family])
        self.tcfg = TransformerConfig(dtype=torch.float32, **SHAPES[family])
        self.params = flax_params(family, self.jcfg)
        self.jax_oracle = JaxOracle(family, self.jcfg, self.params)
        self.model = make_model(family, self.tcfg, device="cpu")
        self.model.load_state_dict(
            from_flax_params(family, self.tcfg, self.params))
        self.model.eval()

    def engine(self, **serve):
        return ServeEngine(self.family, self.tcfg, self.model,
                           serve_cfg=ServeConfig(**serve), device="cpu")

    def oracle(self, r):
        return self.jax_oracle(r.tokens, r.max_new_tokens, r.eos_id)

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


# ---------------------------------------------------------------------------
# the engine: one request mix, three engines
# ---------------------------------------------------------------------------

PREAMBLE = [(3 * i + 1) % 128 for i in range(8)]        # one full page
CACHED = [(7 * i + 11) % 128 for i in range(16)]        # two full pages
LONG = [(11 * i + 5) % 128 for i in range(20)]          # > bucket 16
# The first request this file serves (prompt, new tokens): the mix's s0.
FIRST_REQUEST = (PREAMBLE + [1, 2], 4)


def mix():
    """Arrivals spaced so each follower admits after its leader's
    prefill published the shared pages (a 10-token prompt takes two
    chunks of 6, a 16-token one three)."""
    return [
        Request("s0", list(FIRST_REQUEST[0]),
                max_new_tokens=FIRST_REQUEST[1]),
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


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------
