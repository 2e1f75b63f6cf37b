"""The port's serving engine on the CPU held against the JAX package on
identical float32 weights (carried across by ``from_flax_params``).

Every request's tokens must equal the JAX ``oracle_generate`` (the
unbatched, no-cache greedy reference over the flax model) and its final
logits must agree within atol 1e-4 (the same math summed in another
order); the reference comes from ``test_torch_jax_oracle.JaxOracle``,
which that file holds against ``oracle_generate`` itself on this file's
first request (``FIRST_REQUEST``); through batching, staggered arrivals,
EOS and page-exhaustion preemption (a prompt longer than the largest
bucket and the bring-up: ``test_torch_serve_spin_up.py``).  Prefix caching and speculative decoding are on by default,
as in the JAX package.  The JAX ``ServeEngine``, with both off, serves
the preemption requests once beside the port's engine with both off:
equal tokens, equal preemption count.  The configs are those of
tests/test_serve.py; tests/test_torch_serve_features.py holds the
features themselves against the JAX package.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_jax_oracle import JaxOracle, flax_params
from torchdistx_tpu import observe
from torchdistx_tpu.models import TransformerConfig as JaxConfig
from torchdistx_tpu.serve import ServeConfig as JaxServeConfig
from torchdistx_tpu.serve import ServeEngine as JaxServeEngine
from torchdistx_tpu.serve import Request as JaxRequest
from torchdistx_tpu_torch.models import TransformerConfig, from_flax_params
from torchdistx_tpu_torch.serve import (
    Request,
    ServeConfig,
    ServeEngine,
    make_model,
    oracle_generate,
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
SERVE = dict(max_batch=2, page_size=8, n_pages=16, max_pages_per_seq=3,
             prefill_buckets=(8, 16))
# The first request this file serves (prompt, new tokens).
FIRST_REQUEST = ([5, 9, 2], 6)
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
        self.oracle = JaxOracle(family, self.jcfg, self.params)
        self.model = make_model(family, self.tcfg, device="cpu")
        self.model.load_state_dict(
            from_flax_params(family, self.tcfg, self.params))
        self.model.eval()

    def engine(self, **serve):
        return ServeEngine(self.family, self.tcfg, self.model,
                           serve_cfg=ServeConfig(**serve), device="cpu")

    def check_against_jax_oracle(self, eng, reqs, out):
        for r in reqs:
            want, want_logits = self.oracle(r.tokens, r.max_new_tokens,
                                            r.eos_id)
            assert out[r.rid] == want, (r.rid, out[r.rid], want)
            np.testing.assert_allclose(eng.final_logits[r.rid], want_logits,
                                       atol=1e-4, err_msg=r.rid)


@pytest.fixture(scope="module", params=["llama", "gpt2"])
def pair(request):
    return Pair(request.param)


def test_batched_engine_matches_jax_oracle(pair):
    reqs = [
        Request("a", list(FIRST_REQUEST[0]),
                max_new_tokens=FIRST_REQUEST[1]),
        Request("b", [17, 3, 3, 8, 1, 101], max_new_tokens=5),
        Request("c", [7] * 11, max_new_tokens=4),
    ]
    eng = pair.engine(**SERVE)
    out = eng.run(reqs)
    assert set(out) == {"a", "b", "c"}
    pair.check_against_jax_oracle(eng, reqs, out)
    assert eng.prefills == 3 and eng.preemptions == 0


def test_staggered_arrivals_match_jax_oracle(pair):
    """More requests than lanes, arriving over time: admission
    interleaves with decode and every output still matches."""
    reqs = [
        Request(f"s{i}", [(3 * i + j) % 128 for j in range(2 + i)],
                max_new_tokens=3 + (i % 3), arrival_step=i)
        for i in range(5)
    ]
    eng = pair.engine(**SERVE)
    out = eng.run(reqs)
    assert {r.rid for r in reqs} == set(out)
    pair.check_against_jax_oracle(eng, reqs, out)


def test_eos_retires_early(pair):
    first = pair.oracle([5, 9, 2], 1)[0][0]
    eng = pair.engine(**SERVE)
    out = eng.run([Request("e", [5, 9, 2], max_new_tokens=6, eos_id=first)])
    assert out["e"] == [first]  # retired at the first token, in prefill
    assert eng.decode_steps == 0 and eng.kv.pages_in_use == 0


def test_preemption_matches_jax_engine(pair):
    """Page exhaustion preempts (recompute policy): the port's engine and
    the JAX engine (prefix cache and speculation off) give the same
    tokens and the same preemption count, both equal to the oracle."""
    reqs = [
        Request("p0", [1, 2, 3, 4, 5, 6], max_new_tokens=8),
        Request("p1", [9, 8, 7, 6, 5, 4], max_new_tokens=8),
    ]
    eng = pair.engine(prefix_cache=False, spec_decode=False, **TIGHT)
    out = eng.run(reqs)
    assert eng.preemptions > 0
    assert eng.kv.pages_in_use == 0
    pair.check_against_jax_oracle(eng, reqs, out)
    # The port's own oracle agrees too.
    for r in reqs:
        assert oracle_generate(pair.model, r.tokens, r.max_new_tokens)[0] == \
            out[r.rid]

    jeng = JaxServeEngine(
        pair.family, pair.jcfg, jax.tree.map(jnp.asarray, pair.params),
        serve_cfg=JaxServeConfig(prefix_cache=False, spec_decode=False,
                                 **TIGHT))
    observe.enable(True)
    try:
        before = observe.counter("tdx.serve.preempted_requests").value
        jout = jeng.run([JaxRequest(r.rid, list(r.tokens),
                                    max_new_tokens=r.max_new_tokens)
                         for r in reqs])
        jpreempt = observe.counter("tdx.serve.preempted_requests").value - before
    finally:
        observe.enable(None)
    assert jout == out
    assert jpreempt == eng.preemptions
