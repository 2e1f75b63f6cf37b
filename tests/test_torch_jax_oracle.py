"""A faster JAX reference for the port's serving tests.

``torchdistx_tpu.serve.oracle_generate`` (the unbatched, no-cache greedy
reference) runs the flax ``model.apply`` op by op, once per generated
token, over a growing sequence: on the CPU every op pays its dispatch at
every new length.  :class:`JaxOracle` gives the same reference from ONE
jitted ``apply`` over the sequence padded to the model's
``max_seq_len``: the model is causal, so the logits at position L - 1
do not see the padding.  Results are memoized per (prompt, token count,
eos) on the instance, which a module-scoped fixture holds per family.

The tests here hold the helper against ``oracle_generate`` on the first
request of each serving test file that uses it (its ``FIRST_REQUEST``),
for each family the file serves, within the files' 1e-4, and hold the
helper's own branches.  This file holds at most 9 tests, so pytest-xdist's
``--dist loadfile`` (the files with the most tests first) starts it after
the JAX package's longest files.
"""

import functools
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from torchdistx_tpu.models import TransformerConfig as JaxConfig
from torchdistx_tpu.models import make_gpt2, make_llama
from torchdistx_tpu.serve import oracle_generate as jax_oracle_generate
from torchdistx_tpu.serve.programs import make_model as jax_make_model

SHAPES = {
    "llama": dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_ff=64, max_seq_len=64),
    "gpt2": dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                 max_seq_len=64, use_bias=True, activation="gelu",
                 norm="layernorm", positions="learned", tie_embeddings=True),
}


class JaxOracle:
    """``oracle_generate(family, jcfg, params, ...)`` from one jitted
    ``apply`` over a ``[1, max_seq_len]`` padded sequence."""

    def __init__(self, family, jcfg, params):
        self.family, self.jcfg = family, jcfg
        self.params = jax.tree.map(jnp.asarray, params)
        self._apply = jax.jit(jax_make_model(family, jcfg).apply)
        self._memo = {}

    def __call__(self, prompt, max_new_tokens, eos_id=None):
        key = (tuple(prompt), max_new_tokens, eos_id)
        if key not in self._memo:
            self._memo[key] = self._generate(list(prompt), max_new_tokens,
                                             eos_id)
        return self._memo[key]

    def _generate(self, toks, max_new_tokens, eos_id):
        buf = np.zeros((1, self.jcfg.max_seq_len), np.int32)
        out, logits_last = [], None
        for _ in range(max_new_tokens):
            buf[0, :len(toks)] = toks
            logits = np.asarray(self._apply(self.params, buf))
            logits_last = logits[0, len(toks) - 1].astype(np.float32)
            t = int(np.argmax(logits_last))
            out.append(t)
            toks.append(t)
            if eos_id is not None and t == eos_id:
                break
            if len(toks) >= self.jcfg.max_seq_len:
                break
        return out, logits_last

    def check_against_oracle_generate(self, prompt, max_new_tokens,
                                      atol, eos_id=None):
        """The helper's tokens are ``oracle_generate``'s, and its final
        logits within ``atol`` of them."""
        want, want_logits = jax_oracle_generate(
            self.family, self.jcfg, self.params, list(prompt),
            max_new_tokens, eos_id)
        got, got_logits = self(prompt, max_new_tokens, eos_id)
        assert got == want, (got, want)
        np.testing.assert_allclose(got_logits, want_logits, atol=atol)


@functools.lru_cache(maxsize=None)
def _oracle(family):
    """One helper per family, shared by the checks below (so are the
    per-primitive compiles the op-by-op ``oracle_generate`` pays)."""
    jcfg = JaxConfig(dtype=jnp.float32, **SHAPES[family])
    return JaxOracle(family, jcfg, flax_params(family, jcfg))


def flax_params(family, jcfg):
    """The serving tests' f32 flax params for ``family`` (seed 0)."""
    flax_model = (make_llama if family == "llama" else make_gpt2)(jcfg)
    params = flax_model.init(jax.random.PRNGKey(0),
                             jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("module,family", [
    ("test_torch_serve", "llama"), ("test_torch_serve", "gpt2"),
    ("test_torch_serve_features", "llama"),
    ("test_torch_serve_features", "gpt2"),
    ("test_torch_serve_chaos", "llama"),
])
def test_helper_is_oracle_generate_on_each_files_first_request(module,
                                                               family):
    """The helper gives ``oracle_generate``'s tokens, and its final logits
    within 1e-4 (the serving files' tolerance), on the first request of
    each file that stands it in for ``oracle_generate``, on the same
    model and weights as that file."""
    mod = importlib.import_module(module)
    assert mod.SHAPES[family] == SHAPES[family]
    prompt, n = mod.FIRST_REQUEST
    _oracle(family).check_against_oracle_generate(prompt, n, atol=1e-4)


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_helper_stops_where_oracle_generate_stops(family):
    """The helper's own branches: an eos
    token ends the generation after it, ``max_seq_len`` ends it when the
    sequence fills the model, and a memoized result is returned again,
    not recomputed."""
    jcfg = JaxConfig(dtype=jnp.float32, **SHAPES[family])
    oracle = _oracle(family)
    toks, logits = oracle([5, 9, 2], 4)
    assert len(toks) == 4 and logits.shape == (jcfg.vocab_size,)
    assert oracle([5, 9, 2], 4)[1] is logits
    assert oracle([5, 9, 2], 4, toks[1])[0] == toks[:2]
    near_end = [(3 * i) % 128 for i in range(62)]
    assert len(oracle(near_end, 5)[0]) == 2
    # Padding never reaches a valid position: a prompt's logits do not
    # move when the tokens after it change.
    buf = np.zeros((1, jcfg.max_seq_len), np.int32)
    buf[0, :3] = [5, 9, 2]
    zeros = np.asarray(oracle._apply(oracle.params, buf))
    buf[0, 3:] = 77
    sevens = np.asarray(oracle._apply(oracle.params, buf))
    np.testing.assert_array_equal(zeros[0, :3], sevens[0, :3])
