"""The ``chunk-<bucket>``, ``verify-<k>`` and ``cow`` programs against the JAX
``build_chunk_prefill_fn`` / ``build_verify_fn`` / ``build_cow_fn`` on equal
pools, with a shared first page and padded lanes: logits within 1e-5,
pools within 1e-6.

Kept apart from ``test_torch_serve_features.py`` so that neither file
holds more than 9 tests: pytest-xdist's ``--dist loadfile`` starts the
files with the most tests first, and the JAX package's longest files
hold few (``test_rollover.py`` 9), so a slow port file of more than 9
would start before them and delay them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistx_tpu.serve import ServeConfig as JaxServeConfig
from torchdistx_tpu.serve.programs import (
    build_chunk_prefill_fn as jax_chunk_fn,
)
from torchdistx_tpu.serve.programs import build_cow_fn as jax_cow_fn
from torchdistx_tpu.serve.programs import build_verify_fn as jax_verify_fn
from torchdistx_tpu_torch.serve.programs import (
    build_chunk_prefill_fn,
    build_cow_fn,
    build_verify_fn,
)
from test_torch_serve_features import FEAT, Pair

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["llama", "gpt2"])
def pair(request):
    return Pair(request.param)


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
