"""A serving replica's weights come from the keyed materializer (ROADMAP
C18).

The JAX package's ``spin_up_replica`` takes its replica's values from the
init program that every materialization runs
(``torchdistx_tpu/serve/engine.py``, ``abstract.materialize_parts``): a
function of (seed, recording), cast to ``param_dtype``, that leaves no
global generator changed.  These tests hold both packages to that
contract on the CPU and the port to the reference's names, shapes and
dtypes:

* the JAX replica's params are bitwise ``abstract.materialize`` of the
  same recording and seed, and the port replica's parameters are bitwise
  ``materialize_module_cuda`` of the same recording and seed;
* neither spin-up changes numpy's or torch's global generator;
* the port replica's parameters have the JAX replica's names (through
  ``from_flax_params``), shapes and dtypes, ``param_dtype=bfloat16``
  included;
* two seeds give different weights.

The values themselves differ between the packages (threefry there,
Philox here: ROADMAP C4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistx_tpu import abstract as jax_abstract
from torchdistx_tpu.models import PRESETS as JAX_PRESETS
from torchdistx_tpu.serve import ServeConfig as JaxServeConfig
from torchdistx_tpu.serve import spin_up_replica as jax_spin_up_replica
from torchdistx_tpu.serve.programs import make_model as jax_make_model
from torchdistx_tpu_torch.cuda_bridge.materialize import (
    materialize_module_cuda,
)
from torchdistx_tpu_torch.deferred_init import deferred_init
from torchdistx_tpu_torch.fake import is_fake
from torchdistx_tpu_torch.models import PRESETS, from_flax_params
from torchdistx_tpu_torch.serve import ServeConfig, spin_up_replica
from torchdistx_tpu_torch.serve.programs import make_model

torch.set_num_threads(2)

SERVE = dict(max_batch=2, page_size=4, n_pages=16, max_pages_per_seq=4,
             prefill_buckets=(8,), prefix_cache=False, spec_decode=False)
CPU = torch.device("cpu")
CASES = [("tiny", "llama", None), ("tiny-gpt2", "gpt2", None),
         ("tiny", "llama", torch.bfloat16)]
JAX_DTYPE = {None: None, torch.bfloat16: jnp.bfloat16}


def keyed_values(preset: str, family: str, seed: int, param_dtype=None):
    """``materialize_module_cuda`` of a fresh recording of the preset, as
    ``spin_up_replica`` records and materializes it."""
    cfg = PRESETS[preset]
    if param_dtype is not None:
        cfg = cfg.replace(param_dtype=param_dtype)
    fake = deferred_init(make_model, family, cfg, CPU)
    return materialize_module_cuda(fake, seed=seed, param_dtype=param_dtype,
                                   device="cpu")


def replica(preset: str, seed: int, param_dtype=None):
    return spin_up_replica(preset, seed=seed, param_dtype=param_dtype,
                           device="cpu", serve_cfg=ServeConfig(**SERVE),
                           health_component="test-serve-keyed")


def jax_replica(preset: str, seed: int, param_dtype=None):
    return jax_spin_up_replica(preset, seed=seed,
                               param_dtype=JAX_DTYPE[param_dtype],
                               serve_cfg=JaxServeConfig(**SERVE), warm=False,
                               health_component="test-serve-keyed")


def global_generators():
    return np.random.get_state()[1].copy(), torch.get_rng_state()


def same_generators(a, b) -> bool:
    return np.array_equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("preset,family,param_dtype", CASES)
def test_replica_holds_the_keyed_values(preset, family, param_dtype):
    """Every parameter and buffer of the replica is, bit for bit, the
    keyed materializer's value of the same name for the same recording,
    seed and ``param_dtype``; every floating parameter is stored in
    ``param_dtype`` where one is given."""
    eng = replica(preset, 5, param_dtype)
    want = keyed_values(preset, family, 5, param_dtype)
    got = dict(eng.model.named_parameters())
    got.update(eng.model.named_buffers())
    assert set(want) <= set(got)
    assert not any(is_fake(t) for t in got.values())
    for name, value in want.items():
        assert got[name].dtype == value.dtype, name
        assert torch.equal(got[name].detach(), value), name
    if param_dtype is not None:
        for name, p in eng.model.named_parameters():
            assert p.dtype == param_dtype, name


@pytest.mark.parametrize("preset,family,param_dtype", CASES)
def test_replica_contract_matches_the_jax_replica(preset, family,
                                                  param_dtype):
    """The JAX replica holds its own contract (its params bitwise
    ``abstract.materialize`` of the same recording and seed), neither
    replica moves numpy's or torch's global generator, and the port
    replica has the JAX replica's names, shapes and dtypes."""
    np.random.seed(77)
    torch.manual_seed(77)
    before = global_generators()
    jeng = jax_replica(preset, 5, param_dtype)
    assert same_generators(global_generators(), before)

    model = jax_make_model(family, JAX_PRESETS[preset])
    fakes = jax_abstract.deferred_init(
        model.init, jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32))
    own = jax_abstract.materialize(fakes, param_dtype=JAX_DTYPE[param_dtype])
    got = jax.tree_util.tree_leaves_with_path(jeng.params)
    want = jax.tree_util.tree_leaves_with_path(own)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype, jax.tree_util.keystr(path)
        assert np.array_equal(np.asarray(g), np.asarray(w)), \
            jax.tree_util.keystr(path)

    before = global_generators()
    eng = replica(preset, 5, param_dtype)
    assert same_generators(global_generators(), before)
    # Each JAX leaf as a same-shaped code of its dtype, carried through
    # the port's name and layout mapping.
    codes = {jnp.dtype(jnp.float32): 0.0, jnp.dtype(jnp.bfloat16): 1.0}
    coded = jax.tree.map(
        lambda x: np.full(x.shape, codes[x.dtype], np.float32), jeng.params)
    ref = from_flax_params(family, PRESETS[preset], coded)
    port = dict(eng.model.named_parameters())
    assert set(port) == set(ref)
    for name, code in ref.items():
        assert tuple(port[name].shape) == tuple(code.shape), name
        want_dtype = {0.0: torch.float32, 1.0: torch.bfloat16}[
            float(code.flatten()[0])]
        assert port[name].dtype == want_dtype, name


def test_spin_up_leaves_the_global_generator_alone():
    """The generator's state is the same before and after a spin-up, so
    the caller's next draw is the one it would have made without it."""
    torch.manual_seed(1234)
    before = torch.get_rng_state()
    replica("tiny", 3)
    assert torch.equal(torch.get_rng_state(), before)
    want = torch.rand(8)
    torch.manual_seed(1234)
    assert torch.equal(torch.rand(8), want)


def test_two_seeds_give_different_weights():
    """Seed 0 and seed 1 draw different values for every random entry;
    the entries that draw nothing (norm scales) stay equal."""
    a = dict(replica("tiny", 0).model.named_parameters())
    b = dict(replica("tiny", 1).model.named_parameters())
    differ = [n for n in a if not torch.equal(a[n], b[n])]
    assert differ
    for name in a:
        if name not in differ:
            assert bool((a[name] == a[name].flatten()[0]).all()), name
