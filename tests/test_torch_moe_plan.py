"""Mixtral's sharding plan against the flax plan, the keyed values'
mesh invariance, and serving's refusal of MoE models.

Kept apart from ``test_torch_moe.py`` so that neither file holds more
than 9 tests: pytest-xdist's ``--dist loadfile`` starts the files with
the most tests first, and the JAX package's longest files hold few
(``test_rollover.py`` 9), so a slow port file of more than 9 would start
before them and delay them.
"""

import itertools
import warnings

import jax
import jax.numpy as jnp
from jax.tree_util import tree_flatten_with_path
import pytest
import torch

from torchdistx_tpu.models import make_mixtral as jax_make_mixtral
from torchdistx_tpu.models import plans as jax_plans
from torchdistx_tpu.parallel import mesh as jax_mesh
from torchdistx_tpu_torch import deferred_init
from torchdistx_tpu_torch.cuda_bridge import (
    materialize_module_cuda,
    named_fake_tensors,
)
from torchdistx_tpu_torch.models import decoder_lm_plan, make_mixtral
from torchdistx_tpu_torch.parallel import VirtualMesh
from torchdistx_tpu_torch.parallel.sharding import local_shard, mesh_shape
from torchdistx_tpu_torch.serve.programs import make_model
from test_torch_moe import CFG, JCFG

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)


def _translate_moe(path, shape, spec, n_layers):
    """{port name: spec} for a flax leaf of the MoE decoder, the way
    models/convert.py maps it."""
    from test_torch_sharding import _translate

    parts = path.split(".")
    if "moe" not in parts:
        return _translate(path, shape, spec, n_layers)
    s = (tuple(spec) + (None,) * (len(shape) - len(spec)))[1:]
    leaf = parts[-1]
    if leaf == "kernel":  # the router [d, E] -> [E, d]
        name, s = "moe.router.weight", (s[1], s[0])
    else:
        name = f"moe.{leaf}"
    return {f"blocks.{i}.{name}": s for i in range(n_layers)}


@pytest.mark.parametrize("axes", [{"ep": 4, "fsdp": 2}, {"ep": 2, "fsdp": 2, "tp": 2},
                                  {"fsdp": 2, "tp": 4}, {"ep": 4, "tp": 2}],
                         ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items()))
def test_decoder_lm_plan_matches_the_flax_plan(axes):
    from test_torch_sharding import _strip

    fakes = named_fake_tensors(deferred_init(make_mixtral, CFG, device="cpu"))
    tree = jax.eval_shape(lambda: jax_make_mixtral(JCFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    leaves = [(".".join(str(getattr(k, "key", k)) for k in path), leaf.shape)
              for path, leaf in tree_flatten_with_path(tree["params"])[0]]
    leaves = [("params." + path, shape) for path, shape in leaves]
    port_plan, jax_plan = decoder_lm_plan(CFG), jax_plans.decoder_lm_plan()
    jmesh = jax_mesh.make_mesh(axes)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = {}
        for path, shape in leaves:
            want.update(_translate_moe(path, shape,
                                       jax_plan.spec_for(path, shape, jmesh),
                                       CFG.n_layers))
        assert set(want) == set(fakes)
        sharded_over_ep = 0
        for name, fake in fakes.items():
            got = port_plan.spec_for(name, tuple(fake.shape), dict(jmesh.shape))
            assert _strip(got) == _strip(want[name]), (axes, name)
            sharded_over_ep += "ep" in str(got)
    assert sharded_over_ep == (3 * CFG.n_layers if "ep" in axes else 0)


@pytest.mark.parametrize("axes", [{"ep": 4}, {"ep": 2, "fsdp": 2}],
                         ids=["ep4", "ep2-fsdp2"])
def test_keyed_values_are_mesh_invariant(axes):
    """Each coordinate's shards equal their slices of the unsharded keyed
    values, bit for bit, and the expert stacks are split."""
    model = deferred_init(make_mixtral, CFG, device="cpu")
    full = materialize_module_cuda(model, seed=3, device="cpu")
    plan = decoder_lm_plan(CFG)
    shape = mesh_shape(VirtualMesh(axes, {a: 0 for a in axes}))
    specs = {n: plan.spec_for(n, tuple(t.shape), shape) for n, t in full.items()}
    split = set()
    for coord in itertools.product(*(range(s) for s in shape.values())):
        local = materialize_module_cuda(
            model, mesh=VirtualMesh(axes, dict(zip(shape, coord))), plan=plan,
            seed=3, device="cpu")
        assert set(local) == set(full)
        for name, value in local.items():
            want = local_shard(full[name], specs[name], shape, coord)
            assert torch.equal(value, want), (coord, name)
            if ".moe.w_" in name and value.shape[0] < full[name].shape[0]:
                split.add(name)
    assert len(split) == 3 * CFG.n_layers


def test_serving_refuses_moe():
    with pytest.raises(NotImplementedError, match="MoE"):
        make_model("llama", CFG, device="cpu")
