"""ViT's sharding plan against the flax plan, and the image-size check.

Kept apart from ``test_torch_vit.py`` so that neither file holds more
than 9 tests: pytest-xdist's ``--dist loadfile`` starts the files with
the most tests first, and the JAX package's longest files hold few
(``test_rollover.py`` 9), so a slow port file of more than 9 would start
before them and delay them.
"""

import warnings

import jax
import jax.numpy as jnp
from jax.tree_util import tree_flatten_with_path
import pytest
import torch

from torchdistx_tpu.models import plans as jax_plans
from torchdistx_tpu.models.vit import make_vit as jax_make_vit
from torchdistx_tpu.parallel import mesh as jax_mesh
from torchdistx_tpu_torch import deferred_init
from torchdistx_tpu_torch.cuda_bridge import named_fake_tensors
from torchdistx_tpu_torch.models import make_vit, vit_plan
from test_torch_vit import CFG, JCFG

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)


def test_indivisible_image_raises():
    model = make_vit(CFG, device="cpu")
    with pytest.raises(ValueError, match="divisible by patch_size"):
        model(torch.zeros(1, 30, 32, 3))


def _translate_vit(path, shape, spec, n_layers):
    from test_torch_sharding import _translate

    s = tuple(spec) + (None,) * (len(shape) - len(spec))
    if path == "params.patch_embed.kernel":  # [P, P, C, d] -> [d, C, P, P]
        return {"patch_embed.weight": (s[3], s[2], s[0], s[1])}
    return _translate(path, shape, spec, n_layers)


@pytest.mark.parametrize("axes", [{"fsdp": 8}, {"fsdp": 2, "tp": 4},
                                  {"dp": 2, "fsdp": 2, "tp": 2}],
                         ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items()))
def test_vit_plan_matches_the_flax_plan(axes):
    from test_torch_sharding import _strip

    fakes = named_fake_tensors(deferred_init(make_vit, CFG, device="cpu"))
    tree = jax.eval_shape(lambda: jax_make_vit(JCFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32)))
    leaves = [("params." + ".".join(str(getattr(k, "key", k)) for k in path),
               leaf.shape)
              for path, leaf in tree_flatten_with_path(tree["params"])[0]]
    port_plan, jax_plan = vit_plan(CFG), jax_plans.vit_plan()
    jmesh = jax_mesh.make_mesh(axes)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = {}
        for path, shape in leaves:
            want.update(_translate_vit(path, shape,
                                       jax_plan.spec_for(path, shape, jmesh),
                                       CFG.encoder.n_layers))
        assert set(want) == set(fakes)
        for name, fake in fakes.items():
            got = port_plan.spec_for(name, tuple(fake.shape), dict(jmesh.shape))
            assert _strip(got) == _strip(want[name]), (axes, name)
