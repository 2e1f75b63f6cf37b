"""The port's ViT (``make_vit``) held against the JAX package's flax ViT
on identical float32 weights (numpy from a seed, carried across by
``from_flax_params``).

* ``tiny-vit`` logits with ``pool`` ``cls`` (S = 17: 16 patches and the
  class token) and ``gap`` (S = 16), on ``default_attention`` and on
  ``make_flash_attention()`` (its plain version on the CPU), within 1e-5;
* the gradients of a label cross-entropy against ``jax.grad``, within
  1e-5 (the key biases, whose gradient is zero in exact arithmetic,
  below 1e-5 of the key weights' on both sides);
* a few AdamW steps of a label cross-entropy on a fixed batch: the loss
  falls.

``vit_plan`` and the image-size check: ``test_torch_vit_plan.py``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from torchdistx_tpu.models import PRESETS as JAX_PRESETS
from torchdistx_tpu.models.vit import make_vit as jax_make_vit
from torchdistx_tpu_torch.models import PRESETS, from_flax_params, make_vit
from torchdistx_tpu_torch.ops import make_flash_attention
from torchdistx_tpu_torch.parallel.train import default_optimizer

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

TOL = 1e-5
CFG, JCFG = PRESETS["tiny-vit"], JAX_PRESETS["tiny-vit"]
B = 3


def _images(cfg, seed=0, size=None):
    size = size or cfg.image_size
    return np.random.RandomState(seed).randn(
        B, size, size, cfg.channels).astype(np.float32)


def _pair(pool, attn, seed=0):
    """(flax model, params as numpy, the port's model on them)."""
    cfg, jcfg = CFG.replace(pool=pool), JCFG.replace(pool=pool)
    jmodel = jax_make_vit(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), jnp.asarray(_images(cfg))))
    fn = make_flash_attention() if attn == "flash" else None
    model = make_vit(cfg, device="cpu", **({"attn_fn": fn} if fn else {}))
    model.load_state_dict(from_flax_params("vit", cfg, params))
    return jmodel, params, model


@pytest.mark.parametrize("attn", ["default", "flash"])
@pytest.mark.parametrize("pool", ["cls", "gap"])
def test_logits_match_flax(pool, attn):
    jmodel, params, model = _pair(pool, attn)
    images = _images(model.cfg, seed=1)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(images)))
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    assert got.dtype == np.float32 and got.shape == (B, CFG.n_classes)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_from_flax_params_covers_state_dict():
    for pool in ("cls", "gap"):
        _, params, model = _pair(pool, "default")
        assert set(from_flax_params("vit", model.cfg, params)) == \
            set(model.state_dict())


def _label_ce_jax(logits, labels):
    return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()


@pytest.mark.parametrize("pool", ["cls", "gap"])
def test_grads_match_jax(pool):
    jmodel, params, model = _pair(pool, "flash")
    images = _images(model.cfg, seed=2)
    labels = np.random.RandomState(2).randint(0, CFG.n_classes, B)
    loss_fn = lambda p: _label_ce_jax(  # noqa: E731
        jmodel.apply(p, jnp.asarray(images)), jnp.asarray(labels))
    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss = F.cross_entropy(model(torch.from_numpy(images)),
                           torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL)
    want = from_flax_params("vit", model.cfg, jax.tree.map(np.asarray, grads))
    got = {n: p.grad for n, p in model.named_parameters()}
    for name, g in got.items():
        if name.endswith("attn.wk.bias"):
            # Zero in exact arithmetic (a per-query shift of the logits):
            # both sides hold rounding noise, far below the key weights'.
            scale = float(want[name.replace("bias", "weight")].norm())
            assert float(g.norm()) <= TOL * scale, name
            assert float(want[name].norm()) <= TOL * scale, name
            continue
        err = float((g - want[name]).norm() / want[name].norm().clamp_min(1e-30))
        assert err <= TOL, (name, err)


def test_training_loss_falls():
    """4 AdamW steps of a label cross-entropy on one batch."""
    torch.manual_seed(0)
    model = make_vit(CFG, attn_fn=make_flash_attention(), device="cpu")
    opt = default_optimizer(model.parameters())
    images = torch.from_numpy(_images(CFG, seed=3))
    labels = torch.from_numpy(np.random.RandomState(3).randint(
        0, CFG.n_classes, B))
    losses = []
    for _ in range(4):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(images), labels)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert all(np.isfinite(losses))
    assert all(x < losses[0] for x in losses[1:]), losses
