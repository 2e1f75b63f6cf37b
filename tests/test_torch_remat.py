"""Full rematerialization (``remat="full"``) in the port, and the port's
presets against the JAX package's.

* every preset of the port equals the JAX preset of the same name, field
  by field (dtypes mapped), ``llama3-70b``'s ``remat="full"`` included;
* GPT-2, Llama, Mixtral (``tiny-moe``) and ViT with ``remat="full"``
  against ``"none"`` on the same weights and batch: loss and every
  gradient within 1e-6, the MoE router loss counted once;
* under ``"full"`` the attention runs twice per layer and step (forward
  and recompute), once under ``"none"`` and once without gradients;
* the port with ``remat="full"`` against the JAX model with
  ``remat="full"`` (``nn.remat``) on the same flax weights: logits and
  gradients within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torchdistx_tpu.models import PRESETS as JAX_PRESETS
from torchdistx_tpu.models import make_llama as jax_make_llama
from torchdistx_tpu.parallel.train import lm_cross_entropy as jax_ce
from torchdistx_tpu_torch.models import (
    PRESETS,
    from_flax_params,
    make_gpt2,
    make_llama,
    make_mixtral,
    make_vit,
)
from torchdistx_tpu_torch.models.layers import default_attention, router_aux_loss
from torchdistx_tpu_torch.parallel.train import lm_cross_entropy

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
FAMILIES = {"gpt2": (make_gpt2, "tiny-gpt2"), "llama": (make_llama, "tiny"),
            "mixtral": (make_mixtral, "tiny-moe"), "vit": (make_vit, "tiny-vit")}


def _same(port, ref, path):
    if dataclasses.is_dataclass(ref):
        assert dataclasses.is_dataclass(port), path
        assert type(port).__name__ == type(ref).__name__, path
        names = [f.name for f in dataclasses.fields(ref)]
        assert names == [f.name for f in dataclasses.fields(port)], path
        for n in names:
            _same(getattr(port, n), getattr(ref, n), f"{path}.{n}")
    elif ref in DTYPES:
        assert port == DTYPES[ref], path
    else:
        assert port == ref, path


def test_presets_match_jax_field_by_field():
    assert list(PRESETS) == list(JAX_PRESETS)
    for name, ref in JAX_PRESETS.items():
        _same(PRESETS[name], ref, name)
    assert PRESETS["llama3-70b"].remat == "full"


def _counting(calls):
    def attn_fn(q, k, v, **kw):
        calls.append(q.shape)
        return default_attention(q, k, v, **kw)
    return attn_fn


def _loss(family, model, cfg, seed):
    rng = np.random.RandomState(seed)
    if family == "vit":
        images = torch.from_numpy(rng.randn(
            2, cfg.image_size, cfg.image_size, cfg.channels).astype(np.float32))
        labels = torch.from_numpy(rng.randint(0, cfg.n_classes, 2))
        return F.cross_entropy(model(images), labels)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 16)))
    return lm_cross_entropy(model(tokens), tokens) + router_aux_loss(model)


def _with_remat(cfg, remat):
    if hasattr(cfg, "encoder"):
        return cfg.replace(encoder=cfg.encoder.replace(remat=remat))
    return cfg.replace(remat=remat)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_full_equals_none(family):
    make, preset = FAMILIES[family]
    runs = {}
    for remat in ("none", "full"):
        cfg = _with_remat(PRESETS[preset], remat)
        calls = []
        torch.manual_seed(0)
        model = make(cfg, attn_fn=_counting(calls), device="cpu")
        loss = _loss(family, model, cfg, seed=1)
        forward_calls = len(calls)
        loss.backward()
        aux = [m.aux.item() for m in model.modules() if hasattr(m, "kept")]
        runs[remat] = (loss.item(), {n: p.grad for n, p in model.named_parameters()},
                       forward_calls, len(calls), aux)
    (l0, g0, f0, c0, a0), (l1, g1, f1, c1, a1) = runs["none"], runs["full"]
    n_layers = getattr(PRESETS[preset], "encoder", PRESETS[preset]).n_layers
    assert f0 == f1 == n_layers
    assert c0 == n_layers and c1 == 2 * n_layers  # the recompute
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    assert a0 == pytest.approx(a1, rel=1e-6)  # the recompute's aux: the same
    for name, g in g0.items():
        err = float((g1[name] - g).norm() / g.norm().clamp_min(1e-30))
        assert err <= 1e-6, (name, err)


def test_remat_counts_the_aux_once():
    """The loss of a MoE model under ``"full"`` is ``ce + aux`` with the
    aux of one forward, as under ``"none"``."""
    cfg = PRESETS["tiny-moe"]
    losses = {}
    for remat in ("none", "full"):
        torch.manual_seed(0)
        model = make_mixtral(cfg.replace(remat=remat), device="cpu")
        tokens = torch.from_numpy(np.random.RandomState(2).randint(
            0, cfg.vocab_size, (2, 16)))
        ce = lm_cross_entropy(model(tokens), tokens)
        aux = router_aux_loss(model)
        (ce + aux).backward()
        losses[remat] = (ce.item(), aux.item(), router_aux_loss(model).item())
    assert losses["full"] == pytest.approx(losses["none"], rel=1e-6)
    assert losses["full"][1] > 0


def test_remat_without_gradients_runs_once():
    calls = []
    cfg = PRESETS["tiny"].replace(remat="full")
    model = make_llama(cfg, attn_fn=_counting(calls), device="cpu")
    with torch.no_grad():
        model(torch.zeros(1, 8, dtype=torch.long))
    assert len(calls) == cfg.n_layers


def test_unknown_remat_raises():
    model = make_llama(PRESETS["tiny"].replace(remat="some"), device="cpu")
    with pytest.raises(ValueError, match="remat"):
        model(torch.zeros(1, 8, dtype=torch.long))


def test_remat_matches_jax_remat():
    jcfg = JAX_PRESETS["tiny"].replace(remat="full")
    cfg = PRESETS["tiny"].replace(remat="full")
    jmodel = jax_make_llama(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    model = make_llama(cfg, device="cpu")
    model.load_state_dict(from_flax_params("llama", cfg, params))
    tokens = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 16))
    loss_fn = lambda p: jax_ce(jmodel.apply(p, jnp.asarray(tokens)),  # noqa: E731
                               jnp.asarray(tokens))
    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    t = torch.from_numpy(tokens)
    loss = lm_cross_entropy(model(t), t)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = from_flax_params("llama", cfg, jax.tree.map(np.asarray, grads))
    for name, p in model.named_parameters():
        err = float((p.grad - want[name]).norm() / want[name].norm())
        assert err <= 1e-5, (name, err)
