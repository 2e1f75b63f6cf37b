"""The port's T5 held against the JAX package's flax T5 on identical
float32 weights (carried across by ``from_flax_params("t5", ...)``).

* logits of ``TINY_T5``, the port on ``make_flash_attention()`` (its plain
  versions on CPU tensors) and JAX on ``default_attention``, within 2e-5
  (the band of tests/test_ops.py ``test_t5_runs_on_flash_kernel``), also
  with packed ``(enc_seg, dec_seg)`` batches, whose masking is shown to be
  real;
* ``CrossAttention`` with a ``(q_seg, kv_seg)`` pair, within 1e-5;
* every parameter's gradient of ``lm_cross_entropy`` against
  ``jax.grad``, within 1e-5 x max(1, max |JAX gradient|) per leaf, the
  relative-position tables (whose only gradient is d(bias)) included;
* the relative-position bucket maps, integer for integer
  (``test_torch_t5_buckets.py``);
* deferred init → ``materialize_module(device="cpu")`` equal, bitwise,
  to eager construction under the same seed.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torchdistx_tpu.models import TINY as JAX_TINY
from torchdistx_tpu.models import TINY_T5 as JAX_TINY_T5
from torchdistx_tpu.models import make_t5 as jax_make_t5
from torchdistx_tpu.models.layers import CrossAttention as JaxCrossAttention
from torchdistx_tpu.parallel.train import lm_cross_entropy as jax_ce
from torchdistx_tpu_torch import deferred_init, is_fake, materialize_module
from torchdistx_tpu_torch.models import TINY, TINY_T5, from_flax_params, make_t5
from torchdistx_tpu_torch.models.layers import CrossAttention
from torchdistx_tpu_torch.ops import make_flash_attention
from torchdistx_tpu_torch.ops.flash_attention import launches
from torchdistx_tpu_torch.parallel import lm_cross_entropy

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

B, S_ENC, S_DEC = 2, 16, 11  # a decoder shorter than the encoder


def _batch():
    rng = np.random.RandomState(0)
    enc = rng.randint(0, TINY_T5.vocab_size, (B, S_ENC)).astype(np.int32)
    dec = rng.randint(0, TINY_T5.vocab_size, (B, S_DEC)).astype(np.int32)
    enc_seg = np.tile((np.arange(S_ENC) >= 10).astype(np.int32), (B, 1))
    dec_seg = np.tile((np.arange(S_DEC) >= 6).astype(np.int32), (B, 1))
    return enc, dec, (enc_seg, dec_seg)


@pytest.fixture(scope="module")
def models():
    """(flax model, its params as numpy, the port on the flash AttnFn with
    the same weights)."""
    enc, dec, _ = _batch()
    flax_model = jax_make_t5(JAX_TINY_T5)
    params = jax.jit(flax_model.init)(jax.random.PRNGKey(0), jnp.asarray(enc),
                                      jnp.asarray(dec))
    params = jax.tree.map(np.asarray, params)
    model = make_t5(TINY_T5, attn_fn=make_flash_attention(), device="cpu")
    sd = from_flax_params("t5", TINY_T5, params)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    return flax_model, params, model


def _port_logits(model, enc, dec, segs=None):
    tsegs = None if segs is None else tuple(torch.from_numpy(s) for s in segs)
    before = dict(launches)
    with torch.no_grad():
        out = model(torch.from_numpy(enc).long(), torch.from_numpy(dec).long(),
                    segment_ids=tsegs)
    assert launches == before  # CPU tensors run the plain versions
    return out.numpy()


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_logits_match_jax(models, packed):
    flax_model, params, model = models
    enc, dec, segs = _batch()
    segs = segs if packed else None
    want = np.asarray(jax.jit(
        lambda p, e, d, s: flax_model.apply(p, e, d, segment_ids=s))(
        params, jnp.asarray(enc), jnp.asarray(dec),
        None if segs is None else tuple(map(jnp.asarray, segs))))
    got = _port_logits(model, enc, dec, segs)
    assert got.dtype == np.float32 and got.shape == (B, S_DEC, TINY_T5.vocab_size)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    if packed:  # the masking is real
        assert np.abs(got - _port_logits(model, enc, dec)).max() > 1e-4


def test_cross_attention_segment_pair():
    """Each decoder position attends only its own document's encoder span,
    on the port's plain attention and on the flash AttnFn alike."""
    Sq, Sk = 16, 24
    rng = np.random.RandomState(1)
    x = rng.randn(B, Sq, JAX_TINY.d_model).astype(np.float32)
    kv = rng.randn(B, Sk, JAX_TINY.d_model).astype(np.float32)
    q_seg = np.tile((np.arange(Sq) >= 8).astype(np.int32), (B, 1))
    kv_seg = np.tile((np.arange(Sk) >= 12).astype(np.int32), (B, 1))
    mod = JaxCrossAttention(JAX_TINY)
    params = jax.jit(mod.init)(jax.random.PRNGKey(2), jnp.asarray(x),
                               jnp.asarray(kv))
    want = np.asarray(jax.jit(
        lambda p, a, b, s: mod.apply(p, a, b, segment_ids=s))(
        params, jnp.asarray(x), jnp.asarray(kv),
        (jnp.asarray(q_seg), jnp.asarray(kv_seg))))
    sd = {f"{name}.weight": torch.from_numpy(np.asarray(
              leaf["kernel"]).reshape(-1 if name == "wo" else TINY.d_model,
                                      TINY.d_model if name == "wo" else -1).T
              .copy())
          for name, leaf in params["params"].items()}
    tx, tkv = torch.from_numpy(x), torch.from_numpy(kv)
    pair = (torch.from_numpy(q_seg), torch.from_numpy(kv_seg))
    for attn_fn in (None, make_flash_attention()):
        port = (CrossAttention(TINY, device="cpu") if attn_fn is None
                else CrossAttention(TINY, device="cpu", attn_fn=attn_fn))
        port.load_state_dict(sd)
        with torch.no_grad():
            got = port(tx, tkv, segment_ids=pair).numpy()
            other = port(tx, tkv, segment_ids=(pair[0], 1 - pair[1])).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        assert np.abs(got - other).max() > 1e-4  # the masking is real


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_gradients_match_jax(models, packed):
    flax_model, params, model = models
    enc, dec, segs = _batch()
    segs = segs if packed else None
    jsegs = None if segs is None else tuple(map(jnp.asarray, segs))

    @jax.jit
    def loss_grad(p):
        def loss(p):
            logits = flax_model.apply(p, jnp.asarray(enc), jnp.asarray(dec),
                                      segment_ids=jsegs)
            return jax_ce(logits, jnp.asarray(dec))
        return jax.value_and_grad(loss)(p)

    want_loss, want_grads = loss_grad(params)
    want = from_flax_params("t5", TINY_T5, jax.tree.map(np.asarray, want_grads))

    model.zero_grad(set_to_none=True)
    tsegs = None if segs is None else tuple(torch.from_numpy(s) for s in segs)
    loss = lm_cross_entropy(
        model(torch.from_numpy(enc).long(), torch.from_numpy(dec).long(),
              segment_ids=tsegs), torch.from_numpy(dec).long())
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    grads = dict(model.named_parameters())
    assert set(grads) == set(want)
    for name, w in want.items():
        g = grads[name].grad
        assert g is not None, name
        limit = 1e-5 * max(1.0, w.abs().max().item())
        err = (g - w).abs().max().item()
        assert err <= limit, f"{name}: {err} > {limit}"
    for table in ("enc_relpos.embedding", "dec_relpos.embedding"):
        assert grads[table].grad.abs().max() > 0, table


def test_deferred_init_equals_eager():
    """The relative tables draw normal(1.0) without reading a value, so a
    recording stays value-free and its materialization equals eager
    construction bitwise under the same seed."""
    torch.manual_seed(7)
    eager = make_t5(TINY_T5, device="cpu")
    fake = deferred_init(make_t5, TINY_T5, device="cpu")
    assert all(is_fake(p) for p in fake.parameters())
    torch.manual_seed(7)
    ours = materialize_module(fake, device="cpu")
    se, so = eager.state_dict(), ours.state_dict()
    assert list(se) == list(so)
    for k in se:
        assert se[k].dtype == so[k].dtype and torch.equal(se[k], so[k]), k
    assert ours.enc_relpos.embedding.dtype == torch.float32
