"""The port's training step held against the JAX package's.

On identical float32 weights (carried across by ``from_flax_params``) and
the same numpy-seeded batches:

* ``lm_cross_entropy`` equals the JAX loss, with and without packed
  segment ids;
* one batch's gradients equal ``jax.grad`` of the JAX loss, for TINY-sized
  llama and gpt2;
* a 4-step trajectory of ``make_train_step`` — loss and global gradient
  norm, the third step packed with segment ids — follows the JAX
  ``make_train_step`` on a 1-device CPU mesh, with the flash ``attn_fn``
  on both sides (the JAX Pallas kernels in interpret mode, the port's
  plain versions on CPU tensors);
* deferred init → ``materialize_module(device="cpu")`` → ``train_step``
  runs on the CPU with no kernel launched.

The step's options (unported ones raise, the attention function, the
CUDA default): ``test_torch_train_options.py``.

Tolerances: gradients 1e-5 absolute and losses / gradient norms 1e-5
relative — the same float32 math in both frameworks, summed in another
order; AdamW (the same hyperparameters on both sides) moves each weight
by about the learning rate whatever its gradient's size, so the four
steps stay as close as the first.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from torchdistx_tpu.models import TransformerConfig as JaxConfig
from torchdistx_tpu.models import make_gpt2 as jax_make_gpt2
from torchdistx_tpu.models import make_llama as jax_make_llama
from torchdistx_tpu.ops import make_flash_attention as jax_make_flash
from torchdistx_tpu.parallel.train import lm_cross_entropy as jax_ce
from torchdistx_tpu.parallel.train import make_train_step as jax_make_train_step
from torchdistx_tpu_torch import deferred_init, is_fake, materialize_module
from torchdistx_tpu_torch.models import (
    TINY,
    TransformerConfig,
    from_flax_params,
    make_gpt2,
    make_llama,
)
from torchdistx_tpu_torch.ops import make_flash_attention
from torchdistx_tpu_torch.ops.flash_attention import launches
from torchdistx_tpu_torch.parallel import lm_cross_entropy, make_train_step
from torchdistx_tpu_torch.parallel.train import train_step_flops

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

SHAPES = {  # head dim 16: a size the flash kernels take
    "llama": dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_ff=128, max_seq_len=64),
    "gpt2": dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                 max_seq_len=64, use_bias=True, activation="gelu",
                 norm="layernorm", positions="learned", tie_embeddings=True),
}
MAKE = {"llama": (jax_make_llama, make_llama), "gpt2": (jax_make_gpt2, make_gpt2)}


def _packed_ids(B, S):
    """Three documents and a padded tail (negative id) per row."""
    row = np.concatenate([np.zeros(10), np.ones(12), np.full(S - 26, 2),
                          np.full(4, -1)]).astype(np.int32)
    return np.tile(row, (B, 1))


@functools.lru_cache(maxsize=None)
def _init_params(family):
    """The flax model's initial weights as numpy (the attention function
    holds no weights, so one init serves both attention flavours)."""
    jcfg = JaxConfig(dtype=jnp.float32, **SHAPES[family])
    params = jax.jit(MAKE[family][0](jcfg).init)(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, params)


def _pair(family, *, flash=False):
    """(flax model, numpy params, port model) on identical f32 weights."""
    jcfg = JaxConfig(dtype=jnp.float32, **SHAPES[family])
    tcfg = TransformerConfig(dtype=torch.float32, **SHAPES[family])
    jax_make, make = MAKE[family]
    jattn = jax_make_flash(block_q=16, block_k=16) if flash else None
    flax_model = jax_make(jcfg, **({"attn_fn": jattn} if flash else {}))
    params = _init_params(family)
    model = make(tcfg, **({"attn_fn": make_flash_attention()} if flash else {}),
                 device="cpu")
    model.load_state_dict(from_flax_params(family, tcfg, params))
    return jcfg, tcfg, flax_model, params, model


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_lm_cross_entropy_matches_jax(packed):
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 30, 17).astype(np.float32) * 3
    tokens = rng.randint(0, 17, (2, 30)).astype(np.int32)
    seg = _packed_ids(2, 30) if packed else None
    want = jax_ce(jnp.asarray(logits), jnp.asarray(tokens),
                  None if seg is None else jnp.asarray(seg))
    got = lm_cross_entropy(torch.from_numpy(logits), torch.from_numpy(tokens),
                           None if seg is None else torch.from_numpy(seg))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_one_batch_grads_match_jax(family):
    _, tcfg, flax_model, params, model = _pair(family)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 128, (2, 32)).astype(np.int32)
    seg = _packed_ids(2, 32)

    def loss(p):
        logits = flax_model.apply(p, jnp.asarray(tokens), jnp.asarray(seg))
        return jax_ce(logits, jnp.asarray(tokens), jnp.asarray(seg))

    want_loss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    want = from_flax_params(family, tcfg, jax.tree.map(np.asarray, jgrads))
    t_tokens, t_seg = torch.from_numpy(tokens), torch.from_numpy(seg)
    got_loss = lm_cross_entropy(model(t_tokens, t_seg), t_tokens, t_seg)
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)


def test_train_trajectory_matches_jax():
    """4 steps of AdamW from the same weights on the same batches, the
    flash attention function on both sides (llama: GQA, RoPE)."""
    jcfg, tcfg, flax_model, params, model = _pair("llama", flash=True)
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    j_init, j_step, j_shard = jax_make_train_step(flax_model, jcfg, mesh)
    # Placed as the step's outputs are, so the second step reuses the
    # first step's compile instead of compiling again.
    j_state = jax.device_put(j_init(jax.tree.map(jnp.asarray, params)),
                             NamedSharding(mesh, P()))
    init_state, train_step, shard_batch = make_train_step(model, tcfg,
                                                          device="cpu")
    state = init_state(model)
    before = dict(launches)
    rng = np.random.RandomState(2)
    for i in range(4):
        tokens = rng.randint(0, 128, (2, 32)).astype(np.int32)
        seg = _packed_ids(2, 32) if i == 2 else None
        j_args = () if seg is None else (jnp.asarray(seg),)
        j_state, want = j_step(j_state, j_shard(jnp.asarray(tokens)), *j_args)
        t_args = () if seg is None else (torch.from_numpy(seg),)
        state, got = train_step(state, shard_batch(tokens), *t_args)
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5, err_msg=f"step {i} {key}")
        assert float(got["aux"]) == 0.0
    assert state["step"] == 4
    assert launches == before


def test_deferred_init_to_first_step_on_cpu():
    """The main path on the CPU: fakes → materialize → init_state → steps,
    through the flash attention function's plain versions."""
    cfg = TINY
    model = deferred_init(make_llama, cfg, attn_fn=make_flash_attention(),
                          device="cpu")
    assert all(is_fake(p) for p in model.parameters())
    init_state, train_step, shard_batch = make_train_step(model, cfg,
                                                          device="cpu")
    with pytest.raises(ValueError, match="materialize"):
        init_state(model)
    torch.manual_seed(0)
    materialize_module(model, device="cpu")
    state = init_state(model)
    before = dict(launches)
    batch = shard_batch(np.random.RandomState(3).randint(0, cfg.vocab_size,
                                                         (2, 16)))
    assert batch.dtype == torch.int64 and batch.device.type == "cpu"
    losses = []
    for _ in range(3):
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
        assert np.isfinite(float(metrics["grad_norm"]))
    assert losses[2] < losses[0]
    assert launches == before  # no kernel on the CPU
    flops = train_step_flops(model, cfg, 2, 16)
    n = sum(p.numel() for n_, p in model.named_parameters()
            if n_.endswith("weight") and "norm" not in n_ and "embed" not in n_)
    assert flops == 6 * n * 32 + 6 * cfg.n_layers * 2 * cfg.n_heads * 16 ** 2 \
        * cfg.head_size
