"""The port's GPT-2 and Llama models held against the JAX package's flax
models on identical float32 weights (carried across by
``from_flax_params``), and the port's decode decomposition (prefill +
paged decode) against its own full forward.

Tolerance: atol 1e-4 on f32 logits — the same math in both frameworks,
summed in a different order (XLA's CPU dots vs torch's), over a few
layers at narrow widths.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torchdistx_tpu.models import TransformerConfig as JaxConfig
from torchdistx_tpu.models import make_gpt2, make_llama
from torchdistx_tpu.models.layers import apply_rope as jax_apply_rope
from torchdistx_tpu.models.layers import default_attention as jax_attention
from torchdistx_tpu.models.layers import rope_frequencies as jax_rope
from torchdistx_tpu_torch.models import TransformerConfig, from_flax_params
from torchdistx_tpu_torch.models.layers import (
    apply_rope,
    default_attention,
    rope_frequencies,
)
from torchdistx_tpu_torch.serve.kv_cache import KVCacheConfig, init_pools
from torchdistx_tpu_torch.serve.programs import (
    build_decode_fn,
    build_prefill_fn,
    make_model,
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
ATOL = 1e-4


def configs(family):
    return (JaxConfig(dtype=jnp.float32, **SHAPES[family]),
            TransformerConfig(dtype=torch.float32, **SHAPES[family]))


def port_model_from_flax(family, seed=0):
    """(flax model, flax params, port model) on identical f32 weights."""
    jcfg, tcfg = configs(family)
    flax_model = (make_llama if family == "llama" else make_gpt2)(jcfg)
    params = jax.jit(flax_model.init)(jax.random.PRNGKey(seed),
                                      jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, params)
    model = make_model(family, tcfg, device="cpu")
    model.load_state_dict(from_flax_params(family, tcfg, params))
    return flax_model, params, model.eval()


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_forward_matches_flax(family):
    flax_model, params, model = port_model_from_flax(family)
    tokens = np.random.RandomState(0).randint(0, 128, (2, 11)).astype(np.int32)
    want = np.asarray(jax.jit(flax_model.apply)(params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long()).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_from_flax_params_covers_state_dict(family):
    """Every port parameter comes from the flax tree and nothing is left
    over; a tied model has no head weight of its own."""
    _, params, model = port_model_from_flax(family)
    sd = from_flax_params(family, model.cfg, params)
    assert set(sd) == set(model.state_dict())
    flax_leaves = len(jax.tree.leaves(params))
    per_layer = len(jax.tree.leaves(params["params"]["blocks"]))
    assert len(sd) == flax_leaves - per_layer + per_layer * model.cfg.n_layers
    assert (model.lm_head is None) == (family == "gpt2")


def test_attention_rope_match_jax():
    """The building blocks' conventions: GQA attention with a segment
    mask, and RoPE on split halves."""
    rng = np.random.RandomState(1)
    B, S, H, KV, D = 2, 9, 4, 2, 8
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, KV, D).astype(np.float32)
    v = rng.randn(B, S, KV, D).astype(np.float32)
    seg = (np.arange(S)[None] < np.array([[9], [5]])).astype(np.int32)
    got = default_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=True,
                            segment_ids=torch.from_numpy(seg))
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, segment_ids=jnp.asarray(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    ang = rope_frequencies(D, 64, 500000.0)
    np.testing.assert_allclose(ang.numpy(), np.asarray(jax_rope(D, 64, 500000.0)),
                               rtol=1e-6, atol=1e-4)
    pos = rng.randint(0, 64, (B, S))
    got = apply_rope(torch.from_numpy(q), ang[torch.from_numpy(pos)])
    want = jax_apply_rope(jnp.asarray(q), jax_rope(D, 64, 500000.0)[pos])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_decode_decomposition_matches_full_forward(family):
    """Prefill a prompt into the paged pool, then decode token by token:
    every step's logits equal the full forward's at that position."""
    _, _, model = port_model_from_flax(family)
    cfg = model.cfg
    page, maxp = 4, 6
    kv = KVCacheConfig(n_layers=cfg.n_layers, kv_heads=cfg.kv_heads,
                       head_dim=cfg.head_size, page_size=page, n_pages=9)
    kp, vp = init_pools(kv, cfg.dtype, "cpu")
    seq = np.random.RandomState(2).randint(0, 128, 15).tolist()
    L = 7
    table = torch.tensor([[3, 5, 1, 8, 2, 7]], dtype=torch.int32)
    prefill, decode = build_prefill_fn(model), build_decode_fn(model)
    toks = torch.zeros(1, 8, dtype=torch.int32)  # bucket 8, one pad slot
    toks[0, :L] = torch.tensor(seq[:L])
    first = prefill(kp, vp, toks, torch.tensor([L], dtype=torch.int32), table)
    with torch.no_grad():
        full = model(torch.tensor([seq]))[0]
    np.testing.assert_allclose(first.numpy(), full[L - 1].numpy(), atol=ATOL)
    # Decode lane 1 with an idle lane 0 beside it (position 0, null row).
    tables = torch.cat([torch.zeros_like(table), table])
    for pos in range(L, len(seq)):
        logits = decode(kp, vp, torch.tensor([0, seq[pos]], dtype=torch.int32),
                        torch.tensor([0, pos], dtype=torch.int32), tables)
        np.testing.assert_allclose(logits[1].numpy(), full[pos].numpy(),
                                   atol=ATOL, err_msg=f"position {pos}")
    assert maxp * page >= len(seq)


def test_moe_config_is_refused():
    _, cfg = configs("llama")
    with pytest.raises(NotImplementedError):
        make_model("llama", cfg.replace(moe=object()), device="cpu")
