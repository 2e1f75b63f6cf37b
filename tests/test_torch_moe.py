"""The port's mixture of experts (``MoEMLP``, ``make_mixtral``) held
against the JAX package's flax modules on identical weights (numpy from a
seed, carried across by ``from_flax_params``).

* ``MoEMLP`` output and load-balancing loss, float32 within 1e-5 and
  bfloat16 compute within 3e-2;
* a drop case: the router skewed so that one expert overflows its
  capacity; the same (token, choice) pairs are dropped (the port's
  ``kept`` against a numpy evaluation of the JAX formula) and the outputs
  agree;
* ``tiny-moe`` logits, and the gradients of ``ce + aux`` against
  ``jax.grad``, within 1e-5; ``make_train_step`` on it, its FLOPs by
  ``train_step_flops`` within 1 % of a ``FlopCounterMode`` count;
* the expert weights' initial std within 2 % of flax's (fan_in E·d).

``decoder_lm_plan`` with ``ep``, the keyed values' mesh invariance and
serving's refusal of MoE configs: ``test_torch_moe_plan.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistx_tpu.models import PRESETS as JAX_PRESETS
from torchdistx_tpu.models import make_mixtral as jax_make_mixtral
from torchdistx_tpu.models.layers import MoEMLP as JaxMoEMLP
from torchdistx_tpu.parallel.pipeline import _sum_aux
from torchdistx_tpu.parallel.train import lm_cross_entropy as jax_ce
from torchdistx_tpu_torch.models import PRESETS, from_flax_params, make_mixtral
from torchdistx_tpu_torch.models.layers import MoEMLP, router_aux_loss
from torchdistx_tpu_torch.parallel import make_train_step
from torchdistx_tpu_torch.parallel.train import lm_cross_entropy

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

F32_TOL, BF16_TOL = 1e-5, 3e-2
CFG, JCFG = PRESETS["tiny-moe"], JAX_PRESETS["tiny-moe"]
B, S = 2, 16


def _moe_pair(dtype, seed=0, skew=None):
    """(flax MoEMLP, its params as numpy, the port's MoEMLP on them, x)."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jmod = JaxMoEMLP(JCFG.replace(dtype=jdt))
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, CFG.d_model).astype(np.float32)
    params = jax.tree.map(np.asarray, jax.jit(jmod.init)(
        jax.random.PRNGKey(seed), jnp.asarray(x, jdt)))
    if skew is not None:
        x, params = skew(x, params)
    mod = MoEMLP(CFG.replace(dtype=dtype), device="cpu")
    p = params["params"]
    mod.load_state_dict({"router.weight": torch.tensor(p["router"]["kernel"].T),
                         **{w: torch.tensor(p[w]) for w in
                            ("w_gate", "w_up", "w_down")}})
    return jmod, params, mod, x


def _run_jax(jmod, params, x, jdt):
    out, state = jax.jit(functools.partial(jmod.apply, mutable=["losses"]))(
        params, jnp.asarray(x, jdt))
    return np.asarray(out.astype(jnp.float32)), float(_sum_aux(state["losses"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_moe_mlp_matches_flax(dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jmod, params, mod, x = _moe_pair(dtype)
    want, want_aux = _run_jax(jmod, params, x, jdt)
    with torch.no_grad():
        got = mod(torch.from_numpy(x).to(dtype)).float().numpy()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_allclose(float(mod.aux), want_aux, rtol=tol)


def _skew(x, params):
    """Every token leans on one direction the router maps to expert 0:
    expert 0 is every token's first choice, far past its capacity."""
    u = np.random.RandomState(7).randn(x.shape[-1]).astype(np.float32)
    u /= np.linalg.norm(u)
    x = x + 3.0 * u
    kernel = params["params"]["router"]["kernel"].copy()
    kernel[:, 0] += 4.0 * u
    params["params"]["router"]["kernel"] = kernel
    return x, params


def _kept_reference(x, kernel, E, k):
    """The JAX MoEMLP's keep mask, evaluated in numpy (float64 router)."""
    T = x.shape[0] * x.shape[1]
    logits = x.reshape(T, -1).astype(np.float64) @ kernel.astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    onehot = np.eye(E, dtype=np.int64)[idx]  # [T, k, E]
    pos = ((np.cumsum(onehot.reshape(T * k, E), 0) - 1).reshape(T, k, E)
           * onehot).sum(-1)
    capacity = max(1, int(np.ceil(T * k / E * 1.25)))
    return pos < capacity


def test_drop_case_drops_the_same_tokens():
    jmod, params, mod, x = _moe_pair(torch.float32, skew=_skew)
    want, want_aux = _run_jax(jmod, params, x, jnp.float32)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    want_kept = _kept_reference(x, params["params"]["router"]["kernel"],
                                CFG.moe.n_experts, CFG.moe.top_k)
    assert (~want_kept).sum() >= 8  # the case is a real overflow
    np.testing.assert_array_equal(mod.kept.numpy(), want_kept)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(float(mod.aux), want_aux, rtol=F32_TOL)


def _tiny_pair(seed=0):
    jmodel = jax_make_mixtral(JCFG)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32)))
    model = make_mixtral(CFG, device="cpu")
    model.load_state_dict(from_flax_params("llama", CFG, params))
    return jmodel, params, model


def test_tiny_moe_logits_and_grads_match_jax():
    jmodel, params, model = _tiny_pair()
    tokens = np.random.RandomState(3).randint(0, CFG.vocab_size, (B, S))

    def loss_fn(p):
        logits, state = jmodel.apply(p, jnp.asarray(tokens), mutable=["losses"])
        aux = _sum_aux(state["losses"])
        return jax_ce(logits, jnp.asarray(tokens)) + aux, (logits, aux)

    (want_loss, (want_logits, want_aux)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    t = torch.from_numpy(tokens).long()
    logits = model(t)
    aux = router_aux_loss(model)
    loss = lm_cross_entropy(logits, t) + aux
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=F32_TOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=F32_TOL)
    want_grads = from_flax_params("llama", CFG, jax.tree.map(np.asarray, grads))
    got_grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(got_grads) == set(want_grads)
    for name, g in got_grads.items():
        w = want_grads[name]
        err = float((g - w).norm() / w.norm().clamp_min(1e-30))
        assert err <= F32_TOL, (name, err)


def test_train_step_flops_counts_the_moe_step():
    """``train_step_flops`` of a MoE model (expert products over E·C rows,
    dispatch and combine einsums, the one-hot products, the router)
    within 1 % of what ``FlopCounterMode`` counts in one step, on the
    flash attention's FLOP formulas."""
    from torchdistx_tpu_torch.observe.costmodel import program_costs
    from torchdistx_tpu_torch.ops import make_flash_attention
    from torchdistx_tpu_torch.parallel.train import train_step_flops

    cfg = CFG.replace(d_model=128, d_ff=256, n_heads=4, n_kv_heads=2)
    torch.manual_seed(0)
    model = make_mixtral(cfg, attn_fn=make_flash_attention(), device="cpu")
    init_state, train_step, shard_batch = make_train_step(model, cfg,
                                                          device="cpu")
    tokens = shard_batch(np.random.RandomState(6).randint(
        0, cfg.vocab_size, (2, 64)))
    _, costs = program_costs(train_step, init_state(model), tokens)
    want = train_step_flops(model, cfg, 2, 64)
    assert abs(costs["flops"] / want - 1) <= 0.01, (costs["flops"], want)


def test_tiny_moe_train_step_reports_aux():
    """``make_train_step`` takes a MoE config: ``loss = ce + aux``."""
    _, _, model = _tiny_pair()
    init_state, train_step, shard_batch = make_train_step(model, CFG,
                                                          device="cpu")
    state = init_state(model)
    tokens = np.random.RandomState(4).randint(0, CFG.vocab_size, (B, S))
    _, metrics = train_step(state, shard_batch(tokens))
    assert float(metrics["aux"]) > 0
    assert float(metrics["loss"]) == pytest.approx(
        float(metrics["ce"]) + float(metrics["aux"]), rel=1e-6)


@pytest.mark.parametrize("w", ["w_gate", "w_up", "w_down"])
def test_expert_init_std_matches_flax(w):
    """flax's lecun_normal takes fan_in = E * in on an [E, in, out]
    kernel; the port draws the same distribution."""
    cfg = CFG.replace(d_model=128, d_ff=256)
    params = JaxMoEMLP(JCFG.replace(d_model=128, d_ff=256)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 128), jnp.float32))
    want = float(np.asarray(params["params"][w]).std())
    torch.manual_seed(0)
    got = float(getattr(MoEMLP(cfg, device="cpu"), w).std())
    E, n_in = getattr(MoEMLP(cfg, device="meta"), w).shape[:2]
    assert abs(got / want - 1) <= 0.02, (got, want)
    assert abs(got * np.sqrt(E * n_in) - 1) <= 0.02
