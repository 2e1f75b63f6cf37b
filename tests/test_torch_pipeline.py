"""The port's pipeline schedules held against the JAX package.

Two spawns of gloo CPU ranks, started together (a file rendezvous under a
temporary directory), run every case and write what each rank saw; the
references run in the pytest process while the ranks work.  The flax
weights are numpy normals from a seed, in the tree ``jax.eval_shape``
gives.  float32,
TINY shapes, 4 (or 8) microbatches of a [8, 16] batch:

* against the JAX package, on the same flax weights (numpy, then
  ``from_flax_params``) over ``{pp: 2}``:
  - a 4-layer llama's loss and gradients under GPipe, flat 1F1B and
    interleaved 1F1B (2 chunks a stage) against ``jax.value_and_grad``
    of the dense ``lm_cross_entropy(model.apply)``: loss within 1e-6
    relative, every gradient within 1e-5 (``tests/test_parallel.py``
    ``test_1f1b_grads_match_dense``);
  - GPT-2's tied head under 1F1B: the ``wte`` gradient summed over the
    first stage's embed and the last stage's head;
  - Mixtral's router loss and packed segment ids under 1F1B against the
    microbatched dense oracle (``test_1f1b_moe_packed_matches_microbatched``);
  - ViT's ``pipelined_decoder_apply`` against the JAX ViT forward within
    1e-4 (``tests/test_vit.py``);
  - the JAX ``make_train_step(pipeline=True, pipeline_schedule="1f1b")``
    on ``make_mesh({"pp": 2})`` of 2 of the 8 virtual CPU devices: a
    3-step AdamW trajectory within 1e-5, the port's step given an
    ``attn_fn`` that its stage's blocks run for the step only;
* against the port's unsharded step (``mesh=None``) from the same keyed
  values, each rank materializing only its stage's layers: ``{pp: 2,
  dp: 2}`` with packed segment ids and ``{pp: 4}`` (8 layers, stages
  that both receive and send), every schedule, 3 AdamW steps, losses
  and gradient norms within 1e-5 and equal on every rank, and the
  instrumented step's counted FLOPs equal to the unsharded step's.

No JAX at module level: the spawned ranks import this module.
"""

import functools
import json
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torchdistx_tpu_torch import deferred_init
from torchdistx_tpu_torch.cuda_bridge import bind_values, materialize_module_cuda
from torchdistx_tpu_torch.models import (
    TINY,
    TINY_GPT2,
    TINY_MOE,
    TINY_VIT,
    from_flax_params,
    make_gpt2,
    make_llama,
    make_mixtral,
    make_vit,
)
from torchdistx_tpu_torch.models.layers import default_attention
from torchdistx_tpu_torch.models.plans import decoder_lm_plan
from torchdistx_tpu_torch.parallel import make_mesh, make_train_step
from torchdistx_tpu_torch.parallel.pipeline import (
    FUSED,
    pipeline_plan_overrides,
    pipelined_decoder_apply,
)

torch.set_num_threads(2)

B, S, N_MB, STEPS = 8, 16, 4, 3
LLAMA = TINY.replace(n_layers=4)
DEEP = TINY.replace(n_layers=8)
SCHEDULES = ("gpipe", "1f1b", "interleaved")
LOSS_RTOL, GRAD_ATOL, TRAJ_RTOL, VIT_ATOL = 1e-6, 1e-5, 1e-5, 1e-4
KEYED = {"pp2-dp2": ({"pp": 2, "dp": 2}, LLAMA, True),
         "pp4": ({"pp": 4}, DEEP, False)}


def _tokens(seed: int, vocab: int, shape=(B, S)) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, vocab, shape)


def _packed() -> np.ndarray:
    """[B, S] ids, packed differently per row (a boundary at 2 + row)."""
    return (np.arange(S)[None, :] >= np.arange(2, 2 + B)[:, None]).astype(
        np.int64)


def _images() -> np.ndarray:
    return np.random.RandomState(4).randn(
        4, TINY_VIT.image_size, TINY_VIT.image_size,
        TINY_VIT.channels).astype(np.float32)


def _tree(npz: str) -> dict:
    tree: dict = {}
    for key, leaf in np.load(npz).items():
        node = tree
        *parents, last = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def _loaded(family, make, cfg, npz):
    model = make(cfg, device="cpu")
    model.load_state_dict(from_flax_params(family, cfg, _tree(npz)))
    return model


def _grads(model) -> dict:
    """This stage's gradients (the other stages' layers have none)."""
    return {n: p.grad.tolist() for n, p in model.named_parameters()
            if p.grad is not None}


def _fused(sched, model, cfg, tokens, mesh, seg=None):
    kw = {"n_chunks": 2} if sched == "interleaved" else {}
    m = FUSED[sched](cfg, model, torch.from_numpy(tokens), mesh,
                     n_microbatches=N_MB,
                     segment_ids=None if seg is None else torch.from_numpy(seg),
                     **kw)
    return {k: float(v) for k, v in m.items()}, _grads(model)


def _trajectory(model, cfg, mesh, seg=None, telemetry=False, **kw):
    from torchdistx_tpu_torch import observe

    observe.enable(telemetry)
    try:
        init_state, train_step, shard_batch = make_train_step(
            model, cfg, device="cpu", mesh=mesh, n_microbatches=N_MB, **kw)
        state = init_state(model)
        losses, norms = [], []
        for step in range(STEPS):
            args = () if seg is None else (shard_batch(seg),)
            state, metrics = train_step(
                state, shard_batch(_tokens(10 + step, cfg.vocab_size)), *args)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        flops = None
        if telemetry:
            flops = [e["args"]["flops_counted"]
                     for e in observe.tracer().drain()
                     if e["ph"] == "X" and e["name"] == "train.step"
                     and "flops_counted" in e["args"]][0]
    finally:
        observe.enable(False)
    return {"losses": losses, "norms": norms, "flops": flops}


def _pp2_rank(tmp: str) -> dict:
    """Every {pp: 2} case on this rank."""
    mesh = make_mesh({"pp": 2}, device_type="cpu")
    toks = _tokens(1, LLAMA.vocab_size)
    out = {}
    for sched in SCHEDULES:
        model = _loaded("llama", make_llama, LLAMA, f"{tmp}/llama.npz")
        out[sched] = _fused(sched, model, LLAMA, toks, mesh)
    model = _loaded("gpt2", make_gpt2, TINY_GPT2, f"{tmp}/gpt2.npz")
    out["gpt2"] = _fused("1f1b", model, TINY_GPT2, toks, mesh)
    model = _loaded("llama", make_mixtral, TINY_MOE, f"{tmp}/moe.npz")
    out["moe"] = _fused("1f1b", model, TINY_MOE, toks, mesh, seg=_packed())
    vit = make_vit(TINY_VIT, device="cpu")
    vit.load_state_dict(from_flax_params("vit", TINY_VIT,
                                         _tree(f"{tmp}/vit.npz")))
    out["vit"] = pipelined_decoder_apply(
        TINY_VIT.encoder, vit, torch.from_numpy(_images()), mesh,
        n_microbatches=N_MB).tolist()
    model = _loaded("llama", make_llama, LLAMA, f"{tmp}/llama.npz")
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return default_attention(*args, **kw)

    out["train"] = _trajectory(model, LLAMA, mesh, pipeline=True,
                               pipeline_schedule="1f1b", attn_fn=counted)
    out["train"]["attn_fn_calls"] = len(calls)
    out["train"]["attn_fn_kept"] = all(
        b.attn.attn_fn is default_attention for b in model.blocks)
    return out


def _keyed_model(cfg, mesh, sched):
    """This stage's keyed values only (the other layers stay fake)."""
    model = deferred_init(make_llama, cfg, device="cpu")
    plan = pipeline_plan_overrides(
        decoder_lm_plan(cfg), cfg.n_layers,
        n_chunks=2 if sched == "interleaved" else 1)
    bind_values(model, materialize_module_cuda(model, mesh=mesh, plan=plan),
                strict=False)
    return model


def _keyed_rank(tmp: str) -> dict:
    out = {}
    for name, (axes, cfg, packed) in KEYED.items():
        mesh = make_mesh(axes, device_type="cpu")
        for sched in SCHEDULES:
            out[f"{name}-{sched}"] = _trajectory(
                _keyed_model(cfg, mesh, sched), cfg, mesh,
                _packed() if packed else None, telemetry=sched == "1f1b",
                pipeline=True, pipeline_schedule=sched)
    return out


def _rank(rank: int, world: int, tmp: str, func: str) -> None:
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv-{func}",
                            rank=rank, world_size=world)
    warnings.simplefilter("ignore")  # absent axes of the plans
    try:
        out = globals()[func](tmp)
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/{func}-{rank}.json", "w") as f:
        json.dump(out, f)


# -- the JAX side (the pytest process) ------------------------------------


def _flat(params) -> dict:
    from jax.tree_util import tree_flatten_with_path

    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in tree_flatten_with_path(params)[0]}


def _numpy_weights(shapes, seed: int) -> dict:
    """Weights for a flax parameter tree of ``shapes`` from a numpy seed:
    norm scales near 1, everything else small normals."""
    import jax

    rng = np.random.RandomState(seed)

    def leaf(path, sd):
        name = str(getattr(path[-1], "key", path[-1]))
        x = rng.standard_normal(sd.shape).astype(np.float32) * 0.02
        return x + 1.0 if name == "scale" else x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _flax(family: str):
    """(flax model, f32 weights as numpy).  The tree's shapes come from
    ``jax.eval_shape`` (traced, not compiled)."""
    import jax
    import jax.numpy as jnp

    from torchdistx_tpu.models import PRESETS as JAX_PRESETS
    from torchdistx_tpu.models import make_gpt2 as jax_make_gpt2
    from torchdistx_tpu.models import make_llama as jax_make_llama
    from torchdistx_tpu.models import make_mixtral as jax_make_mixtral
    from torchdistx_tpu.models.vit import make_vit as jax_make_vit

    if family == "vit":
        model = jax_make_vit(JAX_PRESETS["tiny-vit"])
        x = jnp.asarray(_images())
    else:
        cfg = {"llama": JAX_PRESETS["tiny"].replace(n_layers=4),
               "gpt2": JAX_PRESETS["tiny-gpt2"],
               "moe": JAX_PRESETS["tiny-moe"]}[family]
        make = {"llama": jax_make_llama, "gpt2": jax_make_gpt2,
                "moe": jax_make_mixtral}[family]
        model = make(cfg)
        x = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    return model, _numpy_weights(shapes, seed=len(family))


def _jax_dense(family: str):
    """(loss, {port name: gradient}) of the dense flax model on the
    microbatched loss: the CE in sum form over the global valid count,
    plus the router loss averaged over the microbatches."""
    import jax
    import jax.numpy as jnp

    from torchdistx_tpu.parallel.pipeline import _sum_aux

    model, params = _flax(family)
    toks = jnp.asarray(_tokens(1, 256))
    seg = jnp.asarray(_packed()) if family == "moe" else None

    toks_mb = toks.reshape(N_MB, B // N_MB, S)
    seg_mb = None if seg is None else seg.reshape(N_MB, B // N_MB, S)

    def microbatch(p, t, sg):
        """One microbatch: (summed valid NLL, valid count, router loss)."""
        if sg is None:
            logits, mv = model.apply(p, t, mutable=["losses"])
            valid = jnp.ones((t.shape[0], S - 1))
        else:
            logits, mv = model.apply(p, t, segment_ids=sg, mutable=["losses"])
            valid = jnp.logical_and(sg[:, :-1] == sg[:, 1:], sg[:, 1:] >= 0)
        lp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32))
        ll = jnp.take_along_axis(lp, t[:, 1:][..., None], -1)[..., 0]
        return (-jnp.sum(ll * valid), jnp.sum(valid),
                _sum_aux(mv.get("losses", {})))

    def loss(p):
        # One traced model over the microbatches: each routes on its own.
        nll, valid, aux = jax.vmap(microbatch, in_axes=(None, 0, 0))(
            p, toks_mb, seg_mb)
        return nll.sum() / valid.sum() + aux.sum() / N_MB

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    cfg = {"llama": LLAMA, "gpt2": TINY_GPT2, "moe": TINY_MOE}[family]
    port_family = "gpt2" if family == "gpt2" else "llama"
    return float(value), from_flax_params(port_family, cfg,
                                          jax.tree.map(np.asarray, grads))


def _jax_vit_logits() -> np.ndarray:
    import jax
    import jax.numpy as jnp

    model, params = _flax("vit")
    return np.asarray(jax.jit(model.apply)(params, jnp.asarray(_images())))


def _jax_pipeline_losses() -> list:
    """The JAX 1F1B pipelined step over {pp: 2} of 2 virtual devices."""
    import jax
    import jax.numpy as jnp

    from torchdistx_tpu.models import PRESETS as JAX_PRESETS
    from torchdistx_tpu.parallel import make_mesh as jax_make_mesh
    from torchdistx_tpu.parallel.train import make_train_step as jax_step

    model, params = _flax("llama")
    mesh = jax_make_mesh({"pp": 2}, devices=jax.devices()[:2])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no data axis: replicated batch
        init_state, train_step, shard_batch = jax_step(
            model, JAX_PRESETS["tiny"].replace(n_layers=4), mesh,
            pipeline=True, pipeline_schedule="1f1b", n_microbatches=N_MB)
    state = init_state(jax.tree.map(jnp.asarray, params))
    losses = []
    for step in range(STEPS):
        state, metrics = train_step(
            state, shard_batch(jnp.asarray(_tokens(10 + step, 256))))
        losses.append(float(metrics["loss"]))
    return losses


def _unsharded(name: str) -> dict:
    """The ``mesh=None`` trajectory from the keyed unsharded values."""
    _, cfg, packed = KEYED[name]
    model = deferred_init(make_llama, cfg, device="cpu")
    bind_values(model, materialize_module_cuda(model, device="cpu"))
    return _trajectory(model, cfg, None, _packed() if packed else None,
                       telemetry=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results from both spawns, started together, and the
    JAX references computed while the ranks run."""
    tmp = tmp_path_factory.mktemp("pipeline")
    for family in ("llama", "gpt2", "moe", "vit"):
        np.savez(tmp / f"{family}.npz", **_flat(_flax(family)[1]))
    spawns = {name: mp.start_processes(_rank, args=(world, str(tmp), func),
                                       nprocs=world, join=False,
                                       start_method="spawn")
              for name, func, world in (("pp2", "_pp2_rank", 2),
                                        ("keyed", "_keyed_rank", 4))}
    try:
        refs = {f: _jax_dense(f) for f in ("llama", "gpt2", "moe")}
        refs["vit"] = _jax_vit_logits()
        refs["train"] = _jax_pipeline_losses()
        refs["unsharded"] = {name: _unsharded(name) for name in KEYED}
    finally:
        for ctx in spawns.values():
            while not ctx.join():
                pass
    out = {name: [json.loads((tmp / f"{func}-{r}.json").read_text())
                  for r in range(world)]
           for name, func, world in (("pp2", "_pp2_rank", 2),
                                     ("keyed", "_keyed_rank", 4))}
    out["jax"] = refs
    return out


def _check_grads(out, want_loss, want_grads, what):
    """Loss and this stage's gradients against the dense reference; the
    stages' gradients together cover every parameter."""
    metrics, grads = out
    np.testing.assert_allclose(metrics["loss"], want_loss, rtol=LOSS_RTOL,
                               err_msg=what)
    for name, g in grads.items():
        np.testing.assert_allclose(np.asarray(g), want_grads[name].numpy(),
                                   atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"{what} {name}")
    return set(grads)


@pytest.mark.parametrize("sched", SCHEDULES)
def test_grads_match_jax_dense(runs, sched):
    loss, grads = runs["jax"]["llama"]
    seen = set()
    for out in runs["pp2"]:
        seen |= _check_grads(out[sched], loss, grads, sched)
    assert seen == set(grads)


def test_gpt2_tied_head_matches_jax(runs):
    """The tied table's gradient: the first stage's embed and the last
    stage's head, summed over pp."""
    loss, grads = runs["jax"]["gpt2"]
    seen = set()
    for out in runs["pp2"]:
        seen |= _check_grads(out["gpt2"], loss, grads, "gpt2")
    assert "wte.weight" in seen and seen == set(grads)


def test_moe_aux_and_packed_segments_match_jax(runs):
    """Mixtral's router loss rides the schedule (each microbatch's with
    weight 1/n_mb) and the packed batch's CE is over the global count of
    valid targets."""
    loss, grads = runs["jax"]["moe"]
    seen = set()
    for out in runs["pp2"]:
        assert out["moe"][0]["aux"] > 0.0
        seen |= _check_grads(out["moe"], loss, grads, "moe")
    assert seen == set(grads)


def test_vit_pipelined_forward_matches_jax(runs):
    want = runs["jax"]["vit"]
    for out in runs["pp2"]:
        np.testing.assert_allclose(np.asarray(out["vit"]), want,
                                   atol=VIT_ATOL, rtol=0)


def test_train_step_matches_jax_pipeline(runs):
    """``make_train_step(pipeline=True, pipeline_schedule="1f1b")`` on both
    sides: the 3-step AdamW loss trajectory."""
    for out in runs["pp2"]:
        np.testing.assert_allclose(out["train"]["losses"], runs["jax"]["train"],
                                   rtol=TRAJ_RTOL)


def test_attn_fn_is_per_step(runs):
    """``make_train_step(attn_fn=)`` sets the stage's attention for each
    step (its 2 layers x 4 microbatches x 3 steps) and gives the blocks
    their own back: the model's forward, and a later step built without
    ``attn_fn``, attend as the model's constructor said."""
    for out in runs["pp2"]:
        assert out["train"]["attn_fn_calls"] == 2 * N_MB * STEPS
        assert out["train"]["attn_fn_kept"]


def test_keyed_stages_match_unsharded(runs):
    """Each rank materializes only its stage's layers; over {pp: 2, dp: 2}
    (packed) and {pp: 4} every schedule's losses and gradient norms are
    global (equal on every rank) and within 1e-5 of ``mesh=None`` on the
    same keyed values, and the counted FLOPs are the unsharded step's."""
    for name in KEYED:
        want = runs["jax"]["unsharded"][name]
        for sched in SCHEDULES:
            key = f"{name}-{sched}"
            first = runs["keyed"][0][key]
            for out in runs["keyed"][1:]:
                assert out[key] == first, key
            np.testing.assert_allclose(first["losses"], want["losses"],
                                       rtol=TRAJ_RTOL, err_msg=key)
            np.testing.assert_allclose(first["norms"], want["norms"],
                                       rtol=TRAJ_RTOL, err_msg=key)
            if sched == "1f1b":
                assert first["flops"] == want["flops"], key
