"""Pipelines combined with the other mesh axes, held against the JAX
package's pipelined step on the same mesh.

One spawn of 8 gloo CPU ranks (a file rendezvous under a temporary
directory) runs every case and writes what each rank saw; the JAX
references run in the pytest process on the 8 virtual CPU devices of
``tests/conftest.py`` meanwhile, each from one jitted step.  float32,
TINY shapes, a [8, 16] batch in 4 microbatches; the flax weights are the
JAX model's own init (``jax.jit(model.init)``, so the router is decisive
and no routing decision sits on a rounding), carried across with
``from_flax_params`` and placed as the keyed materializer places a
stage's values (the stage's layers on the mesh of the other axes, the
entries every stage holds on the whole mesh):

* llama over ``{pp 2, dp 2, tp 2}`` under GPipe and 1F1B: the 3-step
  AdamW loss trajectory within 1e-5 of the JAX ``make_train_step(
  pipeline=True)`` on ``make_mesh({"pp": 2, "dp": 2, "tp": 2})``;
* Mixtral (``TINY_MOE``) over ``{pp 2, ep 2, dp 2}`` under 1F1B, the
  batch over ``dp``: the 4-step trajectory of the loss and the router
  loss within 1e-5 of the JAX run on the same mesh
  (``tests/test_parallel.py::test_moe_aux_accumulates_across_steps``,
  held exactly): each data shard's microbatch is its share of the
  global microbatch, whose routing (capacity, slots, router loss) is
  global over ``dp``;
* the same mesh with packed segment ids: one 1F1B step's gradients
  (this rank's shards: its stage's layers, its experts over ``ep``)
  within 1e-5 of the JAX ``pipeline_train_1f1b``'s
  (``test_1f1b_moe_packed_matches_microbatched``).

Every rank reports the same losses.  No JAX at module level: the
spawned ranks import this module.
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
from torchdistx_tpu_torch.cuda_bridge import bind_values
from torchdistx_tpu_torch.models import (
    TINY,
    TINY_MOE,
    from_flax_params,
    make_llama,
    make_mixtral,
)
from torchdistx_tpu_torch.models.plans import decoder_lm_plan
from torchdistx_tpu_torch.parallel import (
    local_shard,
    make_mesh,
    make_train_step,
    placements_for,
)
from torchdistx_tpu_torch.parallel.pipeline import pipeline_plan_overrides
from torchdistx_tpu_torch.parallel.sharding import mesh_shape

torch.set_num_threads(2)

WORLD, B, S, N_MB = 8, 8, 16, 4
LLAMA_STEPS, MOE_STEPS = 3, 4
RTOL, GRAD_ATOL = 1e-5, 1e-5
TP_MESH = {"pp": 2, "dp": 2, "tp": 2}
EP_MESH = {"pp": 2, "ep": 2, "dp": 2}
FAMILIES = {"llama": (make_llama, TINY), "moe": (make_mixtral, TINY_MOE)}


def _tokens(seed: int, vocab: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, vocab, (B, S))


def _packed() -> np.ndarray:
    """[B, S] ids, packed differently per row (a boundary at 2 + row)."""
    return (np.arange(S)[None, :] >= np.arange(2, 2 + B)[:, None]).astype(
        np.int64)


def _tree(npz: str) -> dict:
    tree: dict = {}
    for key, leaf in np.load(npz).items():
        node = tree
        *parents, last = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def _stage_model(family: str, mesh, npz: str):
    """The flax weights, this stage's part placed on ``mesh`` as
    ``materialize_module_cuda(plan=pipeline_plan_overrides(...))`` places
    keyed values; the other stages' layers stay fake."""
    from torch.distributed.tensor import DTensor

    make, cfg = FAMILIES[family]
    full = from_flax_params("llama", cfg, _tree(npz))
    plan = pipeline_plan_overrides(decoder_lm_plan(cfg), cfg.n_layers)
    names, shape = mesh.mesh_dim_names, mesh_shape(mesh)
    rest = tuple(a for a in names if a != "pp")
    stage_mesh = mesh[rest]
    stage = mesh.get_local_rank("pp")
    values = {}
    for name, t in full.items():
        owner = plan.stage_of(name, mesh)
        if owner not in (None, stage):
            continue
        spec = plan.spec_for(name, tuple(t.shape), mesh)
        local = local_shard(t, spec, shape, mesh.get_coordinate()).contiguous()
        on, pl = mesh, placements_for(spec, mesh)
        if owner is not None:
            on, pl = stage_mesh, [p for a, p in zip(names, pl) if a != "pp"]
        values[name] = DTensor.from_local(local, on, pl, run_check=False,
                                          shape=t.shape, stride=t.stride())
    model = deferred_init(make, cfg, device="cpu")
    bind_values(model, values, strict=False)
    return model, cfg


def _llama_rank(tmp: str) -> dict:
    mesh = make_mesh(TP_MESH, device_type="cpu")
    out = {}
    for sched in ("gpipe", "1f1b"):
        model, cfg = _stage_model("llama", mesh, f"{tmp}/llama.npz")
        init_state, train_step, shard_batch = make_train_step(
            model, cfg, device="cpu", mesh=mesh, pipeline=True,
            pipeline_schedule=sched, n_microbatches=N_MB)
        state = init_state(model)
        losses = []
        for step in range(LLAMA_STEPS):
            state, metrics = train_step(
                state, shard_batch(_tokens(10 + step, cfg.vocab_size)))
            losses.append(float(metrics["loss"]))
        out[sched] = losses
    return out


def _moe_rank(tmp: str) -> dict:
    mesh = make_mesh(EP_MESH, device_type="cpu")
    model, cfg = _stage_model("moe", mesh, f"{tmp}/moe.npz")
    init_state, train_step, shard_batch = make_train_step(
        model, cfg, device="cpu", mesh=mesh, pipeline=True,
        pipeline_schedule="1f1b", n_microbatches=N_MB)
    state = init_state(model)
    traj = []
    for step in range(MOE_STEPS):
        state, metrics = train_step(
            state, shard_batch(_tokens(20 + step, cfg.vocab_size)))
        traj.append([float(metrics["loss"]), float(metrics["aux"])])
    # Packed ids, one step from the flax weights: the gradients this rank
    # holds (SGD at rate 0 leaves them in .grad).
    model, cfg = _stage_model("moe", mesh, f"{tmp}/moe.npz")
    init_state, train_step, shard_batch = make_train_step(
        model, cfg, device="cpu", mesh=mesh, pipeline=True,
        pipeline_schedule="1f1b", n_microbatches=N_MB,
        optimizer=lambda ps: torch.optim.SGD(ps, lr=0.0))
    state = init_state(model)
    _, metrics = train_step(state, shard_batch(_tokens(1, cfg.vocab_size)),
                            shard_batch(_packed()))
    names = {id(p): n for n, p in model.named_parameters()}
    ep = mesh.get_local_rank("ep")
    grads = {names[id(p)]: p.grad.to_local().tolist()
             if hasattr(p.grad, "to_local") else p.grad.tolist()
             for p in state["params"]}
    return {"traj": traj, "packed": {"loss": float(metrics["loss"]),
                                     "aux": float(metrics["aux"]),
                                     "ep": ep, "grads": grads}}


def _rank(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    warnings.simplefilter("ignore")  # absent axes of the plans
    try:
        out = {"llama": _llama_rank(tmp), "moe": _moe_rank(tmp)}
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(out, f)


# -- the JAX side (the pytest process) ------------------------------------


def _flat(params) -> dict:
    from jax.tree_util import tree_flatten_with_path

    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in tree_flatten_with_path(params)[0]}


@functools.lru_cache(maxsize=None)
def _flax(family: str):
    """(flax model, its config, its own init as numpy)."""
    import jax
    import jax.numpy as jnp

    from torchdistx_tpu.models import PRESETS as JAX_PRESETS
    from torchdistx_tpu.models import make_llama as jax_make_llama
    from torchdistx_tpu.models import make_mixtral as jax_make_mixtral

    cfg = JAX_PRESETS["tiny" if family == "llama" else "tiny-moe"]
    model = (jax_make_llama if family == "llama" else jax_make_mixtral)(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))
    return model, cfg, jax.tree.map(np.asarray, params)


def _jax_trajectory(family: str, axes: dict, sched: str, steps: int,
                    seed: int) -> list:
    import jax
    import jax.numpy as jnp

    from torchdistx_tpu.parallel import make_mesh as jax_make_mesh
    from torchdistx_tpu.parallel.train import make_train_step as jax_step

    model, cfg, params = _flax(family)
    init_state, train_step, shard_batch = jax_step(
        model, cfg, jax_make_mesh(axes), pipeline=True,
        pipeline_schedule=sched, n_microbatches=N_MB, batch_axes=("dp",))
    state = init_state(jax.tree.map(jnp.asarray, params))
    out = []
    for step in range(steps):
        state, metrics = train_step(state, shard_batch(
            jnp.asarray(_tokens(seed + step, cfg.vocab_size))))
        out.append([float(metrics["loss"]), float(metrics["aux"])])
    return out


def _jax_packed_grads():
    """The JAX ``pipeline_train_1f1b`` over {pp 2, ep 2, dp 2} with the
    packed ids: (loss, {port name: gradient})."""
    import jax
    import jax.numpy as jnp

    from torchdistx_tpu.parallel import make_mesh as jax_make_mesh
    from torchdistx_tpu.parallel.pipeline import pipeline_train_1f1b

    model, cfg, params = _flax("moe")
    mesh = jax_make_mesh(EP_MESH)
    metrics, grads = jax.jit(lambda p, t, s: pipeline_train_1f1b(
        cfg, p, t, mesh, decomp=model.pipeline_decomposition(),
        n_microbatches=N_MB, segment_ids=s))(
            jax.tree.map(jnp.asarray, params),
            jnp.asarray(_tokens(1, cfg.vocab_size)),
            jnp.asarray(_packed(), jnp.int32))
    return float(metrics["loss"]), from_flax_params(
        "llama", TINY_MOE, jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results and the JAX references, computed while the
    ranks run."""
    tmp = tmp_path_factory.mktemp("pipeline_mesh")
    for family in FAMILIES:
        np.savez(tmp / f"{family}.npz", **_flat(_flax(family)[2]))
    ctx = mp.start_processes(_rank, args=(WORLD, str(tmp)), nprocs=WORLD,
                             join=False, start_method="spawn")
    try:
        refs = {sched: _jax_trajectory("llama", TP_MESH, sched, LLAMA_STEPS,
                                       10)
                for sched in ("gpipe", "1f1b")}
        refs["moe"] = _jax_trajectory("moe", EP_MESH, "1f1b", MOE_STEPS, 20)
        refs["packed"] = _jax_packed_grads()
    finally:
        while not ctx.join():
            pass
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return ranks, refs


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_tp_dp_pipeline_matches_jax(runs, sched):
    ranks, refs = runs
    losses = ranks[0]["llama"][sched]
    assert all(r["llama"][sched] == losses for r in ranks)
    np.testing.assert_allclose(losses, [x[0] for x in refs[sched]],
                               rtol=RTOL)


def test_moe_ep_dp_trajectory_matches_jax(runs):
    """Loss and router loss, step for step: capacity, slots and the
    load-balancing statistics come from the global microbatch."""
    ranks, refs = runs
    traj = np.asarray(ranks[0]["moe"]["traj"])
    assert all(r["moe"]["traj"] == ranks[0]["moe"]["traj"] for r in ranks)
    assert (traj[:, 1] > 0).all()
    np.testing.assert_allclose(traj, np.asarray(refs["moe"]), rtol=RTOL)


def test_moe_packed_1f1b_gradients_match_jax(runs):
    """Each rank's gradients (its stage's layers with its experts' block
    over ep, the embed and head summed over pp) equal the JAX ones; the
    ranks together hold every parameter."""
    ranks, (want_loss, want) = runs[0], runs[1]["packed"]
    E = TINY_MOE.moe.n_experts
    seen = set()
    for r in ranks:
        got = r["moe"]["packed"]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=RTOL)
        for name, g in got["grads"].items():
            w = want[name].numpy()
            if name.split(".")[-1] in ("w_gate", "w_up", "w_down"):
                n = E // EP_MESH["ep"]
                w = w[got["ep"] * n:(got["ep"] + 1) * n]
            np.testing.assert_allclose(np.asarray(g), w, atol=GRAD_ATOL,
                                       rtol=0, err_msg=name)
            seen.add(name)
    assert seen == set(want)
