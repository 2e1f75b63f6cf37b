"""A mixture of experts over the ``sp`` axis: routing as one device routes
the whole sequence.

One spawn of 4 gloo CPU ranks (a file rendezvous under a temporary
directory) runs every case and writes what each rank saw; the JAX
reference runs in the pytest process meanwhile.  float32, ``TINY_MOE``:

* the routing alone on ``{sp: 4}``: router probabilities made from a
  seed, skewed so that expert 0 overflows its capacity in a middle
  chunk of the second row; each rank's slots, kept pairs, capacity and
  router loss equal, bitwise, the whole-sequence routing cut to its
  chunk (a per-rank scalar slot offset, which treats a rank's pairs as
  one contiguous block, keeps pairs the whole sequence drops);
* config B of the JAX package's multichip dry run: the flax weights on
  ``{sp: 2, ep: 2}`` and ``{fsdp: 2, sp: 2}`` with the dense ring
  attention, 4 AdamW steps at B 8, S 32, against the JAX
  ``make_train_step`` on one CPU device, within its 2e-3
  (``__graft_entry__.py``); the dropped pairs of every step, summed
  over the data shards and chunks, are the one-device count;
* a pipeline stage on ``{pp: 2, sp: 2}`` (1F1B, one microbatch, ring
  flash attention) from the keyed values: 3 steps within 1e-5 of
  ``mesh=None``.

No JAX at module level: the spawned ranks import this module.
"""

import functools
import json
import math
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torchdistx_tpu_torch import deferred_init
from torchdistx_tpu_torch.cuda_bridge import bind_values, materialize_module_cuda
from torchdistx_tpu_torch.models import TINY_MOE, from_flax_params, make_mixtral
from torchdistx_tpu_torch.models.layers import MoEMLP, moe_capacity
from torchdistx_tpu_torch.models.plans import decoder_lm_plan
from torchdistx_tpu_torch.parallel import (
    local_shard,
    make_mesh,
    make_ring_attention,
    make_ring_flash_attention,
    make_train_step,
    placements_for,
)
from torchdistx_tpu_torch.parallel.pipeline import pipeline_plan_overrides
from torchdistx_tpu_torch.parallel.sharding import mesh_shape
from torchdistx_tpu_torch.parallel.spmd import ExpertParallel

torch.set_num_threads(2)

WORLD, B, S, STEPS = 4, 8, 32, 4
TOL = 2e-3  # config B's bound in __graft_entry__.py
PP_STEPS, PP_RTOL = 3, 1e-5
CFG = TINY_MOE
MESHES = {"sp2-ep2": {"sp": 2, "ep": 2}, "fsdp2-sp2": {"fsdp": 2, "sp": 2}}
# The routing case: rows, tokens, experts.
R_B, R_S = 2, 16


def _batches() -> np.ndarray:
    return np.random.RandomState(7).randint(0, CFG.vocab_size, (STEPS, B, S))


def _probs() -> torch.Tensor:
    """[R_B, R_S, E] router probabilities: every token leans on expert 0,
    which takes 2 x 16 first choices against a capacity of 20, so its
    drops start in chunk 1 of row 1 on {sp: 4}."""
    rng = np.random.RandomState(3)
    logits = rng.standard_normal((R_B, R_S, CFG.moe.n_experts))
    logits[..., 0] += 4.0
    return torch.softmax(torch.from_numpy(logits).float(), -1)


def _route(mod: MoEMLP, probs: torch.Tensor) -> dict:
    _, _, pos, capacity = mod.route(probs, torch.float32)
    return {"pos": pos.tolist(), "kept": mod.kept.tolist(),
            "capacity": capacity, "aux": float(mod.aux)}


def _routing_rank(rank: int, world: int) -> dict:
    mod = MoEMLP(CFG, device="cpu")
    E = CFG.moe.n_experts
    mod.parallel = ExpertParallel(
        data_groups=[], data_index=0, n_data=1, groups=[], expert_offset=0,
        n_local=E, seq_group=dist.group.WORLD, seq_index=rank, n_seq=world)
    s = R_S // world
    return _route(mod, _probs()[:, rank * s:(rank + 1) * s].contiguous())


def _dropped(model) -> int:
    return int(sum((~m.kept).sum() for m in model.modules()
                   if isinstance(m, MoEMLP)))


def _tree(npz: str) -> dict:
    tree: dict = {}
    for key, leaf in np.load(npz).items():
        node = tree
        *parents, last = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def _trajectory(model, mesh) -> tuple:
    init_state, train_step, shard_batch = make_train_step(
        model, CFG, device="cpu", mesh=mesh)
    state = init_state(model)
    losses, dropped = [], []
    for toks in _batches():
        state, metrics = train_step(state, shard_batch(toks))
        losses.append(float(metrics["loss"]))
        dropped.append(_dropped(model))
    return losses, dropped


@functools.lru_cache(maxsize=None)
def _one_device(npz: str) -> tuple:
    """The port's ``mesh=None`` run on the flax weights."""
    model = make_mixtral(CFG, device="cpu")
    model.load_state_dict(from_flax_params("llama", CFG, _tree(npz)))
    return _trajectory(model, None)


def _config_b(axes: dict, npz: str) -> dict:
    """The flax weights on ``axes`` with the dense ring: losses and the
    dropped pairs of each step."""
    from torch.distributed.tensor import DTensor

    full = from_flax_params("llama", CFG, _tree(npz))
    mesh = make_mesh(axes, device_type="cpu")
    plan = decoder_lm_plan(CFG)
    shape, coord = mesh_shape(mesh), mesh.get_coordinate()
    values = {}
    for name, t in full.items():
        spec = plan.spec_for(name, tuple(t.shape), mesh)
        values[name] = DTensor.from_local(
            local_shard(t, spec, shape, coord).contiguous(), mesh,
            placements_for(spec, mesh), run_check=False, shape=t.shape,
            stride=t.stride())
    model = deferred_init(make_mixtral, CFG,
                          attn_fn=make_ring_attention(mesh), device="cpu")
    bind_values(model, values)
    losses, dropped = _trajectory(model, mesh)
    where = dict(zip(mesh.mesh_dim_names, coord))
    one_losses, one_dropped = _one_device(npz)
    return {"losses": losses, "dropped": dropped,
            "token_shard": [where.get("fsdp", 0), where.get("sp", 0)],
            "one_device_losses": one_losses,
            "one_device_dropped": one_dropped}


def _pp_trajectory(model, mesh, **kw) -> list:
    init_state, train_step, shard_batch = make_train_step(
        model, CFG, device="cpu", mesh=mesh, **kw)
    state = init_state(model)
    losses = []
    for toks in _batches()[:PP_STEPS]:
        state, metrics = train_step(state, shard_batch(toks))
        losses.append(float(metrics["loss"]))
    return losses


@functools.lru_cache(maxsize=None)
def _pp_reference() -> list:
    ref = deferred_init(make_mixtral, CFG, device="cpu")
    bind_values(ref, materialize_module_cuda(ref, device="cpu"))
    return _pp_trajectory(ref, None)


def _pipeline() -> dict:
    mesh = make_mesh({"pp": 2, "sp": 2}, device_type="cpu")
    model = deferred_init(make_mixtral, CFG, device="cpu")
    plan = pipeline_plan_overrides(decoder_lm_plan(CFG), CFG.n_layers)
    bind_values(model, materialize_module_cuda(model, mesh=mesh, plan=plan),
                strict=False)
    losses = _pp_trajectory(model, mesh, pipeline=True,
                            pipeline_schedule="1f1b", n_microbatches=1,
                            attn_fn=make_ring_flash_attention(mesh))
    return {"losses": losses, "ref": _pp_reference()}


def _rank(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    warnings.simplefilter("ignore")  # the batch replicated on {sp, ep}
    try:
        out = {"routing": _routing_rank(rank, world)}
        out.update({name: _config_b(axes, f"{tmp}/moe.npz")
                    for name, axes in MESHES.items()})
        out["pipeline"] = _pipeline()
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
def _flax():
    import jax
    import jax.numpy as jnp

    from torchdistx_tpu.models import TINY_MOE as JAX_TINY_MOE
    from torchdistx_tpu.models import make_mixtral as jax_make_mixtral

    model = jax_make_mixtral(JAX_TINY_MOE)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))
    return model, JAX_TINY_MOE, jax.tree.map(np.asarray, params)


def _jax_losses() -> list:
    """Config B's one-device reference: the JAX ``make_train_step`` on a
    ``{dp: 1}`` mesh of one CPU device."""
    import jax
    import jax.numpy as jnp

    from torchdistx_tpu.parallel import make_mesh as jax_make_mesh
    from torchdistx_tpu.parallel.train import make_train_step as jax_step

    model, cfg, params = _flax()
    mesh = jax_make_mesh({"dp": 1}, devices=jax.devices()[:1])
    init_state, train_step, shard_batch = jax_step(model, cfg, mesh)
    state = init_state(jax.tree.map(jnp.asarray, params))
    losses = []
    for toks in _batches():
        state, metrics = train_step(state, shard_batch(jnp.asarray(toks)))
        losses.append(float(metrics["loss"]))
    return losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results and the JAX reference, computed while the
    ranks run."""
    tmp = tmp_path_factory.mktemp("moe_sp")
    np.savez(tmp / "moe.npz", **_flat(_flax()[2]))
    ctx = mp.start_processes(_rank, args=(WORLD, str(tmp)), nprocs=WORLD,
                             join=False, start_method="spawn")
    try:
        ref = _jax_losses()
    finally:
        while not ctx.join():
            pass
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return ranks, ref


def _scalar_offset_kept(probs: torch.Tensor, world: int) -> list:
    """The routing a per-rank scalar offset gives: each rank's pairs
    taken as one contiguous block after the lower ranks' pairs."""
    E, k = CFG.moe.n_experts, CFG.moe.top_k
    capacity = moe_capacity(CFG.moe, R_B * R_S)
    s = R_S // world
    before = torch.zeros(E, dtype=torch.long)
    kept = []
    for r in range(world):
        idx = torch.topk(probs[:, r * s:(r + 1) * s].reshape(-1, E), k, -1)[1]
        onehot = torch.nn.functional.one_hot(idx, E)
        flat = onehot.reshape(-1, E)
        pos = ((flat.cumsum(0) - 1 + before).reshape(-1, k, E)
               * onehot).sum(-1)
        before = before + flat.sum(0)
        kept.append((pos < capacity).reshape(R_B, s, k))
    return torch.cat(kept, 1).reshape(-1, k).tolist()


def test_routing_per_row_equals_whole_sequence_bitwise(runs):
    """Each sp rank's slots, kept pairs, capacity and router loss are the
    whole-sequence routing cut to its chunk, bit for bit; the drops
    begin inside a middle chunk, where a scalar offset per rank would
    keep them."""
    ranks, _ = runs
    mod = MoEMLP(CFG, device="cpu")
    whole = _route(mod, _probs())
    k, s = CFG.moe.top_k, R_S // WORLD
    grid = lambda a: np.asarray(a).reshape(R_B, R_S, k)  # noqa: E731
    for r, out in enumerate(ranks):
        got = out["routing"]
        want = {key: grid(whole[key])[:, r * s:(r + 1) * s].reshape(-1, k)
                .tolist() for key in ("pos", "kept")}
        assert got["pos"] == want["pos"], r
        assert got["kept"] == want["kept"], r
        assert got["capacity"] == whole["capacity"] == math.ceil(
            R_B * R_S * k / CFG.moe.n_experts * 1.25)
        assert got["aux"] == whole["aux"], (r, got["aux"], whole["aux"])
    dropped = ~grid(whole["kept"])
    first = np.argwhere(dropped.any(-1))[0]  # (row, token) of the first drop
    assert first[0] == 1 and 0 < first[1] // s < WORLD - 1, first
    assert _scalar_offset_kept(_probs(), WORLD) != whole["kept"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_config_b_matches_jax_one_device(runs, mesh):
    """Config B: the 4-step AdamW trajectory on the mesh, equal on every
    rank, within 2e-3 of the JAX one-device trajectory (and of the
    port's own ``mesh=None`` run on the same weights)."""
    ranks, ref = runs
    losses = ranks[0][mesh]["losses"]
    assert all(out[mesh]["losses"] == losses for out in ranks)
    np.testing.assert_allclose(losses, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(losses, ranks[0][mesh]["one_device_losses"],
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_config_b_drops_the_one_device_pairs(runs, mesh):
    """The pairs dropped at capacity, summed over the token shards (the
    data shards and the sp chunks; ep ranks hold the same tokens), are
    the one-device run's at every step."""
    ranks, _ = runs
    by_shard = {tuple(out[mesh]["token_shard"]): out[mesh]["dropped"]
                for out in ranks}
    total = [sum(step) for step in zip(*by_shard.values())]
    assert total == ranks[0][mesh]["one_device_dropped"]
    assert any(total), "the case drops no pair"


def test_pipeline_stage_over_sp_matches_whole_model(runs):
    """{pp: 2, sp: 2}, 1F1B with one microbatch, ring flash: losses equal
    on every rank and within 1e-5 of ``mesh=None``."""
    ranks, _ = runs
    got = ranks[0]["pipeline"]
    assert all(out["pipeline"]["losses"] == got["losses"] for out in ranks)
    np.testing.assert_allclose(got["losses"], got["ref"], rtol=PP_RTOL)
