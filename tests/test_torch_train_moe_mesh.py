"""Expert parallelism in the sharded train step: ``tiny-moe`` (4 experts,
top 2) over gloo meshes of 4 CPU ranks (a file rendezvous under a
temporary directory), fed by the keyed materializer's values, against
``mesh=None`` on the same seed's unsharded values.

One spawn of 4 ranks runs every case and writes what each rank saw; the
tests read it.  Cases (B 8, S 32, 3 SGD steps at lr 0.1, float32; SGD's
update is linear in the gradient, so the parameters after the steps
compare the gradients themselves, where AdamW's first steps divide each
element by its own magnitude and turn an element's rounding noise near
zero into a step of up to the learning rate — the reason
``test_torch_train_mesh.py`` holds GPT-2's key biases by AdamW's step
bound):

* ``{dp: 2, ep: 2}``: the batch over dp, the experts over ep, every
  parameter replicated over dp;
* ``{ep: 2, tp: 2}``: no data axis (the batch replicated), the experts
  over ep and their ``ff`` dim over tp beside tensor-parallel attention;
* ``{fsdp: 2, ep: 2}``: the batch and FSDP2 over fsdp, the experts over
  ep.

Held: every parameter's local tensor after ``init_state`` is its keyed
local shard, bit for bit; the losses and gradient norms of the 3 steps
are equal on every rank and within 1e-6 relative of ``mesh=None``; after
the 3 steps each parameter (an expert weight: this rank's ep/tp block)
within 1e-6 normwise of ``mesh=None``'s; the (token, choice) pairs
dropped at capacity, summed over the data shards, are ``mesh=None``'s —
the routing is global over the data axes.  No JAX at module level: the
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
from torchdistx_tpu_torch.cuda_bridge import bind_values, materialize_module_cuda
from torchdistx_tpu_torch.models import TINY_MOE, decoder_lm_plan, make_mixtral
from torchdistx_tpu_torch.models.layers import MoEMLP
from torchdistx_tpu_torch.parallel import local_shard, make_mesh, make_train_step
from torchdistx_tpu_torch.parallel.sharding import PartitionSpec, mesh_shape

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

WORLD, B, S, STEPS = 4, 8, 32, 3
RTOL = 1e-6
LR = 0.1
CFG = TINY_MOE
MESHES = {"dp2-ep2": {"dp": 2, "ep": 2}, "ep2-tp2": {"ep": 2, "tp": 2},
          "fsdp2-ep2": {"fsdp": 2, "ep": 2}}


def _batches() -> np.ndarray:
    return np.random.RandomState(0).randint(0, CFG.vocab_size, (STEPS, B, S))


def _dropped(model) -> int:
    return int(sum((~m.kept).sum() for m in model.modules()
                   if isinstance(m, MoEMLP)))


def _sgd(params):
    return torch.optim.SGD(params, lr=LR)


def _trajectory(init_state, train_step, shard_batch, model):
    state = init_state(model)
    losses, norms, dropped = [], [], []
    for toks in _batches():
        state, metrics = train_step(state, shard_batch(toks))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        dropped.append(_dropped(model))
    return state, losses, norms, dropped


def _local(p: torch.Tensor) -> torch.Tensor:
    return p.to_local() if hasattr(p, "to_local") else p


def _full(p: torch.Tensor) -> torch.Tensor:
    return p.full_tensor() if hasattr(p, "full_tensor") else p


@functools.lru_cache(maxsize=None)
def _reference():
    """The ``mesh=None`` run from the keyed unsharded values (once per
    rank, shared by the meshes): its trajectory and final parameters."""
    ref = deferred_init(make_mixtral, CFG, device="cpu")
    bind_values(ref, materialize_module_cuda(ref, device="cpu"))
    _, ref_losses, ref_norms, ref_dropped = _trajectory(
        *make_train_step(ref, CFG, device="cpu", optimizer=_sgd), ref)
    want = {n: p.detach() for n, p in ref.named_parameters()}
    return ref_losses, ref_norms, ref_dropped, want


def _case(axes: dict) -> dict:
    ref_losses, ref_norms, ref_dropped, want = _reference()
    mesh = make_mesh(axes, device_type="cpu")
    plan = decoder_lm_plan(CFG)
    model = deferred_init(make_mixtral, CFG, device="cpu")
    values = materialize_module_cuda(model, mesh=mesh, plan=plan)
    bind_values(model, values)
    init_state, train_step, shard_batch = make_train_step(
        model, CFG, device="cpu", mesh=mesh, optimizer=_sgd)
    keyed = {}

    def init(m):
        state = init_state(m)
        keyed.update({n: torch.equal(_local(p), values[n].to_local())
                      for n, p in m.named_parameters()})
        return state

    _, losses, norms, dropped = _trajectory(init, train_step, shard_batch,
                                            model)
    shape, coord = mesh_shape(mesh), mesh.get_coordinate()
    final = {}
    for name, p in model.named_parameters():
        w = want[name]
        if ".moe.w_" in name:  # this rank's ep/tp block of the experts
            spec = plan.spec_for(name, tuple(w.shape), mesh)
            w = local_shard(w, PartitionSpec(*(a if a in ("ep", "tp") else None
                                               for a in spec)), shape, coord)
        got = _full(p.detach())
        final[name] = float((got - w).norm() / w.norm().clamp_min(1e-30))
    where = dict(zip(shape, coord))
    data_index = 0
    for a in ("dp", "fsdp"):
        if a in shape:
            data_index = data_index * shape[a] + where[a]
    return {"keyed": keyed, "losses": losses, "norms": norms,
            "ref_losses": ref_losses, "ref_norms": ref_norms, "final": final,
            "dropped": dropped, "ref_dropped": ref_dropped,
            "data_index": data_index}


def _rank(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    warnings.simplefilter("ignore")  # the batch replicated on {ep, tp}
    try:
        out = {name: _case(axes) for name, axes in MESHES.items()}
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_moe_mesh")
    mp.spawn(_rank, args=(WORLD, str(tmp)), nprocs=WORLD, join=True)
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(WORLD)]


@pytest.mark.parametrize("case", list(MESHES))
def test_parameters_adopt_the_keyed_shards(runs, case):
    for rank, out in enumerate(runs):
        bad = [n for n, ok in out[case]["keyed"].items() if not ok]
        assert out[case]["keyed"] and not bad, (rank, bad)


@pytest.mark.parametrize("case", list(MESHES))
def test_trajectory_matches_unsharded(runs, case):
    first = runs[0][case]
    for out in runs[1:]:
        assert out[case]["losses"] == first["losses"]
        assert out[case]["norms"] == first["norms"]
    np.testing.assert_allclose(first["losses"], first["ref_losses"], rtol=RTOL)
    np.testing.assert_allclose(first["norms"], first["ref_norms"], rtol=RTOL)


@pytest.mark.parametrize("case", list(MESHES))
def test_final_parameters_match_unsharded(runs, case):
    for rank, out in enumerate(runs):
        bad = {n: e for n, e in out[case]["final"].items() if not e <= RTOL}
        assert not bad, (rank, bad)


@pytest.mark.parametrize("case", list(MESHES))
def test_routing_is_global(runs, case):
    """The pairs dropped at capacity, summed over the data shards, are
    the unsharded run's at every step."""
    by_shard = {out[case]["data_index"]: out[case]["dropped"] for out in runs}
    total = [sum(step) for step in zip(*by_shard.values())]
    assert total == runs[0][case]["ref_dropped"]
