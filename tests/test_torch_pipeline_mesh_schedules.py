"""Every pipeline schedule over tensor and expert parallelism, held
against the port's unsharded step on the same keyed values.

One spawn of 8 gloo CPU ranks (a file rendezvous under a temporary
directory), each rank materializing only its stage's layers as its shard
over the other axes (``pipeline_plan_overrides`` over
``decoder_lm_plan``), runs 3 AdamW steps of ``make_train_step(
pipeline=True)`` under GPipe, 1F1B and interleaved 1F1B (2 chunks a
stage) on a [8, 16] batch:

* a 4-layer llama over ``{pp 2, dp 2, tp 2}`` in 4 microbatches;
* a 4-layer Mixtral (``TINY_MOE``) over ``{pp 2, ep 2, dp 2}`` in one
  microbatch, so that its routing (global over ``dp``) sees the whole
  batch, as the unsharded step's does.

Losses and gradient norms are equal on every rank and within 1e-5 of
``mesh=None`` on the same seed's unsharded values (computed in the
pytest process while the ranks run).  float32.  No JAX: the spawned
ranks import this module.
"""

import json
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torchdistx_tpu_torch import deferred_init
from torchdistx_tpu_torch.cuda_bridge import bind_values, materialize_module_cuda
from torchdistx_tpu_torch.models import TINY, TINY_MOE, make_llama, make_mixtral
from torchdistx_tpu_torch.models.plans import decoder_lm_plan
from torchdistx_tpu_torch.parallel import make_mesh, make_train_step
from torchdistx_tpu_torch.parallel.pipeline import pipeline_plan_overrides

torch.set_num_threads(2)

WORLD, B, S, STEPS, RTOL = 8, 8, 16, 3, 1e-5
SCHEDULES = ("gpipe", "1f1b", "interleaved")
# case: (model, config, mesh axes, microbatches)
CASES = {"pp2-dp2-tp2": (make_llama, TINY.replace(n_layers=4),
                         {"pp": 2, "dp": 2, "tp": 2}, 4),
         "pp2-ep2-dp2-moe": (make_mixtral, TINY_MOE.replace(n_layers=4),
                             {"pp": 2, "ep": 2, "dp": 2}, 1)}


def _tokens(cfg, step: int) -> np.ndarray:
    return np.random.RandomState(10 + step).randint(0, cfg.vocab_size, (B, S))


def _trajectory(model, cfg, mesh, **kw) -> dict:
    init_state, train_step, shard_batch = make_train_step(
        model, cfg, device="cpu", mesh=mesh, **kw)
    state = init_state(model)
    losses, norms = [], []
    for step in range(STEPS):
        state, metrics = train_step(state, shard_batch(_tokens(cfg, step)))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return {"losses": losses, "norms": norms}


def _rank(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    warnings.simplefilter("ignore")  # absent axes of the plans
    out = {}
    try:
        for name, (make, cfg, axes, n_mb) in CASES.items():
            mesh = make_mesh(axes, device_type="cpu")
            for sched in SCHEDULES:
                model = deferred_init(make, cfg, device="cpu")
                plan = pipeline_plan_overrides(
                    decoder_lm_plan(cfg), cfg.n_layers,
                    n_chunks=2 if sched == "interleaved" else 1)
                bind_values(model, materialize_module_cuda(
                    model, mesh=mesh, plan=plan), strict=False)
                out[f"{name}-{sched}"] = _trajectory(
                    model, cfg, mesh, pipeline=True, pipeline_schedule=sched,
                    n_microbatches=n_mb)
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results and ``mesh=None``'s for each model."""
    tmp = tmp_path_factory.mktemp("pipeline_mesh_schedules")
    ctx = mp.start_processes(_rank, args=(WORLD, str(tmp)), nprocs=WORLD,
                             join=False, start_method="spawn")
    try:
        want = {}
        for name, (make, cfg, _, _) in CASES.items():
            ref = deferred_init(make, cfg, device="cpu")
            bind_values(ref, materialize_module_cuda(ref, device="cpu"))
            want[name] = _trajectory(ref, cfg, None)
    finally:
        while not ctx.join():
            pass
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return ranks, want


@pytest.mark.parametrize("name,sched", [(n, s) for n in CASES
                                        for s in SCHEDULES],
                         ids=[f"{n}-{s}" for n in CASES for s in SCHEDULES])
def test_schedule_matches_unsharded(runs, name, sched):
    ranks, want = runs
    first = ranks[0][f"{name}-{sched}"]
    for rank in ranks[1:]:
        assert rank[f"{name}-{sched}"] == first
    np.testing.assert_allclose(first["losses"], want[name]["losses"],
                               rtol=RTOL, err_msg="losses")
    np.testing.assert_allclose(first["norms"], want[name]["norms"],
                               rtol=RTOL, err_msg="grad norms")
