"""Pipelines combined with FSDP2 and with the sp ring, held against the
port's unsharded step on the same keyed values.

Two spawns of gloo CPU ranks, started together (a file rendezvous under a
temporary directory): 4 ranks on ``{pp 2, fsdp 2}`` and 8 on ``{pp 2,
dp 2, sp 2}``.  Each rank materializes only its stage's layers
(``pipeline_plan_overrides`` over ``decoder_lm_plan``: its shard of
them over the other axes) and runs 3 AdamW steps of
``make_train_step(pipeline=True)`` on a [8, 16] batch in 4 microbatches:

* ``{pp 2, fsdp 2}`` under GPipe, 1F1B and interleaved 1F1B (2 chunks a
  stage): each stage's blocks and its embed and head are FSDP2 units of
  their own, and each unit's gradients are reduced once a step, at its
  chunk's last backward;
* ``{pp 2, dp 2, sp 2}`` under every schedule with ring flash
  (``make_ring_flash_attention(mesh)`` as the stages' ``attn_fn``): each
  microbatch is the rank's sequence chunk plus the next token.

Losses and gradient norms are equal on every rank and within 1e-5 of
``mesh=None`` on the same seed's unsharded values (computed in the
pytest process while the ranks run).  float32, TINY llama.  No JAX: the
spawned ranks import this module.
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
from torchdistx_tpu_torch.models import TINY, make_llama
from torchdistx_tpu_torch.models.plans import decoder_lm_plan
from torchdistx_tpu_torch.parallel import (
    make_mesh,
    make_ring_flash_attention,
    make_train_step,
)
from torchdistx_tpu_torch.parallel.pipeline import pipeline_plan_overrides

torch.set_num_threads(2)

B, S, N_MB, STEPS, RTOL = 8, 16, 4, 3, 1e-5
CFG = TINY.replace(n_layers=4)
SCHEDULES = ("gpipe", "1f1b", "interleaved")
SPAWNS = {"fsdp": ({"pp": 2, "fsdp": 2}, SCHEDULES),
          "sp": ({"pp": 2, "dp": 2, "sp": 2}, SCHEDULES)}


def _tokens(step: int) -> np.ndarray:
    return np.random.RandomState(10 + step).randint(0, CFG.vocab_size, (B, S))


def _trajectory(model, mesh, **kw) -> dict:
    init_state, train_step, shard_batch = make_train_step(
        model, CFG, device="cpu", mesh=mesh, n_microbatches=N_MB, **kw)
    state = init_state(model)
    losses, norms = [], []
    for step in range(STEPS):
        state, metrics = train_step(state, shard_batch(_tokens(step)))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return {"losses": losses, "norms": norms}


def _rank(rank: int, world: int, tmp: str, name: str) -> None:
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv-{name}",
                            rank=rank, world_size=world)
    warnings.simplefilter("ignore")  # absent axes of the plans
    axes, schedules = SPAWNS[name]
    out = {}
    try:
        mesh = make_mesh(axes, device_type="cpu")
        kw = ({"attn_fn": make_ring_flash_attention(mesh)} if "sp" in axes
              else {})
        for sched in schedules:
            model = deferred_init(make_llama, CFG, device="cpu")
            plan = pipeline_plan_overrides(
                decoder_lm_plan(CFG), CFG.n_layers,
                n_chunks=2 if sched == "interleaved" else 1)
            bind_values(model, materialize_module_cuda(model, mesh=mesh,
                                                       plan=plan),
                        strict=False)
            out[sched] = _trajectory(model, mesh, pipeline=True,
                                     pipeline_schedule=sched, **kw)
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/{name}-{rank}.json", "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results from both spawns, and ``mesh=None``'s."""
    tmp = tmp_path_factory.mktemp("pipeline_mesh_keyed")
    worlds = {name: int(np.prod(list(axes.values())))
              for name, (axes, _) in SPAWNS.items()}
    spawns = [mp.start_processes(_rank, args=(world, str(tmp), name),
                                 nprocs=world, join=False,
                                 start_method="spawn")
              for name, world in worlds.items()]
    try:
        ref = deferred_init(make_llama, CFG, device="cpu")
        bind_values(ref, materialize_module_cuda(ref, device="cpu"))
        want = _trajectory(ref, None)
    finally:
        for ctx in spawns:
            while not ctx.join():
                pass
    out = {name: [json.loads((tmp / f"{name}-{r}.json").read_text())
                  for r in range(world)] for name, world in worlds.items()}
    return out, want


@pytest.mark.parametrize("name,sched", [(n, s) for n in SPAWNS
                                        for s in SCHEDULES],
                         ids=[f"{i}-{s}" for i in ("pp2-fsdp2",
                                                   "pp2-dp2-sp2-ring-flash")
                              for s in SCHEDULES])
def test_pipeline_mesh_matches_unsharded(runs, name, sched):
    out, want = runs
    first = out[name][0][sched]
    for rank in out[name][1:]:
        assert rank[sched] == first
    np.testing.assert_allclose(first["losses"], want["losses"], rtol=RTOL,
                               err_msg="losses")
    np.testing.assert_allclose(first["norms"], want["norms"], rtol=RTOL,
                               err_msg="grad norms")
