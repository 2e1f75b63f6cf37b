"""The pipelined train step on one-rank meshes that carry each other axis
a stage's blocks run under (no spawn; one gloo rank, an in-memory store).

``make_train_step(pipeline=True)`` on ``{pp 1}`` with ``fsdp``, ``tp``,
``fsdp`` and ``tp``, ``ep`` (Mixtral's experts) or ``sp`` (ring flash)
beside it lays the stage out with FSDP2, tensor parallelism and the
experts' split (``spmd.shard_module(pipelined=True)``) and walks the
schedule through them: 3 AdamW steps from the stage's keyed values,
losses and gradient norms within 1e-5 of ``mesh=None`` on the same
seed's unsharded values.  The Mixtral cases run one microbatch, so their
routing sees the whole batch as the unsharded step's does; one of them
sits beside ``sp`` with the ring-flash attention.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torchdistx_tpu_torch import deferred_init
from torchdistx_tpu_torch.cuda_bridge import bind_values, materialize_module_cuda
from torchdistx_tpu_torch.models import TINY, TINY_MOE, make_llama, make_mixtral
from torchdistx_tpu_torch.models.plans import decoder_lm_plan
from torchdistx_tpu_torch.parallel import (
    make_mesh,
    make_ring_flash_attention,
    make_train_step,
)
from torchdistx_tpu_torch.parallel.pipeline import pipeline_plan_overrides

torch.set_num_threads(2)

B, S, STEPS, RTOL = 4, 16, 3, 1e-5
# case: (mesh axes, MoE, schedule, microbatches)
CASES = {
    "pp1-fsdp1": ({"pp": 1, "fsdp": 1}, False, "gpipe", 2),
    "pp1-ep1-moe": ({"pp": 1, "ep": 1}, True, "1f1b", 1),
    "pp1-sp1-moe": ({"pp": 1, "sp": 1}, True, "gpipe", 1),
    "pp1-sp1-ring-flash": ({"pp": 1, "sp": 1}, False, "1f1b", 2),
    "pp1-tp1": ({"pp": 1, "tp": 1}, False, "1f1b", 2),
    "pp1-fsdp1-tp1": ({"pp": 1, "fsdp": 1, "tp": 1}, False, "interleaved", 2),
}


def _trajectory(model, cfg, mesh, **kw):
    init_state, train_step, shard_batch = make_train_step(
        model, cfg, device="cpu", mesh=mesh, **kw)
    state = init_state(model)
    losses, norms = [], []
    for step in range(STEPS):
        toks = np.random.RandomState(step).randint(0, cfg.vocab_size, (B, S))
        state, metrics = train_step(state, shard_batch(toks))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return losses, norms


@pytest.fixture
def one_rank():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("case", list(CASES))
def test_one_rank_mesh_matches_unsharded(one_rank, case):
    axes, moe, sched, n_mb = CASES[case]
    cfg, make = (TINY_MOE, make_mixtral) if moe else (TINY, make_llama)
    ref = deferred_init(make, cfg, device="cpu")
    bind_values(ref, materialize_module_cuda(ref, device="cpu"))
    want = _trajectory(ref, cfg, None)
    mesh = make_mesh(axes, device_type="cpu")
    model = deferred_init(make, cfg, device="cpu")
    plan = pipeline_plan_overrides(decoder_lm_plan(cfg), cfg.n_layers,
                                   n_chunks=2 if sched == "interleaved" else 1)
    bind_values(model, materialize_module_cuda(model, mesh=mesh, plan=plan),
                strict=False)
    kw = {"attn_fn": make_ring_flash_attention(mesh)} if "sp" in axes else {}
    got = _trajectory(model, cfg, mesh, pipeline=True, pipeline_schedule=sched,
                      n_microbatches=n_mb, **kw)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, err_msg="losses")
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, err_msg="norms")


def test_moe_over_sp_in_a_stage_raises(one_rank):
    """Nothing raises any more for a mixture of experts in a stage over
    ``sp`` (its routing spans the chunks): ``make_train_step`` and
    ``init_state`` take it, and a step gives a finite loss with a router
    loss."""
    mesh = make_mesh({"pp": 1, "sp": 1}, device_type="cpu")
    model = deferred_init(make_mixtral, TINY_MOE, device="cpu")
    plan = pipeline_plan_overrides(decoder_lm_plan(TINY_MOE),
                                   TINY_MOE.n_layers)
    bind_values(model, materialize_module_cuda(model, mesh=mesh, plan=plan),
                strict=False)
    init_state, train_step, shard_batch = make_train_step(
        model, TINY_MOE, device="cpu", mesh=mesh, pipeline=True,
        attn_fn=make_ring_flash_attention(mesh))
    toks = np.random.RandomState(0).randint(0, TINY_MOE.vocab_size, (B, S))
    _, metrics = train_step(init_state(model), shard_batch(toks))
    assert np.isfinite(float(metrics["loss"])) and float(metrics["aux"]) > 0
