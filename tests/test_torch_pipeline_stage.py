"""Pipeline stages without a spawn: stage-owned keyed materialization, the
pipelined train step on a one-rank mesh, and the step's refusals.

* ``pipeline_plan_overrides`` on ``VirtualMesh`` coordinates: each stage
  holds its own layers whole (layer ``i`` on stage ``i // (L / pp)``;
  with 2 chunks a stage, chunk ``k`` on stage ``k % pp``) and the
  replicated entries, each as its shard of ``decoder_lm_plan``'s spec
  over the other axes (``{pp 2, fsdp 2, tp 2}``), draws no other
  stage's layers, and the stages' values equal the unsharded keyed
  values' shards bitwise (the mesh-invariance promise of
  ``torchdistx_tpu/__init__.py``);
* ``make_train_step(pipeline=True)`` on a one-rank gloo ``{pp: 1}`` mesh
  (one stage holding every layer; the interleaved ring of two chunks
  sends to itself), every schedule: 3 AdamW steps within 1e-5 of
  ``mesh=None`` on the same keyed values, with ``attn_fn=`` setting the
  stage's attention for each step, the blocks' own restored after it;
* a bad ``pipeline_schedule``, a schedule without ``pipeline``,
  ``pipeline`` without a ``pp`` axis, a ``pp`` axis without ``pipeline``
  and ``attn_fn`` without ``pipeline`` raise (``pp`` with the other axes
  trains: ``test_torch_pipeline_mesh*.py``).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torchdistx_tpu_torch import deferred_init
from torchdistx_tpu_torch.cuda_bridge import (
    bind_values,
    materialize_module_cuda,
)
from torchdistx_tpu_torch.cuda_bridge import materialize as mat
from torchdistx_tpu_torch.models import TINY, make_llama
from torchdistx_tpu_torch.models.plans import decoder_lm_plan
from torchdistx_tpu_torch.ops import make_flash_attention
from torchdistx_tpu_torch.parallel import VirtualMesh, make_mesh, make_train_step
from torchdistx_tpu_torch.parallel.pipeline import pipeline_plan_overrides
from torchdistx_tpu_torch.parallel.sharding import (
    layer_stage,
    local_shard,
    stage_layers,
)

torch.set_num_threads(2)

CFG = TINY.replace(n_layers=8)
B, S, STEPS, RTOL = 4, 16, 3, 1e-5


def _recording():
    return deferred_init(make_llama, CFG, device="cpu")


_OP_SEED = mat.op_seed


def _drawing(monkeypatch, seen: set):
    """Record the key of every random op the materializer replays."""
    def spy(seed, key_nr):
        seen.add(key_nr)
        return _OP_SEED(seed, key_nr)

    monkeypatch.setattr(mat, "op_seed", spy)


@pytest.mark.parametrize("axes,n_chunks", [({"pp": 2}, 1), ({"pp": 2}, 2),
                                           ({"pp": 4, "dp": 2}, 2),
                                           ({"pp": 2, "fsdp": 2, "tp": 2}, 1)],
                         ids=["pp2", "pp2-chunks2", "pp4-dp2-chunks2",
                              "pp2-fsdp2-tp2"])
def test_stage_owned_materialization(monkeypatch, axes, n_chunks):
    model = _recording()
    full = materialize_module_cuda(model, device="cpu")
    all_draws: set = set()
    _drawing(monkeypatch, all_draws)
    materialize_module_cuda(model, device="cpu")
    plan = pipeline_plan_overrides(decoder_lm_plan(CFG), CFG.n_layers,
                                   n_chunks=n_chunks)
    pp, L = axes["pp"], CFG.n_layers
    blocks = {n for n in full if n.startswith("blocks.")}
    light = set(full) - blocks
    gathered, draws = {}, {}
    for stage in range(pp):
        coord = {a: 0 for a in axes}
        coord["pp"] = stage
        seen: set = set()
        _drawing(monkeypatch, seen)
        got = materialize_module_cuda(model, mesh=VirtualMesh(axes, coord),
                                      plan=plan, device="cpu")
        draws[stage] = seen
        own = {i for ls in stage_layers(L, pp, stage, n_chunks) for i in ls}
        assert {n for n in got if n in blocks} == {
            n for n in blocks if int(n.split(".")[1]) in own}
        assert light <= set(got)
        for n in got:
            if n in blocks:
                i = int(n.split(".")[1])
                assert layer_stage(i, L, pp, n_chunks) == stage
                assert (i // (L // (pp * n_chunks))) % pp == stage
            gathered.setdefault(n, got[n])
            # Bitwise, every stage: this coordinate's shard over the
            # other axes (the whole entry where they do not shard it).
            spec = plan.spec_for(n, tuple(full[n].shape), axes)
            want = local_shard(full[n], spec, axes,
                               [coord[a] for a in axes])
            assert torch.equal(got[n], want), n
    assert set(gathered) == set(full)
    # No stage draws another stage's layers: the stages share only the
    # replicated entries' draws, and together they draw what one
    # unsharded materialization does.
    shared = set.intersection(*draws.values())
    per_stage = sum(len(d - shared) for d in draws.values())
    assert set.union(*draws.values()) == all_draws
    assert per_stage == len(all_draws - shared)


def _one_rank_mesh():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    return make_mesh({"pp": 1}, device_type="cpu")


def _trajectory(model, mesh, **kw):
    init_state, train_step, shard_batch = make_train_step(
        model, CFG, device="cpu", mesh=mesh, **kw)
    state = init_state(model)
    out = []
    for step in range(STEPS):
        toks = np.random.RandomState(step).randint(0, CFG.vocab_size, (B, S))
        state, metrics = train_step(state, shard_batch(toks))
        out.append(float(metrics["loss"]))
    return out


@pytest.mark.parametrize("sched", ["gpipe", "1f1b", "interleaved"])
def test_one_rank_pipeline_matches_unsharded(sched):
    ref = _recording()
    bind_values(ref, materialize_module_cuda(ref, device="cpu"))
    want = _trajectory(ref, None)
    mesh = _one_rank_mesh()
    try:
        model = _recording()
        plan = pipeline_plan_overrides(decoder_lm_plan(CFG), CFG.n_layers)
        bind_values(model, materialize_module_cuda(model, mesh=mesh,
                                                   plan=plan), strict=False)
        flash, calls = make_flash_attention(), []

        def counted(*args, **kw):
            calls.append(1)
            return flash(*args, **kw)

        own = [b.attn.attn_fn for b in model.blocks]
        got = _trajectory(model, mesh, pipeline=True, pipeline_schedule=sched,
                          n_microbatches=2, attn_fn=counted)
        assert len(calls) == CFG.n_layers * 2 * STEPS
        assert [b.attn.attn_fn for b in model.blocks] == own
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("axes,kw,err,what", [
    ({"pp": 1}, {"pipeline_schedule": "zero-bubble"}, ValueError, "gpipe"),
    ({"pp": 1}, {"pipeline": False, "pipeline_schedule": "1f1b"}, ValueError,
     "requires pipeline=True"),
    ({"dp": 1}, {}, ValueError, "needs a mesh with a 'pp' axis"),
    ({"pp": 1}, {"pipeline": False}, ValueError, "pass pipeline=True"),
    ({"pp": 1}, {"pipeline": False, "attn_fn": make_flash_attention()},
     ValueError, "constructor"),
], ids=["schedule", "schedule-no-pipeline", "no-pp-axis", "pp-no-pipeline",
        "attn-fn-no-pipeline"])
def test_pipeline_refusals(axes, kw, err, what):
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(axes, device_type="cpu")
        kw = {"pipeline": True, **kw}
        with pytest.raises(err, match=what):
            make_train_step(make_llama(TINY, device="cpu"), TINY,
                            device="cpu", mesh=mesh, **kw)
    finally:
        dist.destroy_process_group()
