"""Checkpoints written by several ranks: a pipeline's stages and an
asynchronous save.

One spawn of 2 gloo CPU ranks (file rendezvous under a tmp dir) runs:

* ``{pp 2}``, TINY llama at 4 layers under 1F1B from each stage's keyed
  values: a synchronous save after step 1 and an ``AsyncCheckpointSaver``
  save after step 2 (step 3 runs while it writes), each rank writing
  only its own layers' keys plus the replicated embed and head; each
  checkpoint restored in place on both stages and the next steps
  replayed: the losses bitwise equal.  The pytest process then loads the
  step-1 checkpoint whole into a ``mesh=None`` train state of the same
  model, and with no target: every key equal bit for bit to the stage
  that holds it, the manifest's leaf tree listing every key once;
* ``{fsdp 2}``: an async save whose rank-1 write is held back 1.5 s
  commits only after that write has finished, verifies and restores
  bitwise; one whose rank-1 write fails commits nothing and raises on
  both ranks.

No JAX at module level: the spawned ranks import this module.
"""

import json
import time
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torchdistx_tpu_torch import deferred_init, materialize_module
from torchdistx_tpu_torch.cuda_bridge import bind_values, materialize_module_cuda
from torchdistx_tpu_torch.models import TINY, make_llama
from torchdistx_tpu_torch.models.plans import decoder_lm_plan
from torchdistx_tpu_torch.parallel import make_mesh, make_train_step
from torchdistx_tpu_torch.parallel.pipeline import pipeline_plan_overrides
from torchdistx_tpu_torch.utils import checkpoint as ckpt
from torchdistx_tpu_torch.utils.checkpoint import (
    COMMIT_MARKER,
    AsyncCheckpointSaver,
    read_manifest,
    restore_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)

torch.set_num_threads(2)
LLAMA = TINY.replace(n_layers=4)
B, S, N_MB = 8, 16, 4


def _batches(n: int) -> list:
    rng = np.random.RandomState(5)
    return [rng.randint(0, LLAMA.vocab_size, (B, S)) for _ in range(n)]


def _flat_numpy(state) -> dict:
    return {k: v.detach().float().numpy().tolist()
            if isinstance(v, torch.Tensor) else v
            for k, v in ckpt._flat_dict(ckpt.checkpoint_tree(state)).items()}


def _pp(tmp: str, rank: int) -> dict:
    mesh = make_mesh({"pp": 2}, device_type="cpu")
    model = deferred_init(make_llama, LLAMA, device="cpu")
    bind_values(model, materialize_module_cuda(
        model, mesh=mesh, plan=pipeline_plan_overrides(
            decoder_lm_plan(LLAMA), LLAMA.n_layers, n_chunks=1)),
        strict=False)
    init_state, train_step, shard_batch = make_train_step(
        model, LLAMA, device="cpu", mesh=mesh, pipeline=True,
        pipeline_schedule="1f1b", n_microbatches=N_MB)
    state = init_state(model)
    batches = [shard_batch(b) for b in _batches(3)]

    def step(i):
        nonlocal state
        state, metrics = train_step(state, batches[i])
        return float(metrics["loss"])

    losses = [step(0)]
    save_checkpoint(f"{tmp}/pp_sync", state)
    with open(f"{tmp}/pp_stage_{rank}.json", "w") as f:
        json.dump(_flat_numpy(state), f)
    saver = AsyncCheckpointSaver()
    losses.append(step(1))
    saver.save(f"{tmp}/pp_async", state)
    losses.append(step(2))
    saver.wait_until_finished()
    saver.close()
    restore_checkpoint(f"{tmp}/pp_sync", target=state, verify=True)
    replay_sync = [state["step"], step(1), step(2)]
    restore_checkpoint(f"{tmp}/pp_async", target=state, verify=True)
    replay_async = [state["step"], step(2)]
    return {"losses": losses, "replay_sync": replay_sync,
            "replay_async": replay_async,
            "own_keys": sorted(ckpt._flat_dict(ckpt.checkpoint_tree(state)))}


def _fsdp(tmp: str, rank: int) -> dict:
    mesh = make_mesh({"fsdp": 2}, device_type="cpu")
    model = deferred_init(make_llama, TINY, device="cpu")
    bind_values(model, materialize_module_cuda(
        model, mesh=mesh, plan=decoder_lm_plan(TINY)))
    init_state, train_step, shard_batch = make_train_step(
        model, TINY, device="cpu", mesh=mesh)
    state = init_state(model)
    state, _ = train_step(state, shard_batch(_batches(1)[0]))
    write = ckpt._write_data_items
    out = {}

    def held_back(*args, **kw):
        time.sleep(1.5)
        results = write(*args, **kw)
        out["write_done"] = time.time()
        return results

    def failing(*args, **kw):
        raise OSError("disk gone")

    saver = AsyncCheckpointSaver()
    if rank == 1:
        ckpt._write_data_items = held_back
    saver.save(f"{tmp}/fsdp_async", state)
    saver.wait_until_finished()
    out["waited"] = time.time()
    if rank == 1:
        ckpt._write_data_items = failing
    try:
        saver.save(f"{tmp}/fsdp_failed", state)
        saver.wait_until_finished()
        out["failed_raised"] = None
    except BaseException as e:  # noqa: BLE001 — DCP raises a BaseException
        out["failed_raised"] = type(e).__name__
    finally:
        ckpt._write_data_items = write
    saver.close()
    want = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
            for k, v in ckpt._flat_dict(ckpt.checkpoint_tree(state)).items()}
    model2 = deferred_init(make_llama, TINY, device="cpu")
    bind_values(model2, materialize_module_cuda(
        model2, mesh=mesh, plan=decoder_lm_plan(TINY), seed=1))
    init2, _, _ = make_train_step(model2, TINY, device="cpu", mesh=mesh)
    other = init2(model2)
    restore_checkpoint(f"{tmp}/fsdp_async", target=other, verify=True)
    got = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
           for k, v in ckpt._flat_dict(ckpt.checkpoint_tree(other)).items()}
    out["restored_bitwise"] = sorted(got) == sorted(want) and all(
        torch.equal(got[k], want[k]) if isinstance(want[k], torch.Tensor)
        else got[k] == want[k] for k in want)
    return out


def _rank(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    warnings.simplefilter("ignore")  # absent axes of the plans
    try:
        out = {"pp": _pp(tmp, rank), "fsdp": _fsdp(tmp, rank)}
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/out-{rank}.json", "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_ranks")
    mp.start_processes(_rank, args=(2, str(tmp)), nprocs=2, join=True,
                       start_method="spawn")
    return tmp, [json.loads((tmp / f"out-{r}.json").read_text())
                 for r in range(2)]


def test_stage_checkpoints_resume_bitwise(runs):
    _, ranks = runs
    for r in ranks:
        pp = r["pp"]
        assert pp["losses"] == ranks[0]["pp"]["losses"]
        assert pp["replay_sync"] == [1, *pp["losses"][1:]]
        assert pp["replay_async"] == [2, pp["losses"][2]]
    own = [set(r["pp"]["own_keys"]) for r in ranks]
    assert any(k.startswith("params.blocks.0.") for k in own[0] - own[1])
    assert any(k.startswith("params.blocks.3.") for k in own[1] - own[0])
    assert "params.embed.weight" in own[0] & own[1]


def test_stage_checkpoint_loads_whole(runs):
    tmp, ranks = runs
    stages = [json.loads((tmp / f"pp_stage_{r}.json").read_text())
              for r in range(2)]
    for k in set(stages[0]) & set(stages[1]):  # replicated: equal on both
        assert stages[0][k] == stages[1][k], k
    union = {**stages[0], **stages[1]}
    paths = [e["path"] for e in read_manifest(tmp / "pp_sync")["tree"]]
    assert len(paths) == len(set(paths)) == len(union)
    assert verify_checkpoint(tmp / "pp_sync") == (True, "ok")
    model = deferred_init(make_llama, LLAMA, device="cpu")
    materialize_module(model, device="cpu")
    init_state, _, _ = make_train_step(model, LLAMA, device="cpu")
    whole = restore_checkpoint(tmp / "pp_sync", target=init_state(model))
    assert whole["step"] == 1
    got = _flat_numpy(whole)
    assert sorted(got) == sorted(union)
    assert paths == [e["path"] for e in ckpt._leaf_tree(
        ckpt.checkpoint_tree(whole))]
    for k, v in union.items():
        assert got[k] == v, k
    tree = ckpt._flat_dict(restore_checkpoint(tmp / "pp_sync"))
    assert sorted(tree) == sorted(union)
    for k, v in union.items():
        assert (tree[k].float().tolist() if isinstance(tree[k], torch.Tensor)
                else tree[k]) == v, k


def test_async_save_commits_after_every_rank_wrote(runs):
    tmp, ranks = runs
    fsdp = [r["fsdp"] for r in ranks]
    marker = (tmp / "fsdp_async" / COMMIT_MARKER).stat().st_mtime
    assert marker >= fsdp[1]["write_done"]
    assert fsdp[0]["waited"] >= fsdp[1]["write_done"]
    assert verify_checkpoint(tmp / "fsdp_async") == (True, "ok")
    assert all(f["restored_bitwise"] for f in fsdp)
    assert all(f["failed_raised"] is not None for f in fsdp)
    assert not (tmp / "fsdp_failed" / COMMIT_MARKER).exists()
