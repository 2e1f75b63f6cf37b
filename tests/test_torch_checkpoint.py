"""The port's sharded checkpoints (``utils/checkpoint.py``) held against
the JAX package's.

* On gloo ranks (one spawn of 4, a file rendezvous under a temporary
  directory), DTensor states laid out by ``fsdp_plan`` over ``{fsdp: 4}``
  and ``gspmd_2d_plan`` over ``{fsdp: 2, tp: 2}``: the manifest's leaf
  entries and its topology block (``mesh_axes``, ``specs``,
  ``plan_digest``) equal the JAX package's ``_leaf_tree`` and
  ``state_topology`` of the same values under the same plan and mesh
  shape (the JAX arrays on 4 of its 8 virtual CPU devices); the
  ``{fsdp: 4}`` checkpoint restored into the ``{fsdp: 2, tp: 2}`` layout
  on the same ranks gives every value bitwise, placed as the target.
* In one process: a round trip of tensors (bfloat16 and 0-d included)
  and plain values, with and without a target; truncate and flip caught
  by ``verify_checkpoint`` with the JAX reasons; quarantine naming; the
  async saver (a save is a snapshot: the state changed right after
  ``save`` returns does not reach the files; overlapping saves
  serialize); a train state saved before its first step and restored in
  place trains on bitwise.
No JAX at module level: the spawned ranks import this module.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torchdistx_tpu_torch import chaos, observe
from torchdistx_tpu_torch.models import TINY, make_llama
from torchdistx_tpu_torch.parallel import make_mesh, make_train_step
from torchdistx_tpu_torch.parallel.sharding import (
    fsdp_plan,
    gspmd_2d_plan,
    placements_for,
)
from torchdistx_tpu_torch.utils.checkpoint import (
    AsyncCheckpointSaver,
    checkpoint_version,
    quarantine_checkpoint,
    read_manifest,
    restore_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

WORLD = 4
LAYOUTS = {
    "fsdp4": ({"fsdp": 4}, "fsdp"),
    "fsdp2-tp2": ({"fsdp": 2, "tp": 2}, "gspmd_2d"),
}


def _plan(kind):
    return (fsdp_plan(min_size=1) if kind == "fsdp"
            else gspmd_2d_plan(min_size=1))


def _base():
    """The values of the JAX reshard tests' state, as numpy: f32 and
    bf16 leaves and an int32 step."""
    return {
        "params": {
            "dense": {"kernel": np.arange(96, dtype=np.float32).reshape(8, 12),
                      "bias": np.linspace(0.0, 1.0, 12, dtype=np.float32)},
            "embed": np.arange(64, dtype=np.float32).reshape(16, 4) * 0.25,
        },
        "step": np.int32(7),
    }


def _torch_state():
    b = _base()
    return {"params": {
        "dense": {"kernel": torch.from_numpy(b["params"]["dense"]["kernel"]),
                  "bias": torch.from_numpy(
                      b["params"]["dense"]["bias"]).to(torch.bfloat16)},
        "embed": torch.from_numpy(b["params"]["embed"])},
        "step": torch.tensor(7, dtype=torch.int32)}


def _distribute(tree, plan, mesh, prefix=""):
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: _distribute(v, plan, mesh, f"{prefix}{k}.")
                for k, v in tree.items()}
    name = prefix[:-1]
    spec = plan.spec_for(name, tuple(tree.shape), mesh)
    return distribute_tensor(tree, mesh, placements_for(spec, mesh))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _bits(t: torch.Tensor) -> str:
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes().hex()


def _rank(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    out = {}
    try:
        meshes = {name: make_mesh(axes, device_type="cpu")
                  for name, (axes, _) in LAYOUTS.items()}
        for name, (_, kind) in LAYOUTS.items():
            state = _distribute(_torch_state(), _plan(kind), meshes[name])
            save_checkpoint(f"{tmp}/{name}", state)
        # The {fsdp 4} checkpoint into the {fsdp 2, tp 2} layout.
        target = _distribute(
            {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor) else v)
             for k, v in _leaves(_torch_state()).items()},
            _plan("gspmd_2d"), meshes["fsdp2-tp2"])
        nested = {"params": {"dense": {
            "kernel": target["params.dense.kernel"],
            "bias": target["params.dense.bias"]},
            "embed": target["params.embed"]}, "step": target["step"]}
        got = restore_checkpoint(f"{tmp}/fsdp4", target=nested)
        out["restored"] = {n: _bits(t) for n, t in _leaves(got).items()}
        out["restored_placements"] = {
            n: [str(p) for p in t.placements] for n, t in _leaves(got).items()}
        out["target_placements"] = {
            n: [str(p) for p in t.placements] for n, t in _leaves(nested).items()}
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_ranks")
    mp.spawn(_rank, args=(WORLD, str(tmp)), nprocs=WORLD, join=True)
    return tmp, [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(WORLD)]


def _jax_state(axes, kind):
    """The same values as jax arrays laid out by the JAX package's plan
    of the same kind on ``axes`` (4 of the 8 virtual CPU devices)."""
    import jax
    import jax.numpy as jnp

    from torchdistx_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from torchdistx_tpu.parallel.sharding import (
        fsdp_plan as jax_fsdp_plan,
        gspmd_2d_plan as jax_gspmd_2d_plan,
    )
    from torchdistx_tpu.utils.checkpoint import leaf_storage_name

    plan = (jax_fsdp_plan(min_size=1) if kind == "fsdp"
            else jax_gspmd_2d_plan(min_size=1))
    mesh = jax_make_mesh(dict(axes), devices=jax.devices()[:4])
    b = _base()
    tree = {"params": {"dense": {
        "kernel": jnp.asarray(b["params"]["dense"]["kernel"]),
        "bias": jnp.asarray(b["params"]["dense"]["bias"]).astype(jnp.bfloat16)},
        "embed": jnp.asarray(b["params"]["embed"])},
        "step": jnp.int32(7)}
    flat, td = jax.tree_util.tree_flatten_with_path(tree)
    return jax.tree_util.tree_unflatten(td, [
        jax.device_put(leaf, plan.sharding_for(leaf_storage_name(kp),
                                               leaf.shape, mesh))
        for kp, leaf in flat])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_manifest_and_topology_equal_jax(ranks, layout):
    from torchdistx_tpu.utils import checkpoint as jax_ckpt

    tmp, _ = ranks
    axes, kind = LAYOUTS[layout]
    ok, reason = verify_checkpoint(tmp / layout)
    assert ok, reason
    manifest = read_manifest(tmp / layout)
    jstate = _jax_state(axes, kind)
    assert manifest["tree"] == jax_ckpt._leaf_tree(jstate)
    assert manifest["topology"] == jax_ckpt.state_topology(jstate)
    # Each rank wrote its own files (``__<rank>_<k>.distcp``).
    files = set(manifest["files"])
    assert ".metadata" in files
    assert {f.split("_")[2] for f in files - {".metadata"}} == \
        {str(r) for r in range(WORLD)}


def test_restore_into_another_sharding_on_gloo_ranks(ranks):
    _, outs = ranks
    want = {n: _bits(t) for n, t in _leaves(_torch_state()).items()}
    for r, out in enumerate(outs):
        assert out["restored"] == want, f"rank {r}"
        assert out["restored_placements"] == out["target_placements"]
    # the 2-D layout really differs from the 1-D one it was read from
    assert outs[0]["target_placements"]["params.dense.kernel"] == \
        ["S(1)", "S(0)"]


def test_round_trip_with_and_without_target(tmp_path):
    state = {**_torch_state(), "n": 3, "lst": [torch.ones(2), torch.zeros(())]}
    save_checkpoint(tmp_path / "c", state)
    assert verify_checkpoint(tmp_path / "c") == (True, "ok")
    assert checkpoint_version(tmp_path / "c").startswith("c@")
    target = {k: v for k, v in state.items()}
    got = restore_checkpoint(tmp_path / "c", target=target)
    assert got["n"] == 3 and isinstance(got["lst"], list)
    for name, t in _leaves({k: v for k, v in got.items()
                            if k not in ("n", "lst")}).items():
        assert _bits(t) == _bits(_leaves(state)[name]), name
        assert t is not _leaves(state)[name]  # new tensors, target untouched
    whole = restore_checkpoint(tmp_path / "c")
    assert whole["params"]["dense"]["bias"].dtype == torch.bfloat16
    assert torch.equal(whole["lst"][1], torch.zeros(()))
    assert whole["step"].dtype == torch.int32 and int(whole["step"]) == 7


@pytest.mark.parametrize("mode", ["truncate", "flip"])
def test_damage_caught_by_verify(tmp_path, mode):
    from torchdistx_tpu.utils import checkpoint as jax_ckpt

    big = {"w": torch.arange(4096, dtype=torch.float32)}
    save_checkpoint(tmp_path / "c", big)
    before = observe.counters().counter("tdx.ckpt.verify_fail").value
    victim = chaos.corrupt_checkpoint(tmp_path / "c", mode=mode)
    assert victim == "__0_0.distcp"
    ok, reason = verify_checkpoint(tmp_path / "c")
    assert not ok
    assert observe.counters().counter("tdx.ckpt.verify_fail").value == \
        before + 1
    # The JAX verifier gives the same reason on the same damaged files.
    assert jax_ckpt._verify(tmp_path / "c") == (False, reason)
    assert reason.startswith("size mismatch" if mode == "truncate"
                             else "crc mismatch")
    with pytest.raises(Exception, match="verification|mismatch"):
        restore_checkpoint(tmp_path / "c", target=big, verify=True)


def test_quarantine_naming(tmp_path):
    before = observe.counters().counter("tdx.ckpt.quarantined").value
    for n in range(3):
        save_checkpoint(tmp_path / "step_4", {"w": torch.ones(3) * n})
        got = quarantine_checkpoint(tmp_path / "step_4")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_4.corrupt", "step_4.corrupt.2", "step_4.corrupt.3"]
    assert got.name == "step_4.corrupt.3"
    assert observe.counters().counter("tdx.ckpt.quarantined").value == \
        before + 3


def test_async_saver_snapshots_and_serializes(tmp_path):
    state = {"w": torch.arange(64, dtype=torch.float32), "k": 1}
    with AsyncCheckpointSaver() as saver:
        saver.save(tmp_path / "a", state)
        state["w"].add_(100.0)  # after save returned: not in the files
        for i in range(3):
            saver.save(tmp_path / f"s{i}", {"v": torch.tensor(float(i))})
    got = restore_checkpoint(tmp_path / "a", target=state)
    assert torch.equal(got["w"], torch.arange(64, dtype=torch.float32))
    for i in range(3):
        assert verify_checkpoint(tmp_path / f"s{i}")[0]
        assert float(restore_checkpoint(tmp_path / f"s{i}")["v"]) == i


def test_train_state_restored_in_place_trains_on_bitwise(tmp_path):
    torch.manual_seed(0)
    model = make_llama(TINY, device="cpu")
    init_state, train_step, shard_batch = make_train_step(model, TINY,
                                                          device="cpu")
    state = init_state(model)
    save_checkpoint(tmp_path / "s0", state)  # before the first step
    manifest = read_manifest(tmp_path / "s0")
    names = {e["path"] for e in manifest["tree"]}
    assert "['opt']['step']['embed.weight']" in names
    assert "['opt']['exp_avg']['blocks.0.attn.wq.weight']" in names
    rng = np.random.RandomState(0)
    batches = [shard_batch(rng.randint(0, TINY.vocab_size, (2, 16)))
               for _ in range(3)]
    runs = []
    for _ in range(2):
        losses = []
        for b in batches:
            state, metrics = train_step(state, b)
            losses.append(float(metrics["loss"]))
        runs.append(losses)
        restored = restore_checkpoint(tmp_path / "s0", target=state)
        assert restored is state and state["step"] == 0
        assert float(state["opt"].state[state["params"][0]]["step"]) == 0.0
    assert runs[0] == runs[1]
    assert os.path.isdir(tmp_path / "s0")
