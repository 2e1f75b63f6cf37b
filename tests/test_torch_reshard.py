"""The port's reshard subsystem (``reshard/``) held against the JAX
package's.

* ``plan_from_manifest`` on a JAX-written manifest (params AND optax
  state, bfloat16 included) gives the JAX ``ReshardPlan``'s fields and
  ``describe()`` text, for the shrink / grow / axis-reshape pairs of the
  JAX tests (``tests/test_reshard.py::_PAIRS``);
* offline ``reshard_checkpoint`` of checkpoints written by gloo ranks
  (``{fsdp: 4}`` or ``{fsdp: 2}``, ``fsdp_plan``) to a device-free
  ``MeshSpec`` is bitwise (``verify_reshard``, and every value read
  back), lays each leaf out in plan B's shard blocks, and gives the
  destination the topology block the JAX engine gives it for the same
  pair;
* a leaf 64 times the chunk budget moves with the tracked host staging
  at most the budget (offline) and twice it (online, whose verify
  double-buffers);
* injected ``reshard``-site faults (raise, corrupt, slow; online
  corrupt; a raise while ``run_elastic`` reshards in flight) degrade and
  never corrupt: the source untouched and not quarantined, no committed
  destination, a typed ``ReshardError``;
* ``run_elastic`` resumed onto a smaller ({fsdp 4} → {fsdp 2}) and a
  larger ({fsdp 2} → {fsdp 4}) mesh reshards in flight and continues the
  uninterrupted trajectory bitwise; SIGTERM to a 4-rank run drains it
  (the ranks agree on the step), and fresh 2-rank processes resume on
  the half mesh bitwise.

Spawns: two rounds, each of a 4-rank and a 2-rank gloo group started
together (file rendezvous under a temporary directory).  No JAX at
module level: the spawned ranks import this module.
"""

import json
import os
import signal
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torchdistx_tpu_torch import chaos, config, observe, reshard
from torchdistx_tpu_torch.parallel import make_mesh
from torchdistx_tpu_torch.parallel.sharding import fsdp_plan, placements_for
from torchdistx_tpu_torch.reshard import MeshSpec, ReshardError
from torchdistx_tpu_torch.utils.checkpoint import (
    _read_metadata,
    read_manifest,
    restore_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)
from torchdistx_tpu_torch.utils.failures import run_elastic

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

PAIRS = {
    "shrink": ({"fsdp": 4}, "fsdp", {"fsdp": 2}, "fsdp"),
    "grow": ({"fsdp": 2}, "fsdp", {"fsdp": 4}, "fsdp"),
    "axis_reshape": ({"fsdp": 4}, "fsdp", {"fsdp": 2, "tp": 2}, "gspmd_2d"),
}
DRAIN_STEPS = 40


def _plan(kind, jax=False):
    if jax:
        from torchdistx_tpu.parallel import sharding as s
    else:
        from torchdistx_tpu_torch.parallel import sharding as s
    return (s.fsdp_plan(min_size=1) if kind == "fsdp"
            else s.gspmd_2d_plan(min_size=1))


def _base():
    return {"params": {
        "dense": {"kernel": torch.arange(96, dtype=torch.float32).reshape(8, 12),
                  "bias": torch.linspace(0.0, 1.0, 12).to(torch.bfloat16)},
        "embed": torch.arange(64, dtype=torch.float32).reshape(16, 4) * 0.25},
        "step": torch.tensor(7, dtype=torch.int32)}


def _distribute(tree, plan, mesh, prefix=""):
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: _distribute(v, plan, mesh, f"{prefix}{k}.")
                for k, v in tree.items()}
    spec = plan.spec_for(prefix[:-1], tuple(tree.shape), mesh)
    return distribute_tensor(tree, mesh, placements_for(spec, mesh))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _bits(t) -> str:
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes().hex()


def _toy(world):
    """The elastic toy state over {fsdp: world}: 32 float32 values
    sharded, and a step count."""
    from torch.distributed.tensor import Shard, distribute_tensor

    mesh = make_mesh({"fsdp": world}, device_type="cpu")
    return {"w": distribute_tensor(torch.arange(32, dtype=torch.float32),
                                   mesh, [Shard(0)]), "n": 0}


def _toy_step(state, batch):
    return {"w": state["w"] * 1.25 + batch, "n": state["n"] + 1}, {}


def _slow_step(tmp, rank):
    def step(state, batch):
        if not os.path.exists(f"{tmp}/started{rank}"):
            open(f"{tmp}/started{rank}", "w").close()
        time.sleep(0.05)
        return _toy_step(state, batch)
    return step


def _trajectory(n):
    w = np.arange(32, dtype=np.float32)
    for b in range(1, n + 1):
        w = w * np.float32(1.25) + np.float32(b)
    return w.tobytes().hex()


def _batches(n):
    return [float(b) for b in range(1, n + 1)]


def _reshards():
    return observe.counters().counter("tdx.reshard.elastic_reshards").value


def _round1(rank, world, tmp):
    out = {}
    if world == 4:
        mesh = make_mesh({"fsdp": 4}, device_type="cpu")
        save_checkpoint(f"{tmp}/src_fsdp4",
                        _distribute(_base(), _plan("fsdp"), mesh))
        out["steps"] = run_elastic(
            _toy_step, _toy(4), _batches(4), checkpoint_dir=f"{tmp}/el_shrink",
            checkpoint_every=2, probe_on_restart=False)[1]
        _write(tmp, "r1", rank, out)
        # SIGTERM arrives (from the test) while these steps run.
        run_elastic(_slow_step(tmp, rank), _toy(4), _batches(DRAIN_STEPS),
                    checkpoint_dir=f"{tmp}/drain", checkpoint_every=2,
                    exit_on_drain=True, probe_on_restart=False)
        raise AssertionError("ran to completion without a drain")
    mesh = make_mesh({"fsdp": 2}, device_type="cpu")
    save_checkpoint(f"{tmp}/src_fsdp2", _distribute(_base(), _plan("fsdp"), mesh))
    out["steps"] = run_elastic(
        _toy_step, _toy(2), _batches(2), checkpoint_dir=f"{tmp}/el_grow",
        checkpoint_every=2, probe_on_restart=False)[1]
    _write(tmp, "r1", rank, out)


def _resume(world, tmp, name, n):
    before = _reshards()
    state, steps, _ = run_elastic(
        _toy_step, _toy(world), _batches(n), checkpoint_dir=f"{tmp}/{name}",
        checkpoint_every=100, resume=True, probe_on_restart=False)
    return {"w": _bits(state["w"]), "n": state["n"], "steps": steps,
            "placements": [str(p) for p in state["w"].placements],
            "mesh": dict(zip(state["w"].device_mesh.mesh_dim_names,
                             state["w"].device_mesh.shape)),
            "elastic_reshards": _reshards() - before}


def _round2(rank, world, tmp):
    out = {}
    if world == 2:
        out["shrink"] = _resume(2, tmp, "el_shrink", 6)
        out["drain"] = _resume(2, tmp, "drain", DRAIN_STEPS)
        chaos.install("reshard@1=raise")
        try:
            run_elastic(_toy_step, _toy(2), _batches(6),
                        checkpoint_dir=f"{tmp}/el_shrink", resume=True,
                        probe_on_restart=False)
            out["chaos"] = "no error"
        except ReshardError as e:
            out["chaos"] = f"ReshardError: {e}"
        finally:
            chaos.clear()
    else:
        out["grow"] = _resume(4, tmp, "el_grow", 4)
    _write(tmp, "r2", rank, out)


def _write(tmp, stage, rank, out):
    with open(f"{tmp}/{stage}_w{dist.get_world_size()}_{rank}.json", "w") as f:
        json.dump(out, f)


def _rank(rank, world, tmp, stage):
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv_{stage}_{world}",
                            rank=rank, world_size=world)
    try:
        (_round1 if stage == "r1" else _round2)(rank, world, tmp)
    finally:
        dist.destroy_process_group()


def _start(tmp, stage, world):
    return mp.start_processes(_rank, args=(world, str(tmp), stage),
                              nprocs=world, join=False, start_method="spawn")


def _join(ctx, deadline):
    while not ctx.join(timeout=1):
        assert time.monotonic() < deadline, "ranks still running"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reshard_ranks")
    deadline = time.monotonic() + 240
    w4, w2 = _start(tmp, "r1", 4), _start(tmp, "r1", 2)
    _join(w2, deadline)
    while not all((tmp / f"started{r}").exists() for r in range(4)):
        assert time.monotonic() < deadline, "the drain run never started"
        for p in w4.processes:
            assert p.is_alive() or p.exitcode == 0, p.exitcode
        time.sleep(0.05)
    time.sleep(0.3)  # a few steps in
    for p in w4.processes:
        os.kill(p.pid, signal.SIGTERM)
    _join(w4, deadline)  # exit 0: the drain's clean exit
    w4, w2 = _start(tmp, "r2", 4), _start(tmp, "r2", 2)
    _join(w4, deadline)
    _join(w2, deadline)

    def read(stage, world):
        return [json.loads((tmp / f"{stage}_w{world}_{r}.json").read_text())
                for r in range(world)]

    return tmp, {"r1": {4: read("r1", 4), 2: read("r1", 2)},
                 "r2": {4: read("r2", 4), 2: read("r2", 2)}}


def _jax_state(axes, kind, optax_state):
    import jax
    import jax.numpy as jnp
    import optax

    from torchdistx_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from torchdistx_tpu.utils.checkpoint import leaf_storage_name

    b = {k: v for k, v in _leaves(_base()).items()}
    params = {"dense": {
        "kernel": jnp.asarray(b["params.dense.kernel"].numpy()),
        "bias": jnp.asarray(b["params.dense.bias"].float().numpy()
                            ).astype(jnp.bfloat16)},
        "embed": jnp.asarray(b["params.embed"].numpy())}
    tree = {"params": params, "step": jnp.int32(7)}
    if optax_state:
        tree["opt"] = optax.adamw(3e-4).init(params)
    n = int(np.prod(list(axes.values())))
    mesh = jax_make_mesh(dict(axes), devices=jax.devices()[:n])
    plan = _plan(kind, jax=True)
    flat, td = jax.tree_util.tree_flatten_with_path(tree)
    return jax.tree_util.tree_unflatten(td, [
        jax.device_put(leaf, plan.sharding_for(leaf_storage_name(kp),
                                               leaf.shape, mesh))
        for kp, leaf in flat])


def test_plan_from_manifest_matches_jax(tmp_path):
    from torchdistx_tpu.reshard import MeshSpec as JaxMeshSpec
    from torchdistx_tpu.reshard.diff import plan_from_manifest as jax_plan
    from torchdistx_tpu.utils.checkpoint import save_checkpoint as jax_save

    from torchdistx_tpu_torch.reshard.diff import plan_from_manifest

    for pair, (axes_a, kind_a, axes_b, kind_b) in PAIRS.items():
        src = tmp_path / pair
        jax_save(src, _jax_state(axes_a, kind_a, optax_state=True))
        manifest = json.loads((src / "tdx_manifest.json").read_text())
        want = jax_plan(str(src), manifest, _plan(kind_b, jax=True),
                        JaxMeshSpec(axes_b), budget_bytes=256)
        got = plan_from_manifest(str(src), manifest, _plan(kind_b),
                                 MeshSpec(axes_b), budget_bytes=256)
        assert [vars(lt) for lt in got.leaves] == \
            [vars(lt) for lt in want.leaves], pair
        assert (got.mesh_src, got.mesh_dst, got.src_digest, got.dst_digest) \
            == (want.mesh_src, want.mesh_dst, want.src_digest, want.dst_digest)
        assert got.describe() == want.describe()
        assert got.to_topology() == want.to_topology()
        assert "opt.0.mu.dense.kernel" in got.by_name


@pytest.mark.parametrize("pair", list(PAIRS))
def test_offline_reshard_bitwise(ranks, pair, tmp_path):
    from torchdistx_tpu import reshard as jax_reshard
    from torchdistx_tpu.utils.checkpoint import save_checkpoint as jax_save

    from torchdistx_tpu_torch.reshard.diff import leaf_blocks

    tmp, _ = ranks
    axes_a, _, axes_b, kind_b = PAIRS[pair]
    src = tmp / ("src_fsdp4" if axes_a == {"fsdp": 4} else "src_fsdp2")
    dst = reshard.reshard_checkpoint(src, _plan(kind_b), MeshSpec(axes_b),
                                     tmp_path / "dst")
    assert verify_checkpoint(dst) == (True, "ok")
    assert reshard.verify_reshard(src, dst) == (True, "ok")
    assert verify_checkpoint(src) == (True, "ok")
    got = restore_checkpoint(dst)
    assert {n: _bits(t) for n, t in _leaves(got).items()} == \
        {n: _bits(t) for n, t in _leaves(_base()).items()}
    plan = reshard.plan_reshard(src, _plan(kind_b), MeshSpec(axes_b))
    md = _read_metadata(dst)
    for lt in plan.leaves:
        grid = tuple(s // b for s, b in zip(lt.shape, lt.dst_block_shape))
        want = [tuple((lo, hi - lo) for lo, hi in box)
                for box in leaf_blocks(lt.shape, grid)]
        chunks = [tuple(zip(c.offsets, c.sizes))
                  for c in md.state_dict_metadata[lt.name].chunks]
        assert chunks == want, lt.name
    # The JAX engine on the same pair gives the destination the same
    # topology block.
    axes_a_, kind_a = PAIRS[pair][:2]
    jax_save(tmp_path / "jsrc", _jax_state(axes_a_, kind_a, optax_state=False))
    jdst = jax_reshard.reshard_checkpoint(
        tmp_path / "jsrc", _plan(kind_b, jax=True),
        jax_reshard.MeshSpec(axes_b), tmp_path / "jdst")
    assert read_manifest(dst)["topology"] == read_manifest(jdst)["topology"]
    assert read_manifest(dst)["tree"] == read_manifest(jdst)["tree"]


def test_transfer_peak_bounded_by_chunk_budget(tmp_path):
    big = {"w": torch.arange(262144, dtype=torch.float32).reshape(1024, 256),
           "step": torch.tensor(0, dtype=torch.int32)}
    save_checkpoint(tmp_path / "src", big)
    chunk_mb = 16 / 1024
    budget = int(chunk_mb * (1 << 20))
    assert big["w"].numel() * 4 == 64 * budget
    dst = reshard.reshard_checkpoint(
        tmp_path / "src", fsdp_plan(min_size=1), MeshSpec({"fsdp": 2}),
        tmp_path / "dst", chunk_mb=chunk_mb)
    assert 0 < reshard.last_transfer_peak_bytes() <= budget
    assert _bits(restore_checkpoint(dst)["w"]) == _bits(big["w"])
    target = {"w": torch.zeros(1024, 256), "step": torch.tensor(0, dtype=torch.int32)}
    with config.override(reshard_chunk_mb=chunk_mb):
        out = reshard.restore_resharded(tmp_path / "src", target)
    assert _bits(out["w"]) == _bits(big["w"]) and int(out["step"]) == 0
    assert not target["w"].any()  # a pytree target is not written
    assert 0 < reshard.last_transfer_peak_bytes() <= 2 * budget


def test_chaos_degrades_never_corrupts(ranks, tmp_path):
    tmp, outs = ranks
    src = tmp_path / "src"
    save_checkpoint(src, _base())
    mesh_b = MeshSpec({"fsdp": 2})
    for text in ("reshard@2=raise", "reshard@3=corrupt:flip"):
        before = observe.counters().counter("tdx.reshard.verify_fail").value
        chaos.install(text)
        try:
            with pytest.raises(ReshardError,
                               match="verify" if "corrupt" in text else None):
                reshard.reshard_checkpoint(src, fsdp_plan(min_size=1), mesh_b,
                                           tmp_path / "dst")
        finally:
            chaos.clear()
        assert verify_checkpoint(src) == (True, "ok")
        assert not (tmp_path / "dst").exists()
        assert not (tmp_path / "src.corrupt").exists()
        assert observe.counters().counter("tdx.reshard.verify_fail").value \
            == before + ("corrupt" in text)
    chaos.install("reshard@1=slow:0.01")
    try:
        dst = reshard.reshard_checkpoint(src, fsdp_plan(min_size=1), mesh_b,
                                         tmp_path / "dst")
    finally:
        chaos.clear()
    assert _bits(restore_checkpoint(dst)["params"]["embed"]) == \
        _bits(_base()["params"]["embed"])
    with pytest.raises(ReshardError, match="verify"):
        reshard.restore_resharded(
            src, _base(), chaos_plan=chaos.parse_plan("reshard@2=corrupt:flip"))
    # In flight under run_elastic (rank side): typed, nothing quarantined.
    for out in outs["r2"][2]:
        assert out["chaos"].startswith("ReshardError")
    assert verify_checkpoint(tmp / "el_shrink" / "step_4") == (True, "ok")
    assert not any(p.name.endswith(".corrupt")
                   for p in (tmp / "el_shrink").iterdir())


def test_elastic_resume_onto_smaller_and_larger_mesh(ranks):
    _, outs = ranks
    assert [o["steps"] for o in outs["r1"][4]] == [4] * 4
    assert [o["steps"] for o in outs["r1"][2]] == [2] * 2
    for out, n, axes in ((o["shrink"], 6, {"fsdp": 2}) for o in outs["r2"][2]):
        assert out["steps"] == n and out["n"] == n
        assert out["mesh"] == axes and out["placements"] == ["S(0)"]
        assert out["w"] == _trajectory(n) and out["elastic_reshards"] == 1
    for out in (o["grow"] for o in outs["r2"][4]):
        assert out["steps"] == 4 and out["mesh"] == {"fsdp": 4}
        assert out["w"] == _trajectory(4) and out["elastic_reshards"] == 1


def test_sigterm_drain_then_resume_on_half_mesh(ranks):
    tmp, outs = ranks
    drained = json.loads((tmp / "drain" / "CLEAN_EXIT.json").read_text())["step"]
    assert 1 <= drained < DRAIN_STEPS
    manifest = read_manifest(tmp / "drain" / f"step_{drained}")
    assert manifest["topology"]["mesh_axes"] == {"fsdp": 4}
    for out in (o["drain"] for o in outs["r2"][2]):
        assert out["steps"] == DRAIN_STEPS and out["elastic_reshards"] == 1
        assert out["w"] == _trajectory(DRAIN_STEPS)
