"""Serving over a mesh (ROADMAP A6.6): a tensor-parallel replica against
the JAX package's replica over the same ``{tp 2}`` layout, and against the
port's own one-device replica.

One spawn of 2 gloo CPU ranks (file rendezvous under a tmp dir) runs
every case while the pytest process runs the JAX reference: the JAX
``spin_up_replica(mesh={tp 2}, plan=decoder_lm_plan(fsdp=None,
ep=None))`` of ``tiny`` and ``tiny-gpt2`` (2 of the 8 virtual CPU
devices), whose weights it hands the ranks as a torch state dict
(``from_flax_params``) before it serves.  The ranks import only torch;
this module imports no JAX at its top.  Held:

* the port's ``{tp 2}`` replica on the JAX replica's weights (installed
  into its shards by ``install_params``) gives the JAX ``{tp 2}``
  replica's tokens, final logits within ``JAX_ATOL`` on both ranks, the
  two ranks' results identical;
* ``spin_up_replica(mesh={tp 2})`` gives the tokens of ``mesh=None`` at
  the same seed, final logits within ``SELF_ATOL``, and its gathered
  values (``full_state_dict``) are bitwise the one-device replica's;
* the prefix cache, chunked prefill and speculation on ``{tp 2}`` give
  the tokens of ``mesh=None`` and count the same hits, chunks and verify
  ticks;
* a deadline that passes on rank 1's clock only and a ``serve@N=raise``
  installed on rank 1 only: both ranks cancel the same lane with the
  same tokens and requeue the same lanes, and the other requests' tokens
  equal ``mesh=None``'s;
* the refusals: a ``tp`` that does not divide the kv heads
  (``ValueError`` naming the parameter), an ``fsdp`` axis of 2 and a
  fleet over a mesh of 2 processes (``NotImplementedError`` naming
  A6.7);
* a fleet over a one-rank gloo ``{tp 1}`` gives the ``mesh=None``
  fleet's tokens.
"""

import json
import os
import time
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torchdistx_tpu_torch import chaos
from torchdistx_tpu_torch.cuda_bridge import bind_values, materialize_module_cuda
from torchdistx_tpu_torch.deferred_init import deferred_init
from torchdistx_tpu_torch.models import PRESETS, TINY
from torchdistx_tpu_torch.models.plans import decoder_lm_plan
from torchdistx_tpu_torch.parallel import make_mesh
from torchdistx_tpu_torch.serve import (
    FleetConfig,
    Request,
    ServeConfig,
    ServeEngine,
    ServeFleet,
    spin_up_replica,
)
from torchdistx_tpu_torch.serve.programs import make_model

torch.set_num_threads(2)

# The port's {tp 2} against the JAX {tp 2}: both f32, summing the two
# ranks' partial products in their own orders.
JAX_ATOL = 1e-5
# {tp 2} against the port's mesh=None: the same weights, the row-parallel
# sums split in two.
SELF_ATOL = 1e-5
PRESET_FAMILIES = {"tiny": "llama", "tiny-gpt2": "gpt2"}
SERVE = dict(max_batch=2, page_size=4, n_pages=16, max_pages_per_seq=4,
             prefill_buckets=(8,), prefix_cache=False, spec_decode=False)
# Every feature: a shared 8-token preamble (two full pages), a prompt
# longer than one chunk, speculation on.
FEATURES = dict(max_batch=2, page_size=4, n_pages=24, max_pages_per_seq=8,
                prefill_buckets=(8, 16), prefill_chunk=8, prefix_cache=True,
                spec_decode=True)
FAULTS = dict(SERVE, n_pages=32, max_pages_per_seq=8)
FAULT_AT, SLOW_AT, DEADLINE_S = 6, 3, 0.2
WAIT_S = 180.0


def _requests():
    return [Request("a", [1, 2, 3, 4, 5], max_new_tokens=6),
            Request("b", [9, 8, 7], max_new_tokens=6)]


def _feature_requests():
    pre = [11, 12, 13, 14, 15, 16, 17, 18]
    return [Request("f0", pre + [3, 1], max_new_tokens=8),
            Request("f1", pre + [3, 1], max_new_tokens=8, arrival_step=4),
            Request("f2", list(range(20, 40)), max_new_tokens=6),
            Request("f3", pre + [5], max_new_tokens=8, arrival_step=6)]


def _fault_requests(rank: int):
    # Rank 1's clock says "d" is past its deadline after the slow tick;
    # rank 0 gives it none.
    return [Request("d", [1, 3, 5, 7], max_new_tokens=20,
                    deadline_s=DEADLINE_S if rank == 1 else None),
            Request("c0", [4, 5, 6, 7], max_new_tokens=10),
            Request("c1", [8, 9, 10], max_new_tokens=10)]


def _served(eng) -> dict:
    return {"tokens": eng.results,
            "logits": {k: v.tolist() for k, v in eng.final_logits.items()}}


def _max_err(got: dict, want: dict) -> float:
    return max(float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max())
               for k in want)


def _spin_up_vs_none(mesh) -> dict:
    sc = ServeConfig(**SERVE)
    tp = spin_up_replica("tiny", mesh=mesh, serve_cfg=sc, device="cpu",
                         health_component="test-serve-mesh")
    ref = spin_up_replica("tiny", serve_cfg=sc, device="cpu",
                          health_component="test-serve-mesh")
    got, want = tp.run(_requests()), ref.run(_requests())
    full, whole = tp.full_state_dict(), ref.model.state_dict()
    return {"tokens": got, "want": want,
            "err": _max_err(tp.final_logits, ref.final_logits),
            "keys_equal": sorted(full) == sorted(whole),
            "bitwise": all(full[k].dtype == whole[k].dtype
                           and torch.equal(full[k], whole[k]) for k in whole),
            "local_kv_heads": tp.k_pages.shape[3],
            "local_wq_rows": tp.model.blocks[0].attn.wq.weight.shape[0]}


def _features(mesh) -> dict:
    out = {}
    for name, m in (("tp", mesh), ("none", None)):
        eng = spin_up_replica("tiny", mesh=m, serve_cfg=ServeConfig(
            **FEATURES), device="cpu", health_component="test-serve-mesh")
        out[name] = {"tokens": eng.run(_feature_requests()),
                     "counts": [eng.prefix_hits, eng.prefill_chunks,
                                eng.cow_copies, eng.spec_verify_ticks,
                                eng.spec_accepted]}
    return out


def _faults(mesh, rank: int) -> dict:
    eng = spin_up_replica("tiny", mesh=mesh, serve_cfg=ServeConfig(**FAULTS),
                          device="cpu", health_component="test-serve-mesh")
    cancels = []
    eng.on_cancel = lambda rid, toks, active: cancels.append(
        [rid, list(toks), active])
    if rank == 1:
        chaos.install(f"serve@{SLOW_AT}=slow:{2 * DEADLINE_S};"
                      f"serve@{FAULT_AT}=raise")
    try:
        got = eng.run(_fault_requests(rank))
    finally:
        chaos.clear()
    ref = spin_up_replica("tiny", serve_cfg=ServeConfig(**FAULTS),
                          device="cpu", health_component="test-serve-mesh")
    want = ref.run([r for r in _fault_requests(0) if r.rid != "d"])
    return {"tokens": got, "want": want, "cancels": cancels,
            "cancelled": eng.cancelled, "preemptions": eng.preemptions}


def _refusals(mesh) -> dict:
    out = {}
    cfg = TINY.replace(n_kv_heads=1)
    try:
        spin_up_replica(cfg, family="llama", mesh=mesh, device="cpu",
                        serve_cfg=ServeConfig(**SERVE),
                        health_component="test-serve-mesh")
        out["kv"] = None
    except ValueError as e:
        out["kv"] = str(e)
    fsdp = make_mesh({"fsdp": 2}, device_type="cpu")
    for what, call in (
            ("fsdp", lambda: spin_up_replica(
                "tiny", mesh=fsdp, device="cpu",
                serve_cfg=ServeConfig(**SERVE),
                health_component="test-serve-mesh")),
            ("fleet", lambda: ServeFleet("tiny", mesh=mesh, device="cpu",
                                         serve_cfg=ServeConfig(**SERVE)))):
        try:
            call()
            out[what] = None
        except NotImplementedError as e:
            out[what] = str(e)
    return out


def _fleet_tokens(mesh) -> dict:
    reqs = [Request(f"q{i}", [i + 1, 2 * i + 3, 7], max_new_tokens=5)
            for i in range(3)]
    fl = ServeFleet("tiny", mesh=mesh, device="cpu",
                    serve_cfg=ServeConfig(**SERVE),
                    fleet_cfg=FleetConfig(min_replicas=1, max_replicas=1,
                                          autoscale=False, stall_s=60.0))
    with fl:
        fl.start(1)
        out = fl.run([Request(r.rid, list(r.tokens), r.max_new_tokens)
                      for r in reqs])
        full = {k: v.clone() for k, v in fl.params.items()}
    return out, full


def _fleet(rank: int) -> dict:
    one = make_mesh({"dp": 2, "tp": 1}, device_type="cpu")["tp"]
    got, full = _fleet_tokens(one)
    want, whole = _fleet_tokens(None)
    return {"tokens": got, "want": want, "mesh_ranks": one.size(),
            "params_bitwise": sorted(full) == sorted(whole) and all(
                torch.equal(full[k], whole[k]) for k in whole)}


def _jax_weights(mesh, tmp: str, preset: str) -> dict:
    """The port's {tp 2} replica on the JAX replica's weights (a full
    state dict the pytest process writes), each rank taking its shard."""
    path = f"{tmp}/jax_{preset}.pt"
    deadline = time.monotonic() + WAIT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path}")
        time.sleep(0.05)
    sd = torch.load(path)
    family = PRESET_FAMILIES[preset]
    cfg = PRESETS[preset]
    plan = decoder_lm_plan(cfg, fsdp=None, ep=None)
    net = deferred_init(make_model, family, cfg, "cpu")
    bind_values(net, materialize_module_cuda(net, mesh=mesh, plan=plan,
                                             device="cpu"))
    eng = ServeEngine(family, cfg, net.eval(), serve_cfg=ServeConfig(**SERVE),
                      device="cpu", mesh=mesh, plan=plan)
    eng.install_params(sd)
    eng.run(_requests())
    return _served(eng)


def _rank(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)
    warnings.simplefilter("ignore")  # the plans' replicated-dim warnings
    try:
        mesh = make_mesh({"tp": world}, device_type="cpu")
        out = {"spin_up": _spin_up_vs_none(mesh), "features": _features(mesh),
               "faults": _faults(mesh, rank), "refusals": _refusals(mesh),
               "fleet": _fleet(rank)}
        out["jax"] = {p: _jax_weights(mesh, tmp, p) for p in PRESET_FAMILIES}
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/out-{rank}.json", "w") as f:
        json.dump(out, f)


def _jax_reference(tmp: str) -> dict:
    """The JAX {tp 2} replicas: their weights written for the ranks as
    soon as each is up, then their tokens and final logits."""
    import jax

    from torchdistx_tpu.models.plans import decoder_lm_plan as jax_plan
    from torchdistx_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from torchdistx_tpu.serve import Request as JaxRequest
    from torchdistx_tpu.serve import ServeConfig as JaxServeConfig
    from torchdistx_tpu.serve import spin_up_replica as jax_spin_up_replica
    from torchdistx_tpu_torch.models import from_flax_params

    mesh = jax_make_mesh({"tp": 2}, devices=jax.devices()[:2])
    engines = {}
    for preset, family in PRESET_FAMILIES.items():
        eng = jax_spin_up_replica(
            preset, mesh=mesh, plan=jax_plan(fsdp=None, ep=None), seed=0,
            serve_cfg=JaxServeConfig(**SERVE), warm=False,
            health_component="test-serve-mesh")
        sd = from_flax_params(family, PRESETS[preset],
                              jax.device_get(eng.params))
        torch.save(sd, f"{tmp}/jax_{preset}.pt.tmp")
        os.replace(f"{tmp}/jax_{preset}.pt.tmp", f"{tmp}/jax_{preset}.pt")
        engines[preset] = eng
    out = {}
    for preset, eng in engines.items():
        eng.run([JaxRequest(r.rid, r.tokens, max_new_tokens=r.max_new_tokens)
                 for r in _requests()])
        out[preset] = _served(eng)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("serve_mesh"))
    ctx = mp.start_processes(_rank, args=(2, tmp), nprocs=2, join=False,
                             start_method="spawn")
    try:
        jax_out = _jax_reference(tmp)
        while not ctx.join(timeout=1):
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = []
    for r in range(2):
        with open(f"{tmp}/out-{r}.json") as f:
            ranks.append(json.load(f))
    return jax_out, ranks


@pytest.mark.parametrize("preset", list(PRESET_FAMILIES))
def test_tp2_matches_the_jax_tp2_replica(runs, preset):
    jax_out, ranks = runs
    want = jax_out[preset]
    for r in ranks:
        got = r["jax"][preset]
        assert got["tokens"] == want["tokens"]
        assert _max_err(got["logits"], want["logits"]) <= JAX_ATOL
    assert ranks[0]["jax"][preset] == ranks[1]["jax"][preset]


def test_spin_up_over_tp2_is_the_one_device_replica(runs):
    _, ranks = runs
    for r in ranks:
        s = r["spin_up"]
        assert s["tokens"] == s["want"]
        assert s["err"] <= SELF_ATOL
        assert s["keys_equal"] and s["bitwise"]
        # tiny: KV 2, H 4, head 16 -> one kv head and 32 wq rows a rank.
        assert (s["local_kv_heads"], s["local_wq_rows"]) == (1, 32)
    assert ranks[0]["spin_up"] == ranks[1]["spin_up"]


def test_prefix_chunks_and_speculation_over_tp2(runs):
    _, ranks = runs
    for r in ranks:
        f = r["features"]
        assert f["tp"]["tokens"] == f["none"]["tokens"]
        assert f["tp"]["counts"] == f["none"]["counts"]
        hits, chunks, _, verify, _ = f["tp"]["counts"]
        assert hits >= 1 and chunks >= 2 and verify >= 1
    assert ranks[0]["features"] == ranks[1]["features"]


def test_one_ranks_deadline_and_fault_are_agreed(runs):
    _, ranks = runs
    for r in ranks:
        f = r["faults"]
        assert set(f["tokens"]) == {"c0", "c1"}
        assert {k: f["tokens"][k] for k in f["want"]} == f["want"]
        assert [c[0] for c in f["cancels"]] == ["d"]
        assert f["cancels"][0][2] is True  # cancelled mid-decode
        assert f["preemptions"] >= 1
    a, b = (r["faults"] for r in ranks)
    assert (a["cancels"], a["cancelled"], a["preemptions"]) == (
        b["cancels"], b["cancelled"], b["preemptions"])


def test_refusals(runs):
    _, ranks = runs
    for r in ranks:
        f = r["refusals"]
        assert f["kv"] is not None and "`blocks.0.attn.wk.weight`" in f["kv"]
        assert f["fsdp"] is not None and "A6.7" in f["fsdp"]
        assert f["fleet"] is not None and "A6.7" in f["fleet"]


def test_fleet_over_a_one_rank_mesh(runs):
    _, ranks = runs
    for r in ranks:
        f = r["fleet"]
        assert f["mesh_ranks"] == 1
        assert f["tokens"] == f["want"]
        assert f["params_bitwise"]
