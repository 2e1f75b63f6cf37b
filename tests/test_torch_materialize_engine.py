"""The keyed materializer's engine (``cuda_bridge/materialize.py``,
``groups.py``, ``transport.py``) against the JAX bridge's on one torch
module recorded by each package:

* ``split_init_groups`` gives the JAX function's bins, and the
  program-count rule is the same;
* shard-local and full-entry replay bit for bit equal on ``VirtualMesh``
  coordinates, each the slice of ``mesh=None``, with the entries counted
  by path;
* the retry ladder on the reference cases that pass here: a raised plan
  survived with one retry counted, a group that exhausts its retries
  replayed by the last rung, the last rung's failure raised typed;
* the watchdog abandons a hung plan stage;
* resume: a run drained by SIGTERM and one that raised with no retries
  leave a progress manifest in the JAX layout, the rerun loads exactly
  the committed groups and is bitwise the clean run, a flipped payload
  is recomputed, a completed run sweeps the directory;
* ``TDX_MATERIALIZE_INIT_DTYPE``: exact where the contract is the init
  dtype, rounded through it otherwise, the payload stored narrow;
* ``corrupt`` at the ``compile`` site damages the kernel-library cache.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import torchdistx_tpu.config as jax_config
from torchdistx_tpu import chaos as jax_chaos
from torchdistx_tpu import observe as jax_observe
from torchdistx_tpu.deferred_init import deferred_init as jax_deferred_init
from torchdistx_tpu.jax_bridge import MaterializationError as JaxMatError
from torchdistx_tpu.jax_bridge import compile as jax_compile
from torchdistx_tpu.jax_bridge import materialize as jax_mat
from torchdistx_tpu.jax_bridge import materialize_module_jax
from torchdistx_tpu_torch import chaos, config, deferred_init, observe
from torchdistx_tpu_torch.cuda_bridge import groups
from torchdistx_tpu_torch.cuda_bridge import materialize as mat
from torchdistx_tpu_torch.cuda_bridge import (
    materialize_module_cuda,
    named_fake_tensors,
)
from torchdistx_tpu_torch.models import TINY, make_llama
from torchdistx_tpu_torch.models.plans import decoder_lm_plan
from torchdistx_tpu_torch.parallel import VirtualMesh
from torchdistx_tpu_torch.parallel.sharding import local_shard, mesh_shape

torch.set_num_threads(2)


class Hetero(torch.nn.Module):
    """Distinct layer widths: every chain a structural group of its own,
    above the engine's node threshold (the JAX chaos suite's module)."""

    def __init__(self, k: int = 10):
        super().__init__()
        w = [16 + 8 * i for i in range(k)]
        self.layers = torch.nn.ModuleList(
            torch.nn.Linear(w[i], w[(i + 1) % k]) for i in range(k))


class Mixed(torch.nn.Module):
    """Repeated and distinct structures, buffers and a tied weight."""

    def __init__(self):
        super().__init__()
        self.emb = torch.nn.Embedding(64, 24)
        self.blocks = torch.nn.ModuleList(
            torch.nn.Sequential(torch.nn.Linear(24, 24), torch.nn.LayerNorm(24))
            for _ in range(6))
        self.wide = torch.nn.Linear(24, 40)
        self.head = torch.nn.Linear(24, 64, bias=False)
        self.head.weight = self.emb.weight
        self.register_buffer("steps", torch.zeros(3, dtype=torch.int32))


@pytest.fixture(autouse=True)
def _clean():
    chaos.clear()
    jax_chaos.clear()
    mat.shard_local = True
    yield
    chaos.clear()
    jax_chaos.clear()
    mat.shard_local = True


def _port(module, **cfg):
    with config.override(**cfg):
        return materialize_module_cuda(module, device="cpu")


def _bitwise(a, b):
    assert list(a) == list(b)
    for n in a:
        assert a[n].dtype == b[n].dtype and torch.equal(a[n], b[n]), n


def _counter(name):
    return observe.counters().counter(name).value


def test_groups_are_the_jax_bins():
    for make in (Hetero, Mixed):
        ours = deferred_init(make)
        theirs = jax_deferred_init(make)
        f_ours = list(named_fake_tensors(ours).values())
        f_theirs = list(jax_mat.named_fake_tensors(theirs).values())
        n_ours, n_theirs = (len(groups.collect_nodes(f_ours)),
                            len(jax_compile.collect_nodes(f_theirs)))
        assert n_ours == n_theirs
        assert mat._pipeline_max_programs(n_ours) == \
            jax_mat._pipeline_max_programs(n_theirs)
        for k in (1, 2, 3, 8, mat._pipeline_max_programs(n_ours)):
            assert groups.split_init_groups(f_ours, k) == \
                jax_compile.split_init_groups(f_theirs, k), (make, k)
        assert (mat._plan_groups(f_ours) is None) == \
            (jax_mat._plan_pipeline(f_theirs) is None)
        # The fingerprint moves with the recording, not with the process.
        again = list(named_fake_tensors(deferred_init(make)).values())
        assert groups.group_fingerprint(f_ours) == \
            groups.group_fingerprint(again)


def test_shard_local_and_full_entry_paths_are_bitwise_equal():
    m = deferred_init(make_llama, TINY, device="cpu")
    plan = decoder_lm_plan(TINY)
    axes = {"fsdp": 2, "tp": 2}
    full = materialize_module_cuda(m, device="cpu")
    assert mat.last_run_stats()["local_entries"] == len(full)
    shape = mesh_shape(VirtualMesh(axes, {a: 0 for a in axes}))
    for coord in [(0, 0), (1, 1), (0, 1)]:
        mesh = VirtualMesh(axes, dict(zip(shape, coord)))
        local = materialize_module_cuda(m, mesh=mesh, plan=plan, device="cpu")
        stats = mat.last_run_stats()
        assert stats["local_entries"] == len(local) and not stats["full_entries"]
        mat.shard_local = False
        whole = materialize_module_cuda(m, mesh=mesh, plan=plan, device="cpu")
        stats = mat.last_run_stats()
        mat.shard_local = True
        assert stats["full_entries"] == len(whole) and not stats["local_entries"]
        _bitwise(local, whole)
        for n, v in local.items():
            spec = plan.spec_for(n, tuple(full[n].shape), shape)
            assert torch.equal(v, local_shard(full[n], spec, shape, coord)), n


LADDER = [
    # (plan, pipeline mode, retries, what both engines do)
    ("compile@1=raise;lower@2=slow:0.05", "auto", 2, "retried"),
    ("execute@2=raise x9", "auto", 1, "fallback"),
    ("compile@1=raise x9", "off", 1, "raises"),
]


@pytest.mark.parametrize("plan,mode,retries,outcome", LADDER,
                         ids=[c[3] for c in LADDER])
def test_ladder_outcomes_match_the_jax_engine(plan, mode, retries, outcome):
    ours, theirs = deferred_init(Hetero), jax_deferred_init(Hetero)
    with jax_config.override(materialize_pipeline="off"):
        jax_base = materialize_module_jax(theirs, seed=0)
    base = _port(ours)

    def run_jax():
        jax_chaos.install(plan)
        with jax_config.override(materialize_pipeline=mode, compile_workers=1,
                                 materialize_retries=retries):
            return materialize_module_jax(theirs, seed=0)

    def run_port():
        chaos.install(plan)
        return _port(ours, materialize_pipeline=mode,
                     materialize_retries=retries)

    if outcome == "raises":
        with pytest.raises(JaxMatError) as jerr:
            run_jax()
        with pytest.raises(mat.MaterializationError) as perr:
            run_port()
        assert perr.value.failed_groups == jerr.value.failed_groups == [0]
        assert not perr.value.drained and not jerr.value.drained
        return
    j_retries = jax_observe.counters().counter("tdx.jax.compile_retries").value
    j_fallbacks = jax_observe.counters().counter(
        "tdx.jax.pipeline_fallbacks").value
    p_retries = _counter("tdx.cuda.materialize_retries")
    got_jax, got = run_jax(), run_port()
    for n in jax_base:
        assert np.array_equal(np.asarray(got_jax[n]), np.asarray(jax_base[n]))
    _bitwise(got, base)
    stats = mat.last_run_stats()
    fell_back = jax_observe.counters().counter(
        "tdx.jax.pipeline_fallbacks").value - j_fallbacks
    assert stats["fallback"] == bool(fell_back) == (outcome == "fallback")
    if outcome == "retried":
        assert jax_observe.counters().counter(
            "tdx.jax.compile_retries").value - j_retries == 1
        assert _counter("tdx.cuda.materialize_retries") - p_retries == 1
        assert stats["retries"] == 1


def test_watchdog_and_corrupt_at_the_plan_sites(tmp_path):
    """A hung ``lower`` is abandoned past the deadline and retried;
    ``corrupt`` at ``compile`` damages the kernel-library cache."""
    m = deferred_init(Hetero)
    base = _port(m)
    cache = tmp_path / "cache"
    cache.mkdir()
    lib = cache / "keyed_rng-0123456789abcdef.so"
    lib.write_bytes(bytes(range(256)) * 4)
    chaos.install("compile@1=corrupt:flip")
    _bitwise(_port(m, cache_dir=str(cache)), base)
    assert lib.read_bytes() != bytes(range(256)) * 4
    chaos.install("lower@1=hang:30")
    kills = _counter("tdx.cuda.compile_watchdog_kills")
    t0 = time.perf_counter()
    got = _port(m, compile_deadline_s=1.0)
    assert time.perf_counter() - t0 < 20
    assert _counter("tdx.cuda.compile_watchdog_kills") >= kills + 1
    _bitwise(got, base)
    deadline = time.perf_counter() + 3
    while any(t.name.startswith("tdx-mat-") for t in threading.enumerate()):
        assert time.perf_counter() < deadline, "an abandoned stage leaked"
        time.sleep(0.05)


def _manifest(cdir):
    with open(os.path.join(cdir, "MATERIALIZE_PROGRESS.json")) as f:
        return json.load(f)


def test_drain_resume_crc_and_sweep_like_the_jax_engine(tmp_path):
    """A SIGTERM at group 3's plan drains both engines; each leaves its
    manifest (``version: 1``, ``out_NNNN.bin`` with CRC32s), resumes the
    groups it committed bitwise, recomputes a flipped payload and sweeps
    the directory when whole."""
    ours, theirs = deferred_init(Hetero), jax_deferred_init(Hetero)
    base = _port(ours)
    with jax_config.override(materialize_pipeline="off"):
        jax_base = materialize_module_jax(theirs, seed=0)
    plan = "compile@3=preempt;compile@3=slow:1.0"
    manifests = {}
    for who in ("jax", "port"):
        rdir = str(tmp_path / who)
        if who == "jax":
            jax_chaos.install(plan)
            with pytest.raises(JaxMatError) as err, jax_config.override(
                    materialize_resume_dir=rdir, compile_workers=1):
                materialize_module_jax(theirs, seed=0)
            jax_chaos.clear()
            cdir = rdir
        else:
            chaos.install(plan)
            with pytest.raises(mat.MaterializationError) as err:
                _port(ours, materialize_resume_dir=rdir)
            chaos.clear()
            cdir = os.path.join(rdir, "whole")
        e = err.value
        assert e.drained and e.resumable and e.completed_groups
        m = _manifest(cdir)
        assert m["version"] == 1 and len(m["groups"]) == len(e.completed_groups)
        rec = next(iter(m["groups"].values()))
        assert [o["file"] for o in rec["outputs"]] == [
            f"out_{j:04d}.bin" for j in range(len(rec["outputs"]))]
        assert all(set(o) == {"file", "shape", "dtype", "crc32"}
                   for o in rec["outputs"])
        manifests[who] = (cdir, e)
    # The port's rerun: one group's payload flipped, the rest resumed.
    cdir, e = manifests["port"]
    fp, rec = next(iter(_manifest(cdir)["groups"].items()))
    victim = os.path.join(cdir, fp, rec["outputs"][0]["file"])
    data = bytearray(open(victim, "rb").read())
    data[0] ^= 0xFF
    open(victim, "wb").write(bytes(data))
    before = _counter("tdx.cuda.groups_resumed")
    got = _port(ours, materialize_resume_dir=str(tmp_path / "port"))
    assert _counter("tdx.cuda.groups_resumed") - before == \
        len(e.completed_groups) - 1
    assert mat.last_run_stats()["resumed"] == len(e.completed_groups) - 1
    _bitwise(got, base)
    assert not os.path.exists(cdir)  # swept
    jdir, je = manifests["jax"]
    before = jax_observe.counters().counter("tdx.jax.groups_resumed").value
    with jax_config.override(materialize_resume_dir=jdir):
        got_jax = materialize_module_jax(theirs, seed=0)
    assert jax_observe.counters().counter("tdx.jax.groups_resumed").value \
        - before == len(je.completed_groups)
    for n in jax_base:
        assert np.array_equal(np.asarray(got_jax[n]), np.asarray(jax_base[n]))
    assert not os.path.exists(os.path.join(jdir, "MATERIALIZE_PROGRESS.json"))


def test_a_raised_group_without_retries_resumes_bitwise(tmp_path):
    """``execute@3=raise`` with no retries: groups 1 and 2 (and those
    after 3) committed, group 3 failed, the error raised without the last
    rung; the rerun resumes them and is the clean run bit for bit, on a
    virtual mesh coordinate's own subdirectory.  ``execute@2=raise``
    with 2 retries survives, bitwise."""
    m = deferred_init(make_llama, TINY, device="cpu")
    mesh = VirtualMesh({"fsdp": 2, "tp": 2}, {"fsdp": 1, "tp": 0})
    plan = decoder_lm_plan(TINY)
    base = materialize_module_cuda(m, mesh=mesh, plan=plan, device="cpu")
    rdir = str(tmp_path / "resume")
    chaos.install("execute@3=raise")
    with config.override(materialize_resume_dir=rdir, materialize_retries=0,
                         materialize_overlap_depth=1):
        with pytest.raises(mat.MaterializationError) as err:
            materialize_module_cuda(m, mesh=mesh, plan=plan, device="cpu")
    e = err.value
    assert {0, 1} <= set(e.completed_groups) and e.failed_groups == [2]
    assert e.resumable and not e.drained
    cdir = os.path.join(rdir, "fsdp1-tp0")
    assert len(_manifest(cdir)["groups"]) == len(e.completed_groups)
    chaos.clear()
    with config.override(materialize_resume_dir=rdir):
        got = materialize_module_cuda(m, mesh=mesh, plan=plan, device="cpu")
    assert mat.last_run_stats()["resumed"] == len(e.completed_groups)
    _bitwise(got, base)
    assert not os.path.exists(cdir)
    chaos.install("execute@2=raise x2")
    with config.override(materialize_retries=2):
        got = materialize_module_cuda(m, mesh=mesh, plan=plan, device="cpu")
    assert mat.last_run_stats()["retries"] == 2
    assert not mat.last_run_stats()["fallback"]
    _bitwise(got, base)


def test_init_dtype_transport_and_a_narrow_payload(tmp_path):
    m = deferred_init(Mixed)
    fakes = named_fake_tensors(m)
    base = _port(m)
    got = _port(m, materialize_init_dtype="bf16")
    for n, v in got.items():
        if isinstance(fakes[n], torch.nn.Parameter):
            assert torch.equal(v, base[n].to(torch.bfloat16).float()), n
        else:
            assert torch.equal(v, base[n]), n  # buffers keep their bytes
    with config.override(materialize_init_dtype="bf16"):
        exact = materialize_module_cuda(m, device="cpu",
                                        param_dtype=torch.bfloat16)
        plain = materialize_module_cuda(m, device="cpu",
                                        param_dtype=torch.bfloat16)
    _bitwise(exact, plain)
    with pytest.raises(ValueError, match="not a dtype"):
        _port(m, materialize_init_dtype="bogus")
    # The payload of an interrupted run holds the parameters in bf16.
    chaos.install("execute@2=raise")
    rdir = str(tmp_path / "r")
    with pytest.raises(mat.MaterializationError):
        _port(m, materialize_init_dtype="bf16", materialize_resume_dir=rdir,
              materialize_retries=0)
    cdir = os.path.join(rdir, "whole")
    dtypes = {o["dtype"] for rec in _manifest(cdir)["groups"].values()
              for o in rec["outputs"]}
    assert "bfloat16" in dtypes and "float32" not in dtypes
    chaos.clear()
    again = _port(m, materialize_init_dtype="bf16", materialize_resume_dir=rdir)
    _bitwise(again, got)

