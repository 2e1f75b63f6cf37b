"""Warm bring-up of the port's kernel libraries (``ops/_build.py``) through
the artifact registry, with a stub compiler standing in for nvcc.

The stub (``<tmp>/cuda/bin/nvcc``, found through ``CUDA_HOME`` as the
real one is) writes bytes derived from the source to ``-o`` and a ptxas
line to stderr.  Covered:

* a cold build publishes each library and its log; a fresh cache with
  the registry builds nothing and installs equal bytes; ``load`` hands
  ``ctypes.CDLL`` only files whose bytes match the registry's manifest;
* ``registry@1=corrupt`` quarantines the entry and builds locally;
  ``cache@1=corrupt`` quarantines the damaged libraries before any
  ``dlopen`` and fetches them again (or rebuilds without a registry);
* the sharded warm's outcomes (published, fetched, cached, stolen), the
  ``warm_cache`` tool's report lines, JSON and exit status, and two
  shards in two processes: disjoint builds, then a cold start with zero
  builds;
* the registry key composes the build environment; ``shard_owner`` and
  ``classify_warm_outcome`` equal the JAX package's over a table.
"""

import hashlib
import json
import os
import subprocess
import sys
import zlib

import pytest
import torch

from torchdistx_tpu.registry import scheduler as jax_sched
from torchdistx_tpu_torch import chaos, config, observe
from torchdistx_tpu_torch.ops import _build
from torchdistx_tpu_torch.registry import (
    ArtifactRegistry,
    classify_warm_outcome,
    env_fingerprint,
    registry_key,
    store,
    warm_sharded,
)
from torchdistx_tpu_torch.registry.scheduler import library_specs, shard_owner
from torchdistx_tpu_torch.tools import warm_cache

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = """#!{python}
import hashlib, os, sys
args = sys.argv[1:]
if "--version" in args:
    print("Cuda compilation tools, release 0.0, stub")
    sys.exit(0)
if os.environ.get("STUB_NVCC_FAIL"):
    print("stub: refused", file=sys.stderr)
    sys.exit(2)
src = open(args[-1], "rb").read()
with open(args[args.index("-o") + 1], "wb") as f:
    f.write(b"stub-library:" + hashlib.sha256(src).digest() * 64)
print("ptxas info    : Used 64 registers", file=sys.stderr)
"""


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """The stub compiler on ``CUDA_HOME``, fresh build state around."""
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text(STUB.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.delenv("STUB_NVCC_FAIL", raising=False)

    def fresh():
        _build._libs.clear()
        _build.outcomes.clear()
        _build.reset_counts()

    store._reset_env_key()
    fresh()
    observe.enable(True)
    observe.reset()
    yield fresh
    chaos.clear()
    observe.enable(None)
    fresh()
    store._reset_env_key()


def _env(tmp_path) -> dict:
    return {**os.environ, "CUDA_HOME": str(tmp_path / "cuda"),
            "PYTHONPATH": ROOT}


def _lookup(cache, reg, sources=_build.SOURCES) -> dict:
    with config.override(cache_dir=str(cache),
                         registry_dir=str(reg) if reg else None):
        return {s: _build.build(s) for s in sources}


class CDLLRecorder:
    """Stands in for ``ctypes.CDLL``: records the bytes of each file it
    is handed, at the moment it is handed them."""

    def __init__(self):
        self.seen = []

    def __call__(self, path):
        self.seen.append((os.path.basename(path), open(path, "rb").read()))
        return object()


def _manifest_crcs(reg) -> dict:
    return {rec["name"]: (rec["bytes"], rec["crc32"])
            for key in ArtifactRegistry(str(reg)).keys()
            for rec in ArtifactRegistry(str(reg)).read_meta(key)["files"]}


def test_cold_build_then_fresh_cache_is_warm(stub, tmp_path, monkeypatch):
    reg = tmp_path / "reg"
    cold = _lookup(tmp_path / "a", reg)
    assert _build.counts == {"builds": 2, "local_hits": 0, "fetches": 0,
                             "quarantined": 0}
    assert set(_build.outcomes.values()) == {"miss"}
    keys = ArtifactRegistry(str(reg)).keys()
    assert sorted(keys) == sorted(_build.library_key(s) for s in _build.SOURCES)
    assert sorted(_manifest_crcs(reg)) == sorted(
        n for so in cold.values() for n in (so.name, so.with_suffix(".log").name))
    assert {ArtifactRegistry(str(reg)).read_meta(k)["source"] for k in keys} \
        == set(_build.SOURCES)
    stub()
    warm = _lookup(tmp_path / "b", reg)
    assert _build.counts == {"builds": 0, "local_hits": 0, "fetches": 2,
                             "quarantined": 0}
    for s in _build.SOURCES:
        assert warm[s].name == cold[s].name
        assert warm[s].read_bytes() == cold[s].read_bytes()
        assert warm[s].with_suffix(".log").read_text() == \
            cold[s].with_suffix(".log").read_text()
        assert _build.verified(warm[s])
    stub()
    rec = CDLLRecorder()
    monkeypatch.setattr(_build.ctypes, "CDLL", rec)
    with config.override(cache_dir=str(tmp_path / "b"),
                         registry_dir=str(reg)):
        assert _build.bring_up(_build.SOURCES) == {
            s: "hit" for s in _build.SOURCES}
        assert _build.bring_up(_build.SOURCES) == {
            s: "hit" for s in _build.SOURCES}
    assert _build.counts["local_hits"] == 2 and _build.counts["builds"] == 0
    crcs = _manifest_crcs(reg)
    assert [n for n, _ in rec.seen] == [warm[s].name for s in _build.SOURCES]
    for name, data in rec.seen:
        assert (len(data), zlib.crc32(data)) == crcs[name]


def test_registry_corrupt_quarantines_then_builds(stub, tmp_path):
    reg = tmp_path / "reg"
    _lookup(tmp_path / "a", reg)
    stub()
    flash = _build.library_key("flash_attention.cu")
    chaos.install("registry@1=corrupt:flip")
    got = _lookup(tmp_path / "b", reg, ("flash_attention.cu",))
    assert _build.counts == {"builds": 1, "local_hits": 0, "fetches": 0,
                             "quarantined": 0}
    assert _build.outcomes["flash_attention.cu"] == "miss"
    assert os.path.isdir(os.path.join(str(reg), flash + ".corrupt"))
    # Rebuilt, republished, and the new entry verifies.
    fetched = ArtifactRegistry(str(reg)).fetch(flash)
    assert fetched[got["flash_attention.cu"].name] == \
        got["flash_attention.cu"].read_bytes()
    assert observe.counters().counter("tdx.registry.verify_fail").value == 1


@pytest.mark.parametrize("with_registry", [True, False])
def test_cache_corrupt_never_reaches_dlopen(stub, tmp_path, monkeypatch,
                                            with_registry):
    reg = tmp_path / "reg" if with_registry else None
    good = {s: p.read_bytes() for s, p in _lookup(tmp_path / "a", reg).items()}
    stub()
    rec = CDLLRecorder()
    monkeypatch.setattr(_build.ctypes, "CDLL", rec)
    chaos.install("cache@1=corrupt:flip")
    with config.override(cache_dir=str(tmp_path / "a"),
                         registry_dir=str(reg) if reg else None):
        for s in _build.SOURCES:
            _build.load(s)
    assert _build.counts["quarantined"] == 2
    assert _build.counts["fetches" if with_registry else "builds"] == 2
    assert _build.counts["builds" if with_registry else "fetches"] == 0
    assert len(rec.seen) == 2
    for (_name, data), s in zip(rec.seen, _build.SOURCES):
        assert data == good[s]
    corrupt = sorted(n for n in os.listdir(tmp_path / "a")
                     if n.endswith(".so.corrupt"))
    assert len(corrupt) == 2
    for n in corrupt:
        assert (tmp_path / "a" / n).read_bytes() not in good.values()


def test_warm_sharded_outcomes_and_a_steal(stub, tmp_path):
    reg = str(tmp_path / "reg")
    sources = _build.SOURCES
    first = warm_sharded(sources, str(tmp_path / "a"), registry_dir=reg)
    assert first["outcomes"] == {"published": 2} and first["unwarmed"] == []
    assert first["cache_entries"] == 2
    stub()
    second = warm_sharded(sources, str(tmp_path / "b"), registry_dir=reg)
    assert second["outcomes"] == {"fetched": 2}
    again = warm_sharded(sources, str(tmp_path / "b"), registry_dir=reg)
    assert again["outcomes"] == {"cached": 2}
    local = warm_sharded(sources, str(tmp_path / "c"))
    assert local["outcomes"] == {"compiled": 2}
    # Two hosts, this one waiting on a library the other never publishes.
    spec = library_specs(["flash_attention.cu"], str(tmp_path / "r2"))[0]
    other = shard_owner(spec.registry_key, 2)
    steals = observe.counters().counter("tdx.registry.steals")
    out = warm_sharded(["flash_attention.cu"], str(tmp_path / "d"),
                       registry_dir=str(tmp_path / "r2"), hosts=2,
                       host_id=1 - other, steal_after_s=0.2, poll_s=0.05)
    assert [r["outcome"] for r in out["program_reports"]] == ["stolen"]
    assert out["program_reports"][0]["owner"] == other
    assert steals.value == 1
    with pytest.raises(ValueError, match="registry"):
        warm_sharded(sources, str(tmp_path / "e"), hosts=2)


def test_warm_cache_tool_reports_and_exit_status(stub, tmp_path, capsys,
                                                 monkeypatch):
    reg = str(tmp_path / "reg")
    warm_cache.main(["--model", "gpt2-125m", "--cache-dir",
                     str(tmp_path / "a"), "--registry-dir", reg])
    cap = capsys.readouterr()
    summary = json.loads(cap.out.strip().splitlines()[-1])
    assert summary["outcomes"] == {"published": 2}
    assert summary["env"]["nvcc"].endswith("stub")
    assert summary["model"] == "gpt2-125m" and summary["path"] == "all"
    lines = [ln for ln in cap.err.splitlines() if ln.startswith("warm: ")]
    assert [ln.split()[1] for ln in lines] == [
        "program=flash_attention", "program=paged_decode"]
    assert all("outcome=published" in ln for ln in lines)
    stub()
    warm_cache.main(["--decode", "--cache-dir", str(tmp_path / "b"),
                     "--registry-dir", reg])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["program"] for r in summary["program_reports"]] == \
        ["paged_decode"]
    assert summary["outcomes"] == {"fetched": 1}
    stub()
    monkeypatch.setenv("STUB_NVCC_FAIL", "1")
    with pytest.raises(SystemExit) as exc:
        warm_cache.main(["--decode", "--cache-dir", str(tmp_path / "c")])
    assert exc.value.code == 1
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["unwarmed"] == ["paged_decode"]
    with pytest.raises(SystemExit):
        warm_cache.main(["--model", "no-such-model", "--cache-dir",
                         str(tmp_path / "d")])


def test_two_process_sharded_warm_then_cold_start(stub, tmp_path):
    reg = str(tmp_path / "reg")
    proc = subprocess.run(
        [sys.executable, "-m", "torchdistx_tpu_torch.tools.warm_cache",
         "--cache-dir", str(tmp_path / "shared"),
         "--registry-dir", reg, "--hosts", "2", "--spawn-shards",
         "--steal-after", "60", "--poll", "0.05"],
        cwd=ROOT, env=_env(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    docs = [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]
    assert docs[-1] == {"hosts": 2, "shard_rcs": [0, 0]}
    shards = sorted(docs[:-1], key=lambda d: d["host_id"])
    assert [d["host_id"] for d in shards] == [0, 1]
    built = [{r["program"] for r in d["program_reports"]
              if r["outcome"] in ("published", "compiled", "stolen")}
             for d in shards]
    assert not built[0] & built[1]
    assert built[0] | built[1] == {"flash_attention", "paged_decode"}
    for d in shards:
        for r in d["program_reports"]:
            assert (r["outcome"] == "published") == (r["owner"] == d["host_id"])
    cold = subprocess.run(
        [sys.executable, "-c",
         "import json; from torchdistx_tpu_torch.ops import _build; "
         "[_build.build(s) for s in _build.SOURCES]; "
         "print(json.dumps(_build.counts))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**_env(tmp_path), "TDX_CACHE_DIR": str(tmp_path / "cold"),
             "TDX_REGISTRY_DIR": reg})
    assert cold.returncode == 0, cold.stderr[-2000:]
    assert json.loads(cold.stdout.strip().splitlines()[-1]) == {
        "builds": 0, "local_hits": 0, "fetches": 2, "quarantined": 0}


def test_registry_key_composes_the_build_environment(monkeypatch):
    fp = "ab" * 32
    info = env_fingerprint()
    assert {"torch", "cuda", "nvcc", "nvcc_flags", "device_name",
            "compute_capability", "platform", "libc"} <= set(info)
    assert info["torch"] == torch.__version__
    assert "sm_90a" in info["nvcc_flags"]
    store._reset_env_key()
    k1 = registry_key(fp)
    assert k1 == registry_key(fp) and len(k1) == 40
    assert registry_key("cd" * 32) != k1
    for field, value in (("device_name", "another card"), ("nvcc", "12.0"),
                         ("libc", "musl")):
        monkeypatch.setattr(store, "env_fingerprint",
                            lambda f=field, v=value: {**info, f: v})
        store._reset_env_key()
        assert registry_key(fp) != k1, field
    monkeypatch.undo()
    store._reset_env_key()
    assert registry_key(fp) == k1


def test_shard_owner_and_outcomes_equal_the_reference():
    keys = [hashlib.sha1(str(i).encode()).hexdigest() for i in range(96)]
    for hosts in range(0, 9):
        assert [shard_owner(k, hosts) for k in keys] == \
            [jax_sched.shard_owner(k, hosts) for k in keys]
    for cache in ("hit", "miss", "bypass", "error"):
        for fetched in (False, True):
            for published in (False, True):
                assert classify_warm_outcome(
                    cache, fetched=fetched, published=published) == \
                    jax_sched.classify_warm_outcome(
                        cache, fetched=fetched, published=published)
