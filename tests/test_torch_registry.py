"""The port's artifact registry store held against the JAX package's.

* the same sequences of operations go to both packages'
  ``ArtifactRegistry`` over two directories — publish, fetch,
  republish, a flipped and a truncated payload, a torn manifest, unsafe
  names, a publish still in flight, an install into a cache, a
  ``registry`` chaos fault — and reach the same return values, the same
  entries and quarantine folders on disk and the same
  ``tdx.registry.*`` counter deltas;
* concurrent publishers of one key, threads and processes, leave one
  winner and no partial entry;
* (the key schema, ``shard_owner`` and the outcome vocabulary are held
  in ``test_torch_registry_build.py``).
"""

import json
import os
import subprocess
import sys
import threading
import zlib

import pytest
import torch

from torchdistx_tpu import chaos as jax_chaos
from torchdistx_tpu import observe as jax_observe
from torchdistx_tpu.registry.store import ArtifactRegistry as JaxRegistry
from torchdistx_tpu_torch import chaos, observe
from torchdistx_tpu_torch.registry import ArtifactRegistry

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = "k" * 40
FILES = {"flash_attention-0123.so": b"library-bytes" * 16,
         "flash_attention-0123.log": b"ptxas info : Used 64 registers"}


@pytest.fixture(autouse=True)
def _counters():
    for obs in (observe, jax_observe):
        obs.enable(True)
        obs.reset()
    yield
    for obs in (observe, jax_observe):
        obs.reset()
        obs.enable(None)
    chaos.clear()
    jax_chaos.clear()


def _snap(obs) -> dict:
    return {r["name"]: r["value"] for r in obs.counters().snapshot()
            if r["type"] == "counter" and r["name"].startswith("tdx.registry")}


def _meta(reg, key):
    meta = reg.read_meta(key)
    return None if meta is None else {
        k: v for k, v in meta.items() if k not in ("created", "host", "pid")}


def _roundtrip(reg, pkg, tmp):
    return [reg.publish(KEY, FILES, {"program_fp": "fp", "source": "x.cu"}),
            reg.has(KEY), reg.fetch(KEY), _meta(reg, KEY),
            reg.publish(KEY, {"a.so": b"two"}), reg.fetch(KEY), reg.keys()]


def _absent(reg, pkg, tmp):
    return [reg.fetch("0" * 40), reg.has("0" * 40), reg.keys()]


def _damaged(reg, pkg, tmp):
    out = []
    for mode in ("flip", "truncate"):
        reg.publish(KEY, FILES)
        victims = pkg.corrupt_registry_dir(reg.root, mode=mode)
        out += [victims, reg.fetch(KEY), reg.has(KEY), reg.keys(),
                sorted(os.listdir(reg.root))]
    return out


def _torn(reg, pkg, tmp):
    edir = reg.entry_dir(KEY)
    os.makedirs(edir)
    with open(os.path.join(edir, "meta.json"), "w") as f:
        f.write('{"version": 1, "files": [{"na')
    return [reg.has(KEY), reg.fetch(KEY), reg.keys()]


def _in_flight(reg, pkg, tmp):
    inflight = os.path.join(reg.root, f".tmp-pub-{KEY[:16]}-999-1")
    os.makedirs(inflight)
    with open(os.path.join(inflight, "a.so"), "wb") as f:
        f.write(b"half-written payload")
    return [reg.has(KEY), reg.fetch(KEY), reg.keys()]


def _unsafe(reg, pkg, tmp):
    out = [reg.publish("g" * 40, {"../evil.so": b"x"}), reg.has("g" * 40),
           os.path.exists(os.path.join(tmp, "evil.so"))]
    edir = reg.entry_dir("h" * 40)
    os.makedirs(edir)
    with open(os.path.join(edir, "meta.json"), "w") as f:
        json.dump({"version": 1, "files": [
            {"name": "../../evil", "bytes": 1, "crc32": 0}]}, f)
    return out + [reg.fetch("h" * 40), reg.keys()]


def _install(reg, pkg, tmp):
    cache = os.path.join(tmp, "cache")
    out = [reg.fetch_into_cache(KEY, cache)]
    reg.publish(KEY, FILES)
    out += [reg.fetch_into_cache(KEY, cache), reg.fetch_into_cache(KEY, cache)]
    with open(os.path.join(cache, "flash_attention-0123.so"), "r+b") as f:
        f.write(b"X")  # a stale local copy: fetched and replaced
    out += [reg.fetch_into_cache(KEY, cache),
            {n: open(os.path.join(cache, n), "rb").read()
             for n in sorted(os.listdir(cache))}]
    return out


def _chaos_fault(reg, pkg, tmp):
    reg.publish(KEY, FILES)
    plan = pkg.parse_plan("registry@2=corrupt:flip;registry@3=raise")
    return [reg.fetch(KEY, gno=1, plan=plan), reg.fetch(KEY, gno=2, plan=plan),
            reg.has(KEY), reg.publish(KEY, FILES, gno=3, plan=plan),
            reg.publish(KEY, FILES, gno=4, plan=plan), reg.fetch(KEY)]


SEQUENCES = {
    "roundtrip": _roundtrip, "absent": _absent, "damaged": _damaged,
    "torn_manifest": _torn,
    "in_flight": _in_flight, "unsafe_names": _unsafe, "install": _install,
    "chaos": _chaos_fault,
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_store_matches_reference(name, tmp_path):
    got = {}
    for side, cls, pkg, obs in (("port", ArtifactRegistry, chaos, observe),
                                ("jax", JaxRegistry, jax_chaos, jax_observe)):
        tmp = tmp_path / side
        tmp.mkdir()
        before = _snap(obs)
        reg = cls(str(tmp / "reg"))
        out = SEQUENCES[name](reg, pkg, str(tmp))
        after = _snap(obs)
        listing = sorted(os.listdir(reg.root)) if os.path.isdir(reg.root) \
            else None
        got[side] = (out, listing,
                     {k: after[k] - before.get(k, 0) for k in after
                      if after[k] != before.get(k, 0)})
    assert got["port"] == got["jax"]
    assert got["port"][2], "each sequence moves a counter"


def test_concurrent_publish_single_winner(tmp_path):
    """Threads, then processes, race one key: one winner, its bytes
    whole, no tmp dir left."""
    reg = ArtifactRegistry(str(tmp_path / "threads"))
    results = {}
    barrier = threading.Barrier(4)

    def racer(i):
        barrier.wait()
        results[i] = reg.publish(KEY, {"a.so": bytes([i]) * 64})

    threads = [threading.Thread(target=racer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(results.values()) == 1
    got = reg.fetch(KEY)["a.so"]
    assert len(got) == 64 and len(set(got)) == 1
    assert [n for n in os.listdir(reg.root) if n.startswith(".tmp-")] == []

    reg_dir, go = str(tmp_path / "procs"), str(tmp_path / "go")
    script = f"""
import json, os, sys, time
sys.path.insert(0, {ROOT!r})
from torchdistx_tpu_torch.registry import ArtifactRegistry
tag = int(sys.argv[1])
reg = ArtifactRegistry({reg_dir!r})
while not os.path.exists({go!r}):
    time.sleep(0.001)
won = reg.publish("r" * 40, {{"a.so": bytes([tag]) * 256}}, {{"tag": tag}})
print(json.dumps({{"tag": tag, "won": won}}))
"""
    procs = [subprocess.Popen([sys.executable, "-c", script, str(tag)],
                              stdout=subprocess.PIPE, text=True)
             for tag in (7, 9)]
    with open(go, "w") as f:
        f.write("go")
    outs = [json.loads(p.communicate(timeout=120)[0].strip().splitlines()[-1])
            for p in procs]
    wins = [o for o in outs if o["won"]]
    assert len(wins) == 1, outs
    reg = ArtifactRegistry(reg_dir)
    meta, payload = reg.read_meta("r" * 40), reg.fetch("r" * 40)["a.so"]
    assert meta["tag"] == wins[0]["tag"]
    assert payload == bytes([meta["tag"]]) * 256
    assert zlib.crc32(payload) == meta["files"][0]["crc32"]
