"""``python -m torchdistx_tpu_torch.tools.reshard_ctl``: plan, apply and
verify on a checkpoint of the port, without a GPU.

* ``plan`` prints the schedule the engine computes (leaves, chunks,
  bytes) and writes nothing;
* ``apply`` writes a committed destination under the named mesh and
  plan whose values restore equal to the source's, and ``verify`` of
  the pair exits 0;
* a failed ``apply`` (a ``reshard`` chaos fault flipping a chunk in
  flight) exits 1 and leaves no destination and the source intact; a
  destination damaged afterwards fails ``verify``; a directory that is
  no checkpoint fails ``plan``;
* the tool runs as a module in a fresh interpreter.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torchdistx_tpu_torch import chaos
from torchdistx_tpu_torch.parallel import gspmd_2d_plan
from torchdistx_tpu_torch.reshard import MeshSpec, plan_reshard
from torchdistx_tpu_torch.tools import reshard_ctl
from torchdistx_tpu_torch.utils.checkpoint import (
    is_committed,
    read_manifest,
    restore_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def ckpt(tmp_path):
    rng = np.random.RandomState(0)
    state = {"params": {"embed": torch.from_numpy(rng.randn(96, 40)).float(),
                        "w": torch.from_numpy(rng.randn(64, 48)).to(
                            torch.bfloat16),
                        "norm": torch.ones(40)},
             "step": 7}
    path = tmp_path / "step_7"
    save_checkpoint(path, state)
    yield path, state
    chaos.clear()


def _run(capsys, *argv):
    rc = reshard_ctl.main([str(a) for a in argv])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_plan_apply_verify(ckpt, tmp_path, capsys):
    src, state = ckpt
    rc, plan = _run(capsys, "plan", src, "--mesh", "fsdp=2,tp=2", "--plan",
                    "gspmd2d", "--chunk-mb", "0.004")
    want = plan_reshard(src, gspmd_2d_plan(min_size=0),
                        MeshSpec({"fsdp": 2, "tp": 2}), chunk_mb=0.004)
    assert rc == 0 and plan["ok"]
    assert (plan["leaves"], plan["chunks"], plan["bytes_total"],
            plan["bytes_moved"], plan["dst_digest"]) == (
        len(want.leaves), want.total_chunks, want.total_bytes,
        want.moved_bytes, want.dst_digest)
    assert plan["chunks"] > plan["leaves"]  # the budget splits blocks
    assert sorted(os.listdir(tmp_path)) == ["step_7"]
    dst = tmp_path / "to_2d"
    rc, out = _run(capsys, "apply", src, dst, "--mesh", "fsdp=2,tp=2",
                   "--plan", "gspmd2d", "--chunk-mb", "0.004")
    assert rc == 0 and out["ok"] and out["dst"] == str(dst)
    assert 0 < out["peak_host_bytes"] <= int(0.004 * (1 << 20))
    assert is_committed(dst) and verify_checkpoint(dst)[0]
    topo = read_manifest(dst)["topology"]
    assert topo["mesh_axes"] == {"fsdp": 2, "tp": 2}
    assert topo["specs"]["params.embed"] == "('fsdp', 'tp')"
    rc, out = _run(capsys, "verify", src, dst)
    assert rc == 0 and out == {"ok": True, "reason": "ok", "src": str(src),
                               "dst": str(dst)}
    got = restore_checkpoint(dst)
    for k, v in state["params"].items():
        assert torch.equal(got["params"][k], v)
    assert got["step"] == 7
    # Back to whole leaves on one device, by the default destination name.
    rc, out = _run(capsys, "apply", dst, "--mesh", "dp=1", "--plan",
                   "replicated")
    assert rc == 0 and os.path.basename(out["dst"]).startswith("to_2d.reshard-")
    assert _run(capsys, "verify", src, out["dst"])[0] == 0


def test_failed_apply_leaves_no_destination(ckpt, tmp_path, capsys):
    src, _ = ckpt
    dst = tmp_path / "dst"
    chaos.install("reshard@1=corrupt")
    rc, out = _run(capsys, "apply", src, dst, "--mesh", "fsdp=4", "--plan",
                   "fsdp", "--chunk-mb", "0.004")
    chaos.clear()
    assert rc == 1 and not out["ok"] and "verify" in out["error"]
    assert not dst.exists()
    assert verify_checkpoint(src) == (True, "ok")
    rc, out = _run(capsys, "apply", src, dst, "--mesh", "fsdp=4", "--plan",
                   "fsdp")
    assert rc == 0
    leaf = max((p for p in dst.iterdir() if p.suffix == ".distcp"),
               key=lambda p: p.stat().st_size)
    data = bytearray(leaf.read_bytes())
    data[len(data) // 2] ^= 0xFF
    leaf.write_bytes(bytes(data))
    rc, out = _run(capsys, "verify", src, dst)
    assert rc == 1 and not out["ok"]
    rc, out = _run(capsys, "plan", tmp_path / "nowhere", "--mesh", "fsdp=2")
    assert rc == 1 and not out["ok"]
    with pytest.raises(SystemExit):
        reshard_ctl.main(["plan", str(src), "--mesh", "fsdp=2", "--plan",
                          "gspmd2d"])


def test_runs_as_a_module(ckpt, tmp_path):
    src, _ = ckpt
    proc = subprocess.run(
        [sys.executable, "-m", "torchdistx_tpu_torch.tools.reshard_ctl",
         "apply", str(src), str(tmp_path / "m"), "--mesh", "fsdp=2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] and is_committed(tmp_path / "m")
