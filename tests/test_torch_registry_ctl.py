"""The port's ``tools/registry_ctl.py`` held against the JAX package's.

Each case builds one registry tree with the port's store (entries of
kernel libraries and their logs, back-dated ones, a corrupt payload, a
quarantined entry, stale and live publishes in flight, a torn entry, a
manifest that cannot be read), copies it with its times, then runs the
same commands — ``ls``, ``stats``, ``verify [--quarantine]``, ``gc``
with ``--max-age-days`` / ``--min-atime-days`` / ``--dry-run`` /
``--keep-corrupt`` — through both tools, one tree each: equal exit
codes, equal JSON, equal trees after every command.  The cases mirror
``tests/test_registry_ctl.py``.
"""

import importlib.util
import json
import os
import shutil
import time

import pytest

from torchdistx_tpu_torch.registry import ArtifactRegistry
from torchdistx_tpu_torch.tools import registry_ctl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_registry_ctl", os.path.join(ROOT, "tools", "registry_ctl.py"))
jax_registry_ctl = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_registry_ctl)
DAY = 86400.0


def _publish(root, key, payload=b"x" * 64, meta=None):
    reg = ArtifactRegistry(str(root))
    assert reg.publish(key, {f"flash_attention-{key[:16]}.so": payload,
                             f"flash_attention-{key[:16]}.log": b"ptxas"},
                       meta or {"program_fp": "fp-" + key})


def _age(root, key, days, *, atime_days=None):
    edir = os.path.join(str(root), key)
    t = time.time() - days * DAY
    meta_path = os.path.join(edir, "meta.json")
    with open(meta_path) as f:
        doc = json.load(f)
    doc["created"] = t
    with open(meta_path, "w") as f:
        json.dump(doc, f)
    at = time.time() - (atime_days if atime_days is not None else days) * DAY
    for name in os.listdir(edir):
        os.utime(os.path.join(edir, name), (at, t))


def _old(*paths, days=2.0):
    t = time.time() - days * DAY
    for p in paths:
        os.utime(p, (t, t))


def _tree_a(root):
    """Fresh, old-and-idle, old-but-hot entries; one with a payload of
    the right size and the wrong CRC."""
    _publish(root, "a" * 40)
    _publish(root, "b" * 40, payload=b"y" * 128)
    _publish(root, "c" * 40)
    _publish(root, "d" * 40)
    _age(root, "b" * 40, days=40)
    _age(root, "c" * 40, days=40, atime_days=0.5)
    victim = root / ("d" * 40) / f"flash_attention-{'d' * 16}.so"
    victim.write_bytes(b"z" * 64)


def _tree_b(root):
    """A quarantined entry, a stale and a live publish in flight, a torn
    manifest-less entry, an unreadable manifest and a garbage one."""
    _publish(root, "a" * 40)
    corrupt = root / ("d" * 40 + ".corrupt")
    corrupt.mkdir()
    (corrupt / "junk").write_bytes(b"j")
    (root / ".tmp-pub-dead-1-2").mkdir()
    _old(root / ".tmp-pub-dead-1-2")
    (root / ".tmp-pub-live-3-4").mkdir()
    torn = root / ("e" * 40)
    torn.mkdir()
    (torn / "payload").write_bytes(b"p")
    _old(torn / "payload", torn)
    io = root / ("f" * 40)
    io.mkdir()
    (io / "payload").write_bytes(b"p")
    (io / "meta.json").mkdir()  # exists, open() raises: the transient shape
    _old(io / "payload", io / "meta.json", io, days=40)
    bad = root / ("g" * 40)
    bad.mkdir()
    (bad / "payload").write_bytes(b"p")
    (bad / "meta.json").write_text("{not json")


CASES = {
    "ls_stats_verify": (_tree_a, [
        ["ls"], ["stats"], ["verify"], ["verify", "--quarantine"],
        ["verify"], ["stats"]]),
    "gc_age_atime": (_tree_a, [
        ["gc", "--max-age-days", "30", "--min-atime-days", "7",
         "--dry-run"],
        ["gc", "--max-age-days", "30", "--min-atime-days", "7"], ["ls"]]),
    "verify_then_gc": (_tree_a, [
        ["verify"], ["gc", "--max-age-days", "30", "--min-atime-days", "7"],
        ["stats"]]),
    "specials": (_tree_b, [
        ["stats"], ["ls"], ["gc", "--max-age-days", "30", "--keep-corrupt"],
        ["verify", "--quarantine"], ["gc", "--max-age-days", "30"],
        ["stats"]]),
}


def _run(tool, capsys, argv):
    rc = tool.main(list(argv))
    captured = capsys.readouterr()
    return rc, json.loads(captured.out.strip().splitlines()[-1])


def _listing(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_registry_ctl_matches_reference(name, tmp_path, capsys):
    build, commands = CASES[name]
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir()
    build(ours)
    shutil.copytree(ours, theirs, copy_function=shutil.copy2)
    for p in ours.rglob("*"):  # directory times too, as copytree set them
        st = p.stat()
        os.utime(theirs / p.relative_to(ours), (st.st_atime, st.st_mtime))
    for argv in commands:
        got = _run(registry_ctl, capsys, [argv[0], str(ours), *argv[1:]])
        want = _run(jax_registry_ctl, capsys,
                    [argv[0], str(theirs), *argv[1:]])
        assert got == want, argv
        assert _listing(ours) == _listing(theirs), argv
