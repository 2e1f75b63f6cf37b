"""Operate a shared kernel-library registry directory (the port's
counterpart of the JAX package's ``tools/registry_ctl.py``).

The fleet-ops companion of :mod:`torchdistx_tpu_torch.registry`: entries
are immutable and content-addressed, so the operational surface is
inspection plus an age+atime GC sweep — no rewrite, no compaction.  The
entry layout is the JAX package's, so either package's tool reads
either package's registry and gives the same verdicts.

Subcommands (all take the registry root as their first argument and
print one JSON summary line last; human-readable detail goes to
stderr)::

    python -m torchdistx_tpu_torch.tools.registry_ctl ls     /nfs/tdx_registry
    python -m torchdistx_tpu_torch.tools.registry_ctl stats  /nfs/tdx_registry
    python -m torchdistx_tpu_torch.tools.registry_ctl verify /nfs/tdx_registry [--quarantine]
    python -m torchdistx_tpu_torch.tools.registry_ctl gc     /nfs/tdx_registry \\
        --max-age-days 30 [--min-atime-days 7] [--dry-run] [--keep-corrupt]

* ``ls`` — one line per complete entry: key, files, bytes, age,
  publishing host, program fingerprint.
* ``verify`` — run the store's OWN verification rule (manifest CRC32 +
  size + safe names) over every entry; corrupt entries are listed and,
  with ``--quarantine``, moved to ``<key>.corrupt`` exactly as a
  failing fetch would.  Exit status 1 when anything failed
  verification (quarantined or not).
* ``gc`` — delete entries whose manifest is older than
  ``--max-age-days`` AND whose payloads have not been read (atime) in
  ``--min-atime-days`` — a recently-fetched entry survives however old
  it is.  Filesystems mounted ``noatime`` degrade to a pure age sweep.
  Also removes quarantined ``<key>.corrupt`` dirs (kept with
  ``--keep-corrupt``) and stale ``.tmp-pub-*`` dirs from publishers that
  died mid-rename (older than one day).
* ``stats`` — totals: entries, bytes, corrupt/tmp counts, age range,
  per-host publish counts.

Everything here works on the directory contract alone (the standard
library only), so it runs on any host that mounts the registry.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
import zlib

_META = "meta.json"
_DAY_S = 86400.0
_TMP_MAX_AGE_S = _DAY_S  # a publisher's private dir should live seconds


def _entries(root):
    """(key, entry_dir, meta dict | None, state) for every non-special
    dir.  ``state`` is ``ok`` (manifest parsed), ``missing`` (no
    meta.json — a torn publish that never renamed), ``parse`` (the
    manifest exists but is not valid JSON — real corruption), or ``io``
    (the manifest exists but could not be READ this cycle).  The
    distinction matters: a transient shared-filesystem error must never
    make a live entry look like garbage — the store's own fetch path
    treats IO errors as a miss without quarantine for the same
    reason — while genuinely torn or corrupt manifests are fair game
    for gc/quarantine."""
    try:
        names = sorted(os.listdir(root))
    except OSError as e:
        raise SystemExit(f"cannot read registry root {root!r}: {e}")
    for name in names:
        path = os.path.join(root, name)
        if not os.path.isdir(path) or name.startswith("."):
            continue
        if name.endswith(".corrupt"):
            continue
        meta = None
        meta_path = os.path.join(path, _META)
        if not os.path.exists(meta_path):
            state = "missing"
        else:
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
                state = "ok" if isinstance(meta, dict) else "parse"
                if state == "parse":
                    meta = None
            except ValueError:
                state = "parse"
            except OSError:
                state = "io"
        yield name, path, meta, state


def _special_dirs(root):
    """(corrupt_dirs, tmp_dirs) — quarantined entries and torn publishes."""
    corrupt, tmp = [], []
    try:
        names = os.listdir(root)
    except OSError:
        return corrupt, tmp
    for name in sorted(names):
        path = os.path.join(root, name)
        if not os.path.isdir(path):
            continue
        if name.endswith(".corrupt"):
            corrupt.append(path)
        elif name.startswith(".tmp-pub-"):
            tmp.append(path)
    return corrupt, tmp


def _entry_bytes(meta) -> int:
    try:
        return sum(int(r["bytes"]) for r in meta["files"])
    except (KeyError, TypeError, ValueError):
        return 0


def _verify_entry(path: str, meta) -> "str | None":
    """None when the entry passes the store's verification rule; else a
    short reason.  The rule matches ArtifactRegistry._verified_files —
    CRC32 + declared size + safe names — so ctl and fetch can never
    disagree about what 'corrupt' means."""
    if meta is None:
        return "unreadable or missing manifest"
    recs = meta.get("files")
    if not isinstance(recs, list) or not recs:
        return "manifest lists no payload files"
    for rec in recs:
        try:
            name = rec["name"]
            want_bytes, want_crc = int(rec["bytes"]), int(rec["crc32"])
        except (KeyError, TypeError, ValueError):
            return "malformed manifest record"
        if (not name or os.sep in name or "/" in name
                or name.startswith(".") or name == _META):
            return f"unsafe payload name {name!r}"
        fpath = os.path.join(path, name)
        try:
            st = os.stat(fpath)
            with open(fpath, "rb") as f:
                data = f.read()
        except OSError as e:
            return f"payload {name} unreadable ({e.__class__.__name__})"
        # A cron'd verify must not count as "use": restore the payload's
        # atime so it cannot keep defeating gc's --min-atime-days idle
        # test forever (fetches, the real consumers, still refresh it).
        try:
            os.utime(fpath, (st.st_atime, st.st_mtime))
        except OSError:
            pass
        if len(data) != want_bytes or zlib.crc32(data) != want_crc:
            return f"payload {name} failed CRC32/size check"
    return None


def _age_atime(path: str, meta) -> "tuple[float, float]":
    """(age_s since publish, seconds since last payload read).  Publish
    time prefers the manifest's own stamp (rsync/copy preserves it),
    falling back to the manifest's — or, for torn manifest-less dirs,
    the directory's — mtime.  Idle time is the NEWEST *payload* atime:
    fetches read payloads, so one recent consumer keeps the whole entry;
    the manifest is excluded because this tool (and every ls/stats
    cron) reads it without that constituting use."""
    now = time.time()
    try:
        pub = float(meta.get("created")) if meta else None
    except (TypeError, ValueError):
        pub = None
    if pub is None:
        try:
            pub = os.stat(
                os.path.join(path, _META) if meta is not None else path
            ).st_mtime
        except OSError:
            pub = now
    last_read = 0.0
    try:
        for name in os.listdir(path):
            if name == _META:
                continue
            st = os.stat(os.path.join(path, name))
            last_read = max(last_read, st.st_atime)
    except OSError:
        last_read = now
    return now - pub, now - (last_read or now)


def cmd_ls(args) -> int:
    rows = []
    for key, path, meta, _state in _entries(args.root):
        age_s, idle_s = _age_atime(path, meta)
        row = {
            "key": key,
            "files": len(meta.get("files", [])) if meta else 0,
            "bytes": _entry_bytes(meta) if meta else 0,
            "age_days": round(age_s / _DAY_S, 2),
            "idle_days": round(idle_s / _DAY_S, 2),
            "host": (meta or {}).get("host"),
            "program_fp": (meta or {}).get("program_fp"),
            "complete": meta is not None,
        }
        rows.append(row)
        print(
            f"ls: {key[:16]} files={row['files']} bytes={row['bytes']} "
            f"age={row['age_days']}d idle={row['idle_days']}d "
            f"host={row['host']}", file=sys.stderr,
        )
    print(json.dumps({"entries": rows, "n": len(rows)}))
    return 0


def cmd_stats(args) -> int:
    n = n_bytes = incomplete = 0
    oldest = newest = None
    hosts: "dict[str, int]" = {}
    for _key, path, meta, _state in _entries(args.root):
        n += 1
        if meta is None:
            incomplete += 1
            continue
        n_bytes += _entry_bytes(meta)
        age_s, _ = _age_atime(path, meta)
        oldest = age_s if oldest is None else max(oldest, age_s)
        newest = age_s if newest is None else min(newest, age_s)
        host = str(meta.get("host"))
        hosts[host] = hosts.get(host, 0) + 1
    corrupt, tmp = _special_dirs(args.root)
    out = {
        "entries": n,
        "bytes": n_bytes,
        "incomplete": incomplete,
        "corrupt": len(corrupt),
        "tmp": len(tmp),
        "oldest_days": round(oldest / _DAY_S, 2) if oldest is not None else None,
        "newest_days": round(newest / _DAY_S, 2) if newest is not None else None,
        "hosts": hosts,
    }
    print(json.dumps(out))
    return 0


def cmd_verify(args) -> int:
    checked = failed = quarantined = skipped_io = 0
    bad = []
    for key, path, meta, state in _entries(args.root):
        checked += 1
        if state == "io":
            # Could be the filesystem, not the entry: report, never
            # quarantine — one NFS hiccup must not destroy a live
            # artifact the whole fleet cold-starts from.
            skipped_io += 1
            print(f"verify: SKIP {key[:16]} — manifest unreadable "
                  f"(transient IO error?)", file=sys.stderr)
            continue
        if state == "missing":
            reason = "missing manifest (torn publish)"
        elif state == "parse":
            reason = "manifest is not valid JSON"
        else:
            reason = _verify_entry(path, meta)
        if reason is None:
            continue
        failed += 1
        bad.append({"key": key, "reason": reason})
        print(f"verify: BAD {key[:16]} — {reason}", file=sys.stderr)
        if args.quarantine:
            dst = path + ".corrupt"
            try:
                if os.path.isdir(dst):
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    os.replace(path, dst)
                quarantined += 1
            except OSError as e:
                print(f"verify: could not quarantine {key[:16]}: {e}",
                      file=sys.stderr)
    print(json.dumps({
        "checked": checked, "failed": failed, "quarantined": quarantined,
        "skipped_io": skipped_io, "bad": bad,
    }))
    return 1 if failed else 0


def cmd_gc(args) -> int:
    max_age_s = args.max_age_days * _DAY_S
    min_atime_s = args.min_atime_days * _DAY_S
    swept = kept = 0
    freed = 0
    removed = []
    for key, path, meta, state in _entries(args.root):
        if state in ("io", "parse"):
            # io: could be the filesystem, not the entry — never sweep
            # on a transient error.  parse: real corruption, but
            # `verify --quarantine` owns that disposition; gc only
            # collects what verify/quarantine already moved aside.
            kept += 1
            continue
        age_s, idle_s = _age_atime(path, meta)
        # Incomplete entries (no manifest file at all) older than the
        # tmp horizon are torn publishes that never renamed; age-sweep
        # them too.
        dead = (
            (state == "missing" and age_s > _TMP_MAX_AGE_S)
            or (state == "ok"
                and age_s > max_age_s and idle_s > min_atime_s)
        )
        if not dead:
            kept += 1
            continue
        swept += 1
        freed += _entry_bytes(meta) if meta else 0
        removed.append(key)
        print(
            f"gc: {'would remove' if args.dry_run else 'removing'} "
            f"{key[:16]} (age {age_s / _DAY_S:.1f}d, idle "
            f"{idle_s / _DAY_S:.1f}d)", file=sys.stderr,
        )
        if not args.dry_run:
            shutil.rmtree(path, ignore_errors=True)
    corrupt, tmp = _special_dirs(args.root)
    n_corrupt = n_tmp = 0
    if not args.keep_corrupt:
        for path in corrupt:
            n_corrupt += 1
            if not args.dry_run:
                shutil.rmtree(path, ignore_errors=True)
    for path in tmp:
        try:
            if time.time() - os.stat(path).st_mtime < _TMP_MAX_AGE_S:
                continue  # a live publisher may still own it
        except OSError:
            continue
        n_tmp += 1
        if not args.dry_run:
            shutil.rmtree(path, ignore_errors=True)
    print(json.dumps({
        "swept": swept, "kept": kept, "bytes_freed": freed,
        "corrupt_removed": n_corrupt, "tmp_removed": n_tmp,
        "dry_run": bool(args.dry_run), "removed": removed,
    }))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("ls", "stats"):
        sp = sub.add_parser(name)
        sp.add_argument("root")
    sp = sub.add_parser("verify")
    sp.add_argument("root")
    sp.add_argument("--quarantine", action="store_true",
                    help="move failing entries to <key>.corrupt (what a "
                         "failing fetch would do)")
    sp = sub.add_parser("gc")
    sp.add_argument("root")
    sp.add_argument("--max-age-days", type=float, default=30.0)
    sp.add_argument("--min-atime-days", type=float, default=7.0,
                    help="entries read more recently than this survive "
                         "regardless of age")
    sp.add_argument("--dry-run", action="store_true")
    sp.add_argument("--keep-corrupt", action="store_true",
                    help="leave quarantined <key>.corrupt dirs for "
                         "forensics")
    args = p.parse_args(argv)
    return {"ls": cmd_ls, "stats": cmd_stats, "verify": cmd_verify,
            "gc": cmd_gc}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
