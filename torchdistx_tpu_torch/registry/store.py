"""Content-addressed kernel-library store shared across hosts (the port's
own copy of ``torchdistx_tpu/registry/store.py``).

The local kernel cache (``TDX_CACHE_DIR``, :mod:`..ops._build`) makes a
second process on ONE host skip nvcc; this store does it across a
FLEET: hosts publish the kernel libraries they build into a shared
directory (``TDX_REGISTRY_DIR`` — NFS, a fuse mount, anything with
atomic rename), and every other host fetches, verifies and installs
them into its local cache instead of running nvcc again.

Key schema — an artifact is addressed by::

    registry_key = sha1(program_fp  ‖  env_key)

* ``program_fp`` (:func:`..ops._build.program_fp`) is the hash of one
  CUDA source and the nvcc flags it is built with;
* ``env_key`` (:func:`env_key`) pins the build environment: the torch
  and CUDA versions, nvcc's release line, the flags, the device name and
  compute capability, and the host platform with its libc.  Two hosts
  produce the same registry key iff the library one builds loads and
  runs correctly on the other.

Entry layout (one directory per key; the JAX package's, so its
``tools/registry_ctl.py`` reads a port registry)::

    <root>/<key>/meta.json            # files manifest (name, bytes,
                                      # crc32), env fingerprint, program_fp
    <root>/<key>/<stem>-<key16>.so    # payload: the library
    <root>/<key>/<stem>-<key16>.log   # nvcc's output (ptxas lines)

Contract:

* **publish is atomic** — payload + manifest are written to a private
  tmp directory and ``rename``\\ d into place, so a reader either sees a
  complete entry or no entry; concurrent publishers of one key race on
  the rename and exactly one wins (the loser discards its tmp dir).
* **fetch is self-verifying** — every payload file is CRC32-checked
  against the manifest; any mismatch QUARANTINES the entry
  (``<key>.corrupt``, kept for forensics) and reports a miss, so the
  caller degrades to a local build — registry trouble is never an
  error, only lost savings.
* **install lands under the local cache's own names** — the library's
  file name is its content address, so the next lookup of the same
  source in the same environment is an ordinary local hit.

Telemetry: ``tdx.registry.{publish,publish_races,publish_errors,
fetch_hit,fetch_miss,verify_fail,bytes_published,bytes_fetched,steals}``
counters and ``registry.publish`` / ``registry.fetch`` spans.  Chaos:
both operations run the ``registry`` fault site (kinds raise / slow /
corrupt, keyed by the 1-based library number).
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import shutil
import socket
import subprocess
import threading
import time
import zlib
from typing import Dict, List, Optional

from .. import chaos, observe
from ..utils.logging import get_logger

__all__ = [
    "ArtifactRegistry",
    "env_fingerprint",
    "env_key",
    "registry_key",
]

_META = "meta.json"


def _nvcc_release() -> str:
    """nvcc's ``release`` line (``Cuda compilation tools, release 12.9,
    V12.9.41``), or ``absent`` where there is no nvcc."""
    from ..ops import _build

    try:
        out = subprocess.run([_build.nvcc_path(), "--version"],
                             capture_output=True, text=True,
                             timeout=60).stdout
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return "absent"
    lines = [ln.strip() for ln in out.splitlines() if "release" in ln]
    return lines[-1] if lines else "unknown"


def env_fingerprint() -> Dict[str, str]:
    """The build-environment identity fields composed into every
    registry key.  Human-readable; stored verbatim in each entry's
    manifest so a mismatch is diagnosable, not just a different hash."""
    import torch

    from ..ops import _build

    info: Dict[str, str] = {
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "nvcc": _nvcc_release(),
        "nvcc_flags": " ".join(_build.NVCC_FLAGS),
    }
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        info["device_name"] = torch.cuda.get_device_name(0)
        info["compute_capability"] = f"{major}.{minor}"
    else:
        info["device_name"] = info["compute_capability"] = "none"
    info["platform"] = f"{platform.system()}-{platform.machine()}"
    info["libc"] = "-".join(v for v in platform.libc_ver() if v) or "unknown"
    return info


_env_key_lock = threading.Lock()
_env_key_cache: Optional[str] = None
_env_fp_cache: Optional[Dict[str, str]] = None


def _env_fingerprint_cached() -> Dict[str, str]:
    """Memoized :func:`env_fingerprint` (the build environment cannot
    change mid-process; per-publish recomputation would re-run nvcc for
    an identical dict)."""
    global _env_fp_cache
    with _env_key_lock:
        if _env_fp_cache is None:
            _env_fp_cache = env_fingerprint()
        return _env_fp_cache


def env_key() -> str:
    """sha1 digest of :func:`env_fingerprint`, memoized per process."""
    global _env_key_cache
    fp = _env_fingerprint_cached()
    with _env_key_lock:
        if _env_key_cache is None:
            h = hashlib.sha1(b"tdx-registry-env-v1")
            for k, v in sorted(fp.items()):
                h.update(f"{k}={v}\n".encode())
            _env_key_cache = h.hexdigest()
        return _env_key_cache


def _reset_env_key() -> None:
    """Drop the memoized env key (tests that change identity fields)."""
    global _env_key_cache, _env_fp_cache
    with _env_key_lock:
        _env_key_cache = None
        _env_fp_cache = None


def registry_key(program_fp: str) -> str:
    """The content address of one library's artifact in this
    environment: ``sha1(program_fp ‖ env_key)``."""
    h = hashlib.sha1(b"tdx-registry-key-v1")
    h.update(program_fp.encode())
    h.update(env_key().encode())
    return h.hexdigest()


def _safe_name(name: str) -> bool:
    """Whether a manifest-listed payload filename is safe to create under
    a cache directory (no separators, no dot-prefixed specials)."""
    return (
        bool(name)
        and "/" not in name
        and os.sep not in name
        and (os.altsep is None or os.altsep not in name)
        and not name.startswith(".")
        and name != _META
    )


class _VerifyError(ValueError):
    """A fetched entry failed self-verification (CRC/size/manifest)."""


def _warn(what: str, key: str, e: BaseException, then: str) -> None:
    get_logger().warning("registry: %s of %s failed (%s: %s); %s", what,
                         key[:12], type(e).__name__, str(e)[:120], then)


class ArtifactRegistry:
    """One shared registry directory.  Stateless — cheap to construct per
    operation; all durable state lives on the filesystem."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    # -- addressing --------------------------------------------------------

    def entry_dir(self, key: str) -> str:
        return os.path.join(self.root, key)

    def has(self, key: str) -> bool:
        """Whether a COMPLETE entry exists (publish renames the manifest
        into place with the payload, so manifest presence ⇒ complete)."""
        try:
            return os.path.isfile(os.path.join(self.entry_dir(key), _META))
        except OSError:
            return False

    def read_meta(self, key: str) -> Optional[dict]:
        """The entry's manifest, or None when absent/unreadable (never
        raises — a flaky shared filesystem degrades to a miss)."""
        try:
            with open(os.path.join(self.entry_dir(key), _META)) as f:
                doc = json.load(f)
            return doc if isinstance(doc, dict) else None
        except (OSError, ValueError):
            return None

    # -- publish -----------------------------------------------------------

    def publish(self, key: str, files: Dict[str, bytes],
                meta: Optional[dict] = None, *, gno: int = 1,
                plan=None) -> bool:
        """Atomically publish one artifact; True iff THIS call created the
        entry.  Losing a concurrent-publish race, an already-present
        entry, and any filesystem error all return False — publishing is
        an amenity, never a failure of the caller's build."""
        with observe.span(
            "registry.publish", category="registry", key=key[:12]
        ) as sp:
            try:
                chaos.maybe_inject("registry", gno, path=self.root, plan=plan)
                if self.has(key):
                    sp.set(outcome="present")
                    return False
                os.makedirs(self.root, exist_ok=True)
                tmp = os.path.join(
                    self.root,
                    f".tmp-pub-{key[:16]}-{os.getpid()}-{threading.get_ident()}",
                )
                n_bytes = 0
                try:
                    os.makedirs(tmp)
                    recs: List[dict] = []
                    for name, data in files.items():
                        if not _safe_name(name):
                            raise ValueError(f"unsafe payload name {name!r}")
                        with open(os.path.join(tmp, name), "wb") as f:
                            f.write(data)
                        recs.append({"name": name, "bytes": len(data),
                                     "crc32": zlib.crc32(data)})
                        n_bytes += len(data)
                    doc = {
                        "version": 1, "key": key, "files": recs,
                        "created": time.time(),
                        "host": socket.gethostname(), "pid": os.getpid(),
                        **(meta or {}),
                    }
                    with open(os.path.join(tmp, _META), "w") as f:
                        json.dump(doc, f)
                    # The atomic commit: renaming onto an existing
                    # non-empty dir fails, so exactly one publisher wins.
                    os.rename(tmp, self.entry_dir(key))
                except Exception as e:  # noqa: BLE001 — tmp must not leak
                    shutil.rmtree(tmp, ignore_errors=True)
                    if isinstance(e, OSError) and self.has(key):
                        observe.counter("tdx.registry.publish_races").inc()
                        sp.set(outcome="lost_race")
                        return False
                    raise
                observe.counter("tdx.registry.publish").inc()
                observe.counter("tdx.registry.bytes_published").inc(n_bytes)
                sp.set(outcome="published", bytes=n_bytes)
                return True
            except Exception as e:  # noqa: BLE001 — degrade, never fail the caller
                observe.counter("tdx.registry.publish_errors").inc()
                _warn("publish", key, e, "continuing without publishing")
                sp.set(outcome="error")
                return False

    def publish_from_cache(self, key: str, cache_dir: str,
                           names: List[str], *, gno: int = 1,
                           plan=None, meta: Optional[dict] = None) -> bool:
        """Publish the local cache files ``names`` (a library and its
        log) under ``key``.  A file missing from the cache is skipped;
        nothing is published when none is there."""
        if self.has(key):
            return False
        files: Dict[str, bytes] = {}
        for name in names:
            try:
                with open(os.path.join(cache_dir, name), "rb") as f:
                    files[name] = f.read()
            except OSError:
                get_logger().debug(
                    "registry: no local cache file %s to publish", name)
        if not files:
            return False
        doc = dict(meta or {})
        doc.setdefault("env", _env_fingerprint_cached())
        return self.publish(key, files, doc, gno=gno, plan=plan)

    # -- fetch -------------------------------------------------------------

    def fetch(self, key: str, *, gno: int = 1, plan=None
              ) -> Optional[Dict[str, bytes]]:
        """Payload bytes by filename, CRC32-verified against the manifest.

        ``None`` is a miss: absent entry, unreadable shared filesystem
        (degrade — the entry may be fine), or FAILED VERIFICATION (the
        entry is quarantined to ``<key>.corrupt`` and counted in
        ``tdx.registry.verify_fail``).  The caller builds locally."""
        with observe.span(
            "registry.fetch", category="registry", key=key[:12]
        ) as sp:
            try:
                chaos.maybe_inject("registry", gno, path=self.root, plan=plan)
                meta_path = os.path.join(self.entry_dir(key), _META)
                if not os.path.isfile(meta_path):
                    observe.counter("tdx.registry.fetch_miss").inc()
                    sp.set(outcome="miss")
                    return None
            except Exception as e:  # noqa: BLE001 — flaky shared fs: a miss
                observe.counter("tdx.registry.fetch_miss").inc()
                _warn("fetch", key, e, "building locally")
                sp.set(outcome="error")
                return None
            try:
                out, n_bytes = self._read_verified(key, meta_path)
            except (_VerifyError, ValueError, KeyError, TypeError) as e:
                # The entry itself is bad (torn manifest, CRC mismatch,
                # unsafe names): quarantine so no later process trips
                # over it, then degrade to a miss.
                moved = self.quarantine(key)
                observe.counter("tdx.registry.verify_fail").inc()
                observe.counter("tdx.registry.fetch_miss").inc()
                observe.instant(
                    "registry.verify_fail", category="registry",
                    key=key[:12], error=f"{type(e).__name__}: {e}"[:200],
                )
                get_logger().warning(
                    "registry: entry %s failed verification (%s: %s); "
                    "quarantined to %s and building locally",
                    key[:12], type(e).__name__, str(e)[:120],
                    moved or "(already gone)",
                )
                sp.set(outcome="verify_fail")
                return None
            except OSError as e:
                # Read error mid-fetch: could be the filesystem, not the
                # entry — miss WITHOUT quarantine.
                observe.counter("tdx.registry.fetch_miss").inc()
                _warn("fetch", key, e, "building locally")
                sp.set(outcome="error")
                return None
            observe.counter("tdx.registry.fetch_hit").inc()
            observe.counter("tdx.registry.bytes_fetched").inc(n_bytes)
            sp.set(outcome="hit", bytes=n_bytes)
            return out

    @staticmethod
    def _verified_files(base_dir: str, recs) -> Dict[str, bytes]:
        """Read the manifest-listed payload files from ``base_dir``,
        enforcing safe names and CRC32/size — THE verification rule,
        shared by the registry read and the installed-copy check so the
        two can never drift.  Raises :class:`_VerifyError` on any
        mismatch (IO errors propagate as OSError)."""
        if not isinstance(recs, list) or not recs:
            raise _VerifyError("manifest lists no payload files")
        out: Dict[str, bytes] = {}
        for rec in recs:
            name = rec["name"]
            if not _safe_name(name):
                raise _VerifyError(f"unsafe payload name {name!r}")
            with open(os.path.join(base_dir, name), "rb") as f:
                data = f.read()
            if len(data) != rec["bytes"] or zlib.crc32(data) != rec["crc32"]:
                raise _VerifyError(f"payload {name} failed CRC32/size check")
            out[name] = data
        return out

    def _read_verified(self, key: str, meta_path: str):
        with open(meta_path) as f:
            doc = json.load(f)
        out = self._verified_files(self.entry_dir(key), doc["files"])
        return out, sum(len(d) for d in out.values())

    def fetch_into_cache(self, key: str, cache_dir: str, *, gno: int = 1,
                         plan=None) -> bool:
        """Fetch → verify → install one artifact into ``cache_dir`` under
        its published names; True when it is there (fetched now, or
        already installed and passing the same verification rule — a
        stale or colliding local file falls through to the registry copy
        and is replaced, with no fetch counted otherwise)."""
        meta = self.read_meta(key)
        if meta is not None:
            try:
                self._verified_files(cache_dir, meta["files"])
                return True
            except (OSError, _VerifyError, ValueError, KeyError, TypeError):
                pass
        files = self.fetch(key, gno=gno, plan=plan)
        if files is None:
            return False
        try:
            os.makedirs(cache_dir, exist_ok=True)
            for name, data in files.items():
                # Atomic replace: concurrent installers write the same
                # verified bytes, and a reader never sees a torn file.
                dst = os.path.join(cache_dir, name)
                tmp = f"{dst}.tdx-tmp-{os.getpid()}-{threading.get_ident()}"
                try:
                    with open(tmp, "wb") as f:
                        f.write(data)
                    os.replace(tmp, dst)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
        except OSError as e:
            get_logger().warning(
                "registry: installing %s into %s failed (%s: %s)", key[:12],
                cache_dir, type(e).__name__, str(e)[:120])
            return False
        return True

    # -- hygiene -----------------------------------------------------------

    def quarantine(self, key: str) -> Optional[str]:
        """Move a bad entry aside (``<key>.corrupt``, kept for forensics);
        None when it already vanished or a prior quarantine holds the
        name (the bad dir is then just removed)."""
        edir = self.entry_dir(key)
        dst = edir + ".corrupt"
        try:
            if os.path.isdir(dst):
                shutil.rmtree(edir, ignore_errors=True)
                return None
            os.replace(edir, dst)
            return dst
        except OSError:
            return None

    def keys(self) -> List[str]:
        """All complete entry keys currently in the registry."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(n for n in names
                      if not n.startswith(".") and not n.endswith(".corrupt")
                      and self.has(n))
