"""Build-at-first-use for the port's CUDA kernels, warm from a cache or a
registry where one holds them.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded
through ``ctypes``.  Nothing is built when a module is imported: the
first launch looks for the library in three places, in order:

1. the local cache (``TDX_CACHE_DIR``, by default
   ``torchdistx_tpu_torch/_build/``, ignored by git), under a name that
   is the library's content address — the registry key of the source,
   the flags and the build environment (:mod:`..registry.store`), so an
   edited source, another nvcc or another card never reuses a library;
2. the artifact registry (``TDX_REGISTRY_DIR``), whose verified copy is
   installed into the local cache;
3. ``nvcc``, whose library is then published to the registry.

Every local library has a CRC sidecar (``<lib>.so.crc``).  The library's
bytes are checked against it before ``ctypes.CDLL`` ever sees the file:
a damaged library (``ctypes.CDLL`` on one can crash the process instead
of raising) is quarantined (``<lib>.so.corrupt``) and fetched again, or
else rebuilt.  Registry trouble of any kind degrades to a local build.
nvcc's output (``-Xptxas -v``: registers, shared memory, spills) is kept
beside the library as ``.log`` and travels with it through the registry
(:func:`.ptxas.ptxas_table` reads it per kernel).
A failed build raises with nvcc's output.

One host library goes the same way: the native graph engine
(``torchdistx_tpu_torch/csrc/tdx_graph.cc``, :mod:`.._native`) is compiled
by the host C++ compiler (``CXX``, else ``c++``) with the Makefile's
``NATIVE_CXXFLAGS`` and no CUDA; its key composes the compiler's version
line, the platform and libc instead of nvcc and the card, so a host with
no GPU shares it with one that has a card.  A failed compile raises with
the compiler's output.

``counts`` holds this process's ``builds`` (compiler runs), ``local_hits``,
``fetches`` and ``quarantined`` files; ``outcomes`` each source's
``hit`` (no build) or ``miss`` (built here) and ``seconds`` the seconds
its lookup took.  The ``cache`` chaos site fires before each local
lookup (the source's 1-based number in the order the port added them:
flash attention 1, paged decode 2, the native engine 3, the keyed draws
4), with the cache directory as the target of a ``corrupt``.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
import zlib
from pathlib import Path
from typing import Dict, List

from .. import chaos, observe

CSRC = Path(__file__).resolve().parent / "csrc"
HOST_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# The Makefile's NATIVE_CXXFLAGS, and -shared.
NATIVE_CXXFLAGS = [
    "-std=c++17", "-O2", "-fPIC", "-fvisibility=hidden", "-Wall", "-Wextra",
    "-fstack-protector-strong", "-shared",
]
# The kernel sources.
SOURCES = ("flash_attention.cu", "paged_decode.cu", "keyed_rng.cu")
# The host-compiled sources (under HOST_CSRC).
HOST_SOURCES = ("tdx_graph.cc",)
# The ``cache`` chaos site's group numbers: a source's position + 1, in
# the order the sources were added to the port (so a plan written for an
# earlier tree names the same library).
_GROUP_ORDER = ("flash_attention.cu", "paged_decode.cu", "tdx_graph.cc",
                "keyed_rng.cu")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
counts: Dict[str, int] = {"builds": 0, "local_hits": 0, "fetches": 0,
                          "quarantined": 0}
outcomes: Dict[str, str] = {}
seconds: Dict[str, float] = {}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def is_host(source: str) -> bool:
    return source in HOST_SOURCES


def source_path(source: str) -> Path:
    return (HOST_CSRC if is_host(source) else CSRC) / source


def group(source: str) -> int:
    """The ``cache`` chaos site's group number of ``source``."""
    return _GROUP_ORDER.index(source) + 1


def flags(source: str) -> List[str]:
    return NATIVE_CXXFLAGS if is_host(source) else NVCC_FLAGS


def cxx_path() -> str:
    cxx = os.environ.get("CXX") or "c++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(
            f"no C++ compiler ({cxx!r}) on PATH; the native graph engine is "
            f"built from source at first use (set CXX)")
    return found


_cxx_version: Dict[str, str] = {}


def cxx_version() -> str:
    """The host compiler's version line (run once a process)."""
    cxx = cxx_path()
    v = _cxx_version.get(cxx)
    if v is None:
        proc = subprocess.run([cxx, "--version"], capture_output=True,
                              text=True)
        v = _cxx_version[cxx] = (proc.stdout.splitlines() or ["unknown"])[0]
    return v


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
            "CUDA kernels are built from source at first use"
        )
    return found


def cache_dir() -> Path:
    """The local library directory of the effective config."""
    from .. import config

    d = config.get().cache_dir
    return Path(d).absolute() if d else BUILD_DIR


def program_fp(source: str) -> str:
    """The hash of ``csrc/<source>`` and the flags it is built with (for
    a host source also its header and the compiler's version line)."""
    h = hashlib.sha256(source_path(source).read_bytes())
    h.update(" ".join(flags(source)).encode())
    if is_host(source):
        for header in sorted((HOST_CSRC / "include").glob("*.h")):
            h.update(header.read_bytes())
        h.update(cxx_version().encode())
    return h.hexdigest()


def library_key(source: str) -> str:
    """The registry key of ``csrc/<source>``'s library in this build
    environment."""
    from ..registry.store import host_registry_key, registry_key

    if is_host(source):
        return host_registry_key(program_fp(source))
    return registry_key(program_fp(source))


def library_path(source: str) -> Path:
    """Where ``csrc/<source>``'s library lives in the local cache."""
    return cache_dir() / f"{Path(source).stem}-{library_key(source)[:16]}.so"


def _sidecar(so: Path) -> Path:
    return so.with_name(so.name + ".crc")


def _write_sidecar(so: Path, nbytes: int, crc: int) -> None:
    side = _sidecar(so)
    tmp = side.with_name(f"{side.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    tmp.write_text(json.dumps({"bytes": nbytes, "crc32": crc}))
    os.replace(tmp, side)


def verified(so: Path) -> bool:
    """Whether ``so`` exists and its bytes match its CRC sidecar."""
    try:
        want = json.loads(_sidecar(so).read_text())
        data = so.read_bytes()
    except (OSError, ValueError):
        return False
    return (isinstance(want, dict) and len(data) == want.get("bytes")
            and zlib.crc32(data) == want.get("crc32"))


def _quarantine(so: Path) -> None:
    """Move a library that failed its check aside, sidecar dropped."""
    try:
        os.replace(so, so.with_name(so.name + ".corrupt"))
    except OSError:
        return
    _sidecar(so).unlink(missing_ok=True)
    counts["quarantined"] += 1
    observe.instant("build.quarantined", category="build", path=str(so))


def _registry():
    from .. import config

    root = config.get().registry_dir
    if not root:
        return None
    from ..registry.store import ArtifactRegistry

    return ArtifactRegistry(root)


def _compile(source: str, so: Path) -> None:
    """nvcc for a kernel source, the host compiler for a host source."""
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    compiler = cxx_path() if is_host(source) else nvcc_path()
    cmd: List[str] = [compiler, *flags(source), "-o", str(tmp),
                      str(source_path(source))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        name = Path(compiler).name
        raise RuntimeError(
            f"{name} failed to build {source} (exit {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}"
        )
    data = tmp.read_bytes()
    _write_sidecar(so, len(data), zlib.crc32(data))
    os.replace(tmp, so)  # atomic: concurrent builders race harmlessly


def build(source: str) -> Path:
    """The local path of ``csrc/<source>``'s library, its bytes checked
    against its sidecar: the local cache's copy, else the registry's
    (installed), else nvcc's (published)."""
    so = library_path(source)
    gno = group(source)
    t0 = time.perf_counter()
    with observe.span("build.library", category="build",
                      source=source) as sp:
        chaos.maybe_inject("cache", gno, path=str(so.parent))
        so.parent.mkdir(parents=True, exist_ok=True)
        outcome = "hit"
        reg = _registry()
        key = library_key(source)
        if verified(so):
            counts["local_hits"] += 1
        else:
            if so.exists():
                _quarantine(so)
            if reg is not None and _fetch(reg, key, so, gno):
                counts["fetches"] += 1
            else:
                _compile(source, so)
                counts["builds"] += 1
                outcome = "miss"
        if reg is not None:
            # After a hit too (a cache warmed before the registry existed
            # still gets shared); an entry already there is left alone.
            reg.publish_from_cache(
                key, str(so.parent), [so.name, so.with_suffix(".log").name],
                gno=gno, meta={"program_fp": program_fp(source),
                               "source": source})
        outcomes[source] = outcome
        seconds[source] = time.perf_counter() - t0
        sp.set(outcome=outcome)
    return so


def _fetch(reg, key: str, so: Path, gno: int) -> bool:
    """Install the registry's verified copy of ``key`` as ``so`` with its
    sidecar from the manifest's record; False on any miss."""
    if not reg.fetch_into_cache(key, str(so.parent), gno=gno):
        return False
    meta = reg.read_meta(key) or {}
    rec = next((r for r in meta.get("files", []) if r.get("name") == so.name),
               None)
    if rec is None:
        return False
    _write_sidecar(so, rec["bytes"], rec["crc32"])
    if verified(so):
        return True
    _quarantine(so)
    return False


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use.  The
    file is checked against its sidecar immediately before it is
    loaded; a library damaged since its lookup is quarantined and
    looked up again once."""
    lib = _libs.get(source)
    if lib is None:
        with _lock:
            lib = _libs.get(source)
            if lib is None:
                so = build(source)
                if not verified(so):
                    _quarantine(so)
                    so = build(source)
                    if not verified(so):
                        raise RuntimeError(
                            f"{so} fails its CRC check after a fresh lookup")
                lib = ctypes.CDLL(str(so))
                _libs[source] = lib
    return lib


def bring_up(sources) -> Dict[str, str]:
    """Load each of ``sources`` now; ``{source: "hit" | "miss"}``, a
    ``miss`` where this call ran nvcc for it (a library this process had
    loaded before is a ``hit``)."""
    out = {}
    for source in sources:
        before = source in _libs
        load(source)
        out[source] = "hit" if before else outcomes[source]
    return out
