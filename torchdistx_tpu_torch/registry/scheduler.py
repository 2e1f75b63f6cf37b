"""Sharded multi-host warm over the artifact registry (the port's own copy
of ``torchdistx_tpu/registry/scheduler.py``).

The port's only compiled artifacts are its nvcc-built kernel libraries
(:mod:`..ops._build`), so a warm set is a list of library specs: a CUDA
source and its flags.  Across a fleet the list is split deterministically
— each library's registry key hashes to one *owner* (:func:`shard_owner`,
the reference's partition) — so every host builds exactly its owned
subset and publishes, then fills the rest from the registry.

Liveness: a library whose owner never publishes (dead host, wedged nvcc)
is **stolen** after ``steal_after_s`` — the waiting host builds it and
publishes it for everyone else (``tdx.registry.steals``).  A dead host
therefore degrades the warm to extra local builds; it never hangs it.

Drive it via ``python -m torchdistx_tpu_torch.tools.warm_cache --hosts N
--host-id i --registry-dir /shared/registry`` (one invocation per host,
any launch order), or in-process via :func:`warm_sharded`.  The JAX
package's ``plan_group_specs`` has no counterpart: the port compiles no
init programs.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import observe
from ..utils.logging import get_logger
from .store import ArtifactRegistry

__all__ = [
    "ProgramReport",
    "ProgramSpec",
    "classify_warm_outcome",
    "library_specs",
    "path_sources",
    "shard_owner",
    "warm_sharded",
]

# The libraries each path of the port loads: training runs the flash
# kernels and records its model through the native graph engine; serving
# runs paged decode (its prefill attends through plain attention, so it
# loads no flash library); both materialize their parameters through the
# keyed draws.
_PATH_SOURCES = {
    "train": ("flash_attention.cu", "tdx_graph.cc", "keyed_rng.cu"),
    "serve": ("paged_decode.cu", "keyed_rng.cu"),
}


def path_sources(path: str) -> Tuple[str, ...]:
    """The kernel sources ``path`` (``train``, ``serve`` or ``all``)
    loads, each once."""
    if path == "all":
        return tuple(dict.fromkeys(
            s for p in ("train", "serve") for s in _PATH_SOURCES[p]))
    try:
        return _PATH_SOURCES[path]
    except KeyError:
        raise ValueError(f"path must be 'train', 'serve' or 'all', "
                         f"not {path!r}") from None


@dataclass
class ProgramSpec:
    """One kernel library of the warm set: its CUDA source, the nvcc
    flags, and its registry address (None without a registry)."""

    name: str                    # the source's stem, e.g. "flash_attention"
    source: str                  # "flash_attention.cu"
    flags: Tuple[str, ...]
    program_fp: str
    registry_key: Optional[str]


@dataclass
class ProgramReport:
    """Per-library outcome of one host's warm.

    ``outcome`` vocabulary: ``published`` (built here and published),
    ``compiled`` (built here, nothing published — no registry),
    ``fetched`` (filled from another host's artifact), ``cached`` (the
    local cache already had it), ``stolen`` (owner missed the deadline;
    built here and published), ``unwarmed`` (failed — the tool exits
    non-zero)."""

    program: str
    outputs: int
    outcome: str
    seconds: float
    owner: Optional[int] = None
    cache: Optional[str] = None   # the local cache's outcome: hit|miss
    error: Optional[str] = None

    def as_dict(self) -> Dict[str, Any]:
        d = {"program": self.program, "outputs": self.outputs,
             "outcome": self.outcome, "seconds": round(self.seconds, 3)}
        if self.owner is not None:
            d["owner"] = self.owner
        if self.cache is not None:
            d["cache"] = self.cache
        if self.error is not None:
            d["error"] = self.error
        return d


def classify_warm_outcome(cache_outcome: str, *, fetched: bool,
                          published: bool) -> str:
    """THE warm-outcome vocabulary (`ProgramReport.outcome`): a local
    hit is ``fetched`` only when registry bytes actually moved during
    this lookup (else ``cached``); a build is ``published`` only when its
    artifact is now in the registry (else ``compiled``)."""
    if cache_outcome == "hit":
        return "fetched" if fetched else "cached"
    return "published" if published else "compiled"


def shard_owner(key: str, hosts: int) -> int:
    """Deterministic owner of one registry key in ``[0, hosts)`` — a pure
    function of the key, so every host computes the same partition
    regardless of list order, launch order, or process boundaries."""
    return int(key[:8], 16) % max(1, hosts)


def library_specs(sources: Sequence[str],
                  registry_dir: Optional[str]) -> List[ProgramSpec]:
    """The specs of ``sources``' libraries in this build environment."""
    from pathlib import Path

    from ..ops import _build

    out = []
    for source in sources:
        out.append(ProgramSpec(
            Path(source).stem, source, tuple(_build.flags(source)),
            _build.program_fp(source),
            _build.library_key(source) if registry_dir else None))
    return out


def warm_sharded(sources: Sequence[str], cache_dir: str, *,
                 registry_dir: Optional[str] = None,
                 hosts: int = 1, host_id: int = 0,
                 steal_after_s: float = 120.0, poll_s: float = 0.5) -> dict:
    """Warm this host's kernel cache (and the shared registry) with the
    libraries of ``sources``; returns a summary dict with per-library
    outcome reports (see :class:`ProgramReport`).

    With ``hosts > 1`` the list is sharded by :func:`shard_owner`: owned
    libraries are built and published, the rest polled from the
    registry and stolen past ``steal_after_s``."""
    from .. import config as tdx_config
    from ..ops import _build

    if hosts < 1 or not (0 <= host_id < hosts):
        raise ValueError(
            f"host_id must be in [0, hosts); got host_id={host_id} "
            f"hosts={hosts}"
        )
    if hosts > 1 and not registry_dir:
        raise ValueError(
            "a sharded warm (hosts > 1) needs --registry-dir: without a "
            "shared registry the hosts cannot exchange artifacts"
        )

    t0 = time.perf_counter()
    log = get_logger()
    os.makedirs(cache_dir, exist_ok=True)
    reg = ArtifactRegistry(registry_dir) if registry_dir else None
    reports: List[ProgramReport] = []

    def owner(spec: ProgramSpec) -> Optional[int]:
        return (shard_owner(spec.registry_key, hosts)
                if spec.registry_key else None)

    def owned(spec: ProgramSpec) -> bool:
        if reg is None or spec.registry_key is None or hosts <= 1:
            return True
        return owner(spec) == host_id

    def build_spec(spec: ProgramSpec) -> ProgramReport:
        t = time.perf_counter()
        fetches_before = _build.counts["fetches"]
        _build.build(spec.source)
        cache_outcome = _build.outcomes[spec.source]
        outcome = classify_warm_outcome(
            cache_outcome,
            fetched=_build.counts["fetches"] > fetches_before,
            published=bool(reg is not None and spec.registry_key
                           and reg.has(spec.registry_key)),
        )
        return ProgramReport(program=spec.name, outputs=1, outcome=outcome,
                             seconds=time.perf_counter() - t,
                             owner=owner(spec), cache=cache_outcome)

    def run_spec(spec: ProgramSpec, relabel: Optional[str] = None) -> None:
        try:
            rep = build_spec(spec)
            if relabel and rep.cache != "hit":
                rep.outcome = relabel
        except Exception as e:  # noqa: BLE001 — one bad library ≠ a dead warm
            log.error("warm: library %s failed (%s: %s)", spec.name,
                      type(e).__name__, str(e)[:160])
            rep = ProgramReport(
                program=spec.name, outputs=1, outcome="unwarmed",
                seconds=0.0, owner=owner(spec),
                error=f"{type(e).__name__}: {str(e)[:200]}",
            )
        reports.append(rep)

    with tdx_config.override(cache_dir=cache_dir,
                             registry_dir=registry_dir or None):
        fill: List[ProgramSpec] = []
        for spec in library_specs(sources, registry_dir):
            if owned(spec):
                run_spec(spec)
            else:
                fill.append(spec)

        # Fill phase: poll for other hosts' artifacts; steal past the
        # deadline so a dead owner degrades to a local build.
        steal_at = time.monotonic() + max(0.0, steal_after_s)
        while fill:
            progressed = False
            for spec in list(fill):
                assert reg is not None and spec.registry_key
                if reg.has(spec.registry_key):
                    run_spec(spec)
                    fill.remove(spec)
                    progressed = True
            if not fill:
                break
            now = time.monotonic()
            if now >= steal_at:
                for spec in fill:
                    log.warning(
                        "warm: stealing %s (owner host %d missed the "
                        "%.1fs deadline)", spec.name, owner(spec),
                        steal_after_s,
                    )
                    run_spec(spec, relabel="stolen")
                    # Counted AFTER the fact: an owner that published in
                    # the window between the last poll and this build
                    # turns the steal into a plain fetch.
                    if reports[-1].outcome == "stolen":
                        observe.counter("tdx.registry.steals").inc()
                        observe.instant("registry.steal", category="registry",
                                        program=spec.name, owner=owner(spec))
                break
            if not progressed:
                time.sleep(min(poll_s, max(0.0, steal_at - now)))

    outcomes: Dict[str, int] = {}
    for r in reports:
        outcomes[r.outcome] = outcomes.get(r.outcome, 0) + 1
    try:
        cache_entries = sum(1 for n in os.listdir(cache_dir)
                            if n.endswith(".so"))
    except OSError:
        cache_entries = 0
    return {
        "programs": sum(1 for r in reports if r.outcome != "unwarmed"),
        "outputs": sum(r.outputs for r in reports
                       if r.outcome != "unwarmed"),
        "cache_entries": cache_entries,
        "seconds": round(time.perf_counter() - t0, 2),
        "cache_dir": cache_dir,
        "registry_dir": registry_dir,
        "hosts": hosts,
        "host_id": host_id,
        "outcomes": outcomes,
        "program_reports": [r.as_dict() for r in reports],
        "unwarmed": [r.program for r in reports if r.outcome == "unwarmed"],
    }
