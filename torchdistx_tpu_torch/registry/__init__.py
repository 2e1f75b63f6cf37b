"""Kernel-library artifact registry (the port's own copy of
``torchdistx_tpu/registry``).

A content-addressed store of nvcc-built kernel libraries shared across
hosts (:mod:`.store`), plus the sharded multi-host warm that partitions
the builds across a fleet and fills every host's local cache from the
registry (:mod:`.scheduler`).

Activated by ``TDX_REGISTRY_DIR`` (:mod:`torchdistx_tpu_torch.config`):
:mod:`..ops._build` then fetches a library missing from the local cache
(``TDX_CACHE_DIR``) before it runs nvcc, and publishes what it builds.
All registry trouble — flaky shared filesystems, corrupt entries,
injected ``registry`` chaos faults — degrades to a local build, never an
error.
"""

from .scheduler import (
    ProgramReport,
    ProgramSpec,
    classify_warm_outcome,
    library_specs,
    path_sources,
    shard_owner,
    warm_sharded,
)
from .store import ArtifactRegistry, env_fingerprint, env_key, registry_key

__all__ = [
    "ArtifactRegistry",
    "ProgramReport",
    "ProgramSpec",
    "classify_warm_outcome",
    "env_fingerprint",
    "env_key",
    "library_specs",
    "path_sources",
    "registry_key",
    "shard_owner",
    "warm_sharded",
]
