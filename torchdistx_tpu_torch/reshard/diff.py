"""Plan differ (the port's own copy of ``torchdistx_tpu/reshard/diff.py``):
pure-metadata source→target layout diff + transfer schedule.

Nothing here touches devices or tensor data — the differ works from a
checkpoint's manifest (leaf tree + topology block,
:mod:`..utils.checkpoint`) and the *target* ``ShardingPlan``/mesh
metadata, so a transfer schedule with byte totals can be printed on a
host with no GPU.  A target mesh can therefore be a ``DeviceMesh``, a
:class:`~..parallel.VirtualMesh` or a :class:`MeshSpec` (axis names +
sizes only): every consumer reads just the name→size mapping, which is
also all :class:`~..parallel.sharding.ShardingPlan` resolution needs.

The memory model follows arXiv:2112.01075 (memory-bounded array
redistribution): transfers stream leaf-by-leaf, one destination shard
block at a time, and any block whose bytes exceed the
``TDX_RESHARD_CHUNK_MB`` budget is split into bounded slab reads by
:func:`chunk_boxes` — a full unsharded leaf is never materialized on one
host.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Box",
    "LeafTransfer",
    "MeshSpec",
    "ReshardError",
    "ReshardPlan",
    "chunk_boxes",
    "chunk_count",
    "leaf_blocks",
    "np_dtype",
    "plan_from_manifest",
]

# A box is an index region: ((start, stop), ...) — one pair per dim.
Box = Tuple[Tuple[int, int], ...]


class ReshardError(RuntimeError):
    """A checkpoint redistribution failed (plan mismatch, transfer fault,
    or bitwise-verify failure).  The contract is degrade-never-corrupt:
    when this raises, nothing was quarantined, the destination carries no
    commit marker, and the source checkpoint is untouched."""


class MeshSpec:
    """Axis names + sizes of a device mesh, without devices.

    Everything the sharding plans consume (the ``.shape`` name→size
    mapping, :func:`~..parallel.sharding.mesh_shape`), so the differ can
    resolve plan B on hosts with no GPU."""

    def __init__(self, axes: Dict[str, int]):
        self.axes: Tuple[Tuple[str, int], ...] = tuple(
            (str(a), int(s)) for a, s in dict(axes).items()
        )

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def size(self) -> int:
        n = 1
        for _, s in self.axes:
            n *= s
        return n

    @classmethod
    def of(cls, mesh) -> "MeshSpec":
        """From a ``DeviceMesh``, a ``VirtualMesh``, another MeshSpec, or
        an axes dict."""
        if isinstance(mesh, MeshSpec):
            return mesh
        from ..parallel.sharding import mesh_shape

        return cls({str(a): int(s) for a, s in mesh_shape(mesh).items()})

    def __repr__(self) -> str:
        inner = ", ".join(f"{a}={s}" for a, s in self.axes)
        return f"MeshSpec({inner})"

    def __eq__(self, other) -> bool:
        return isinstance(other, MeshSpec) and self.axes == other.axes


def np_dtype(name: str) -> np.dtype:
    """A numpy dtype of the item size of a stored dtype string.  Names
    numpy knows map to themselves; the ones it lacks (``bfloat16``, the
    float8 types) to the unsigned integer of their size: the differ
    counts bytes and the engine moves bits, so only the size matters."""
    try:
        return np.dtype(name)
    except TypeError:
        import torch

        dt = getattr(torch, name, None)
        if not isinstance(dt, torch.dtype):
            raise TypeError(f"unknown dtype {name!r}") from None
        return np.dtype(f"u{dt.itemsize}")


def _norm_spec(spec) -> Tuple[Tuple[str, ...], ...]:
    """PartitionSpec (or dim tuple) → per-dim tuple of mesh axis names."""
    dims: List[Tuple[str, ...]] = []
    for axis in spec or ():
        if axis is None:
            dims.append(())
        elif isinstance(axis, (tuple, list)):
            dims.append(tuple(str(a) for a in axis))
        else:
            dims.append((str(axis),))
    return tuple(dims)


def _grid(shape: Sequence[int], spec, mesh: MeshSpec) -> Tuple[int, ...]:
    """Distinct shard blocks per dim for ``spec`` over ``mesh``.  Raises
    :class:`ReshardError` on a non-dividing axis — specs recorded from
    real ``NamedSharding``s always divide; anything else is a bad plan."""
    sizes = mesh.shape
    parts: List[int] = []
    for d, axes in enumerate(_norm_spec(spec)):
        if d >= len(shape):
            break
        n = 1
        for a in axes:
            n *= sizes.get(a, 1)
        if n > 1 and shape[d] % n != 0:
            raise ReshardError(
                f"spec {spec!r} does not divide shape {tuple(shape)} "
                f"(dim {d}: {shape[d]} % {n} != 0)"
            )
        parts.append(max(1, n))
    parts += [1] * (len(shape) - len(parts))
    return tuple(parts)


def leaf_blocks(shape: Sequence[int], grid: Sequence[int]) -> Iterator[Box]:
    """The distinct shard blocks of a leaf, in row-major grid order."""
    if not shape:
        yield ()
        return
    import itertools

    steps = [s // g for s, g in zip(shape, grid)]
    for idx in itertools.product(*(range(g) for g in grid)):
        yield tuple(
            (i * st, (i + 1) * st) for i, st in zip(idx, steps)
        )


def chunk_boxes(box: Box, itemsize: int, budget_bytes: int) -> Iterator[Box]:
    """Split ``box`` into sub-boxes of at most ``budget_bytes`` each —
    slab runs along the leading dim, recursing inward when a single
    leading-dim index still exceeds the budget.  A single element over
    budget is yielded whole (minimum granularity)."""
    shape = tuple(hi - lo for lo, hi in box)
    total = itemsize
    for s in shape:
        total *= s
    if total <= budget_bytes or not box or 0 in shape:
        yield box
        return
    inner = total // shape[0]
    if inner <= budget_bytes:
        k = max(1, int(budget_bytes // inner))
        lo0, hi0 = box[0]
        for s in range(lo0, hi0, k):
            yield ((s, min(s + k, hi0)),) + tuple(box[1:])
        return
    lo0, hi0 = box[0]
    for i in range(lo0, hi0):
        if len(box) == 1:
            yield ((i, i + 1),)
        else:
            for sub in chunk_boxes(tuple(box[1:]), itemsize, budget_bytes):
                yield ((i, i + 1),) + sub


def chunk_count(box: Box, itemsize: int, budget_bytes: int) -> int:
    return sum(1 for _ in chunk_boxes(box, itemsize, budget_bytes))


@dataclass
class LeafTransfer:
    """Per-leaf schedule entry: what moves, in what granularity."""

    name: str                      # dotted storage name (the DCP key)
    shape: Tuple[int, ...]
    dtype: str
    src_spec: str                  # sharding.spec_str form
    dst_spec: str
    src_blocks: int                # distinct shard blocks under plan A
    dst_blocks: int                # ... and under plan B
    dst_block_shape: Tuple[int, ...]
    n_chunks: int                  # budget-bounded transfer chunks
    nbytes: int
    moved: bool                    # layout actually changes (grids differ)


@dataclass
class ReshardPlan:
    """The full transfer schedule from one concrete layout to another."""

    src_dir: str
    mesh_src: Dict[str, int]       # {} when the source recorded no mesh
    mesh_dst: Dict[str, int]
    src_digest: Optional[str]
    dst_digest: str
    budget_bytes: int
    leaves: List[LeafTransfer] = field(default_factory=list)

    @property
    def by_name(self) -> Dict[str, LeafTransfer]:
        return {lt.name: lt for lt in self.leaves}

    @property
    def total_bytes(self) -> int:
        return sum(lt.nbytes for lt in self.leaves)

    @property
    def total_chunks(self) -> int:
        return sum(lt.n_chunks for lt in self.leaves)

    @property
    def moved_bytes(self) -> int:
        return sum(lt.nbytes for lt in self.leaves if lt.moved)

    def to_topology(self) -> dict:
        """The manifest topology block the destination checkpoint gets."""
        from ..parallel.sharding import plan_digest  # lazy: keep diff light

        specs = {lt.name: lt.dst_spec for lt in self.leaves}
        return {
            "mesh_axes": dict(self.mesh_dst),
            "specs": specs,
            "plan_digest": plan_digest(self.mesh_dst, specs),
        }

    def describe(self) -> str:
        """Human-readable schedule (the JAX ``reshard_ctl.py plan``
        output's layout)."""
        mesh_s = ",".join(f"{a}={s}" for a, s in self.mesh_src.items()) or "?"
        mesh_d = ",".join(f"{a}={s}" for a, s in self.mesh_dst.items())
        lines = [
            f"reshard plan: {self.src_dir}",
            f"  mesh {mesh_s} -> {mesh_d}   "
            f"(digest {self.src_digest or '?'} -> {self.dst_digest})",
            f"  chunk budget {self.budget_bytes / (1 << 20):.1f} MiB, "
            f"{len(self.leaves)} leaves, {self.total_chunks} chunks, "
            f"{self.total_bytes} bytes total "
            f"({self.moved_bytes} relaid out)",
        ]
        w = max((len(lt.name) for lt in self.leaves), default=0)
        for lt in self.leaves:
            lines.append(
                f"  {lt.name:<{w}}  {str(lt.shape):>14} {lt.dtype:<9} "
                f"{lt.src_spec:>18} -> {lt.dst_spec:<18} "
                f"blocks {lt.src_blocks}->{lt.dst_blocks} "
                f"chunks {lt.n_chunks:>3}  {lt.nbytes} B"
                f"{'' if lt.moved else '  (aligned)'}"
            )
        return "\n".join(lines)


def plan_from_manifest(
    src_dir: str,
    manifest: dict,
    plan_b,
    mesh_b,
    *,
    budget_bytes: int,
) -> ReshardPlan:
    """Diff a committed checkpoint's recorded topology against target
    plan/mesh metadata.  ``manifest`` must carry a leaf tree (every
    manifest this repo writes does); a missing topology block means the
    source layout is unknown — leaves are treated as replicated, which
    only affects the schedule's ``moved``/block stats, never the data.
    """
    from ..parallel.sharding import parse_spec_str, plan_digest, spec_str

    tree = manifest.get("tree")
    if not tree:
        raise ReshardError(
            f"{src_dir}: manifest has no leaf tree — cannot plan a "
            f"reshard for a pre-manifest checkpoint"
        )
    topo = manifest.get("topology") or {}
    src_specs: Dict[str, str] = topo.get("specs", {})
    mesh_src = MeshSpec(topo.get("mesh_axes", {}))
    mesh_dst = MeshSpec.of(mesh_b)

    leaves: List[LeafTransfer] = []
    dst_specs: Dict[str, str] = {}
    for entry in tree:
        if "shape" not in entry:
            continue  # non-array leaf; the engine copies it verbatim
        name = _storage_name_from_keystr(entry["path"])
        shape = tuple(int(s) for s in entry["shape"])
        dtype = entry.get("dtype", "float32")
        itemsize = np_dtype(dtype).itemsize
        nbytes = itemsize
        for s in shape:
            nbytes *= s
        src_spec_s = src_specs.get(name, "()")
        src_grid = _grid(shape, parse_spec_str(src_spec_s), mesh_src)
        dst_spec = plan_b.spec_for(name, shape, mesh_dst)
        dst_spec_s = spec_str(dst_spec)
        dst_grid = _grid(shape, dst_spec, mesh_dst)
        dst_block = tuple(s // g for s, g in zip(shape, dst_grid))
        n_chunks = 0
        for box in leaf_blocks(shape, dst_grid):
            n_chunks += chunk_count(box, itemsize, budget_bytes)
        dst_specs[name] = dst_spec_s
        leaves.append(LeafTransfer(
            name=name, shape=shape, dtype=dtype,
            src_spec=src_spec_s, dst_spec=dst_spec_s,
            src_blocks=int(np.prod(src_grid)) if src_grid else 1,
            dst_blocks=int(np.prod(dst_grid)) if dst_grid else 1,
            dst_block_shape=dst_block,
            n_chunks=n_chunks, nbytes=nbytes,
            moved=src_grid != dst_grid or src_spec_s != dst_spec_s,
        ))
    mesh_dst_axes = mesh_dst.shape
    return ReshardPlan(
        src_dir=str(src_dir),
        mesh_src=mesh_src.shape,
        mesh_dst=mesh_dst_axes,
        src_digest=topo.get("plan_digest"),
        dst_digest=plan_digest(mesh_dst_axes, dst_specs),
        budget_bytes=budget_bytes,
        leaves=leaves,
    )


_KEYSTR_PART = re.compile(
    r"\['([^']*)'\]|\[(\d+)\]|\.([A-Za-z_][A-Za-z_0-9]*)"
)


def _storage_name_from_keystr(keystr: str) -> str:
    """Manifest tree paths are jax ``keystr`` strings
    (``['opt']['exp_avg']['embed.weight']``, or a JAX-written manifest's
    ``['opt'][0].mu['dense']['kernel']``); checkpoints address leaves by
    dotted storage name (``opt.exp_avg.embed.weight``).  Same joining
    rule as :func:`~..utils.checkpoint.leaf_storage_name`."""
    parts = []
    for m in _KEYSTR_PART.finditer(keystr):
        parts.append(next(g for g in m.groups() if g is not None))
    return ".".join(parts)
