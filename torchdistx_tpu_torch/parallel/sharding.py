"""Sharding plans: declarative parameter-name → PartitionSpec rules.

The port's own copy of ``torchdistx_tpu/parallel/sharding.py``.  A
:class:`PartitionSpec` says, per tensor dim, which mesh axes shard it: a
name, a tuple of names (the first named is the major one), or ``None``
(replicated).  A plan resolves against a mesh's shape — a
:class:`~torch.distributed.device_mesh.DeviceMesh`, a
:class:`~.mesh.VirtualMesh` or a plain ``{axis: size}`` mapping — so plans
resolve and test without a process group.  :func:`placements_for` and
:func:`local_shard` turn a resolved spec into DTensor placements and into
one mesh coordinate's slice of a full tensor.  A
:class:`StageShardingPlan` gives each block layer to one pipeline stage
whole (:func:`stage_layers`).
"""

from __future__ import annotations

import re
import warnings
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per-dim mesh axes: ``P("tp", "fsdp")``, ``P(None, ("fsdp", "tp"))``;
    ``P()`` replicates the whole tensor.  Dims past its length are
    replicated."""

    def __new__(cls, *axes: Axis):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


Rule = Tuple[str, PartitionSpec]


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` in mesh-dim order, for a ``DeviceMesh``, a
    ``VirtualMesh`` or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # DeviceMesh
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


class ShardingPlan:
    """Ordered first-match rules from parameter-name regex to PartitionSpec.

    Example::

        plan = ShardingPlan([
            (r".*attn\\.w[qkv]\\.weight", P("tp", "fsdp")),
            (r".*embed.*", P("tp", "fsdp")),
        ], default=P())
    """

    def __init__(
        self,
        rules: Sequence[Rule] = (),
        *,
        default: PartitionSpec = PartitionSpec(),
    ):
        self.rules: List[Tuple[re.Pattern, PartitionSpec]] = [
            (re.compile(pat), spec) for pat, spec in rules
        ]
        self.default = default

    def spec_for(self, name: str, shape: Sequence[int], mesh=None) -> PartitionSpec:
        spec = self.default
        for pat, s in self.rules:
            if pat.fullmatch(name):
                spec = s
                break
        if mesh is not None:
            spec = _validate_spec(name, shape, spec, mesh_shape(mesh))
        return spec


def _axis_size(shape: Mapping[str, int], axis: Axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= shape.get(a, 1)
        return n
    return shape.get(axis, 1)


def _drop_absent_axes(axis: Axis, shape: Mapping[str, int]) -> Axis:
    """Remove mesh axes the spec names but the mesh lacks (a plan written
    for a dp×fsdp×tp×ep mesh degrades gracefully on smaller meshes).
    Warns once per axis name so typo'd axes are not silently replicated."""
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if not _absent(a, shape))
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return None if _absent(axis, shape) else axis


_warned_axes = set()


def _absent(a: str, shape: Mapping[str, int]) -> bool:
    if a in shape:
        return False
    if a not in _warned_axes:
        _warned_axes.add(a)
        warnings.warn(
            f"ShardingPlan: mesh has no axis {a!r} "
            f"(axes: {tuple(shape)}); dims naming it will be replicated. "
            f"Check for typos if this is unexpected."
        )
    return True


def _validate_spec(name, shape, spec: PartitionSpec,
                   mesh: Mapping[str, int]) -> PartitionSpec:
    """Drop mesh axes that do not divide the corresponding dim (with a
    warning): such a dim is replicated, never padded or split unevenly."""
    if not spec:
        return spec
    new_axes = []
    changed = False
    for dim, axis in enumerate(spec):
        if dim >= len(shape):
            # Spec longer than tensor rank (e.g. a rank-2 rule matching a
            # rank-1 bias): drop the excess entries.
            changed = True
            break
        dropped = _drop_absent_axes(axis, mesh)
        if dropped != axis:
            changed = True
            axis = dropped
        if axis is None:
            new_axes.append(axis)
            continue
        size = _axis_size(mesh, axis)
        if size > 1 and shape[dim] % size != 0:
            warnings.warn(
                f"ShardingPlan: `{name}` dim {dim} (size {shape[dim]}) is not "
                f"divisible by mesh axis {axis!r} (size {size}); replicating "
                f"that dim instead."
            )
            new_axes.append(None)
            changed = True
        else:
            new_axes.append(axis)
    return PartitionSpec(*new_axes) if changed else spec


# -- spec serialization ----------------------------------------------------


def spec_str(spec: Optional[PartitionSpec]) -> str:
    """Serialize a PartitionSpec: ``P('fsdp', None)`` → ``"('fsdp', None)"``,
    ``P()``/``None`` → ``"()"``."""
    if spec is None:
        return "()"
    dims = []
    for axis in spec:
        if isinstance(axis, (tuple, list)):
            dims.append(tuple(str(a) for a in axis))
        else:
            dims.append(None if axis is None else str(axis))
    return repr(tuple(dims))


def parse_spec_str(s: str) -> PartitionSpec:
    """Inverse of :func:`spec_str` (tolerates surrounding whitespace)."""
    import ast

    val = ast.literal_eval(s.strip())
    if not isinstance(val, tuple):
        raise ValueError(f"not a PartitionSpec string: {s!r}")
    return PartitionSpec(*val)


def plan_digest(mesh_axes: Dict[str, int], specs: Dict[str, str]) -> str:
    """Stable digest of a concrete layout: mesh axis sizes + every leaf's
    spec string.  Equal digests ⇒ a checkpoint needs no resharding to load
    under the other topology."""
    import json
    import zlib

    payload = json.dumps(
        {"mesh": dict(mesh_axes), "specs": dict(specs)}, sort_keys=True
    ).encode()
    return f"{zlib.crc32(payload):08x}"


# -- stock plans -----------------------------------------------------------


def fsdp_plan(axis: str = "fsdp", min_size: int = 2**16) -> "CallableShardingPlan":
    """Shard the largest dim of every parameter over ``axis`` (ZeRO-3-style
    fully sharded layout), replicating small tensors."""

    def fn(name: str, shape: Sequence[int], mesh: Mapping[str, int]) -> PartitionSpec:
        if not shape:
            return PartitionSpec()
        n = 1
        for s in shape:
            n *= s
        if n < min_size:
            return PartitionSpec()
        size = mesh.get(axis, 1)
        # largest divisible dim
        best = None
        for dim in sorted(range(len(shape)), key=lambda d: -shape[d]):
            if shape[dim] % size == 0:
                best = dim
                break
        if best is None:
            return PartitionSpec()
        axes = [None] * len(shape)
        axes[best] = axis
        return PartitionSpec(*axes)

    return CallableShardingPlan(fn)


def gspmd_2d_plan(
    axes: Sequence[str] = ("fsdp", "tp"), min_size: int = 2**16
) -> "CallableShardingPlan":
    """Shard the two largest (distinct) dims of every parameter over the
    2D mesh ``axes`` — the classic GSPMD 2D layout (BASELINE config 4:
    T5-11B "GSPMD 2D-shard").  A dim takes an axis only if the mesh-axis
    size divides it; tensors with one eligible dim degrade to 1D over
    ``axes[0]``, and tensors under ``min_size`` replicate."""

    def fn(name: str, shape: Sequence[int], mesh: Mapping[str, int]) -> PartitionSpec:
        if not shape:
            return PartitionSpec()
        n = 1
        for s in shape:
            n *= s
        if n < min_size:
            return PartitionSpec()
        out = [None] * len(shape)
        dims = sorted(range(len(shape)), key=lambda d: -shape[d])
        for axis in axes:
            size = mesh.get(axis, 1)
            if size <= 1:
                continue  # a no-op axis must not claim a dim from the other
            for dim in dims:
                if out[dim] is None and shape[dim] % size == 0:
                    out[dim] = axis
                    break
        return PartitionSpec(*out)

    return CallableShardingPlan(fn)


class CallableShardingPlan(ShardingPlan):
    """A plan computed by a function ``(name, shape, mesh_shape) ->
    PartitionSpec``, where ``mesh_shape`` is the ``{axis: size}`` mapping
    (the reference's functions read ``mesh.shape``, the same mapping)."""

    def __init__(self, fn: Callable[[str, Sequence[int], Mapping[str, int]],
                                    PartitionSpec]):
        super().__init__()
        self._fn = fn

    def spec_for(self, name, shape, mesh=None):
        if mesh is None:
            return PartitionSpec()
        shape_map = mesh_shape(mesh)
        return _validate_spec(name, shape, self._fn(name, shape, shape_map),
                              shape_map)


# -- pipeline stages -------------------------------------------------------


def _chunk_size(n_layers: int, pp: int, n_chunks: int) -> int:
    K = pp * n_chunks
    if n_layers % K:
        raise ValueError(f"pp * n_chunks ({pp} * {n_chunks}) must divide "
                         f"the layer count ({n_layers})")
    return n_layers // K


def stage_layers(n_layers: int, pp: int, stage: int,
                 n_chunks: int = 1) -> List[List[int]]:
    """The layers pipeline stage ``stage`` of ``pp`` owns, per local chunk.

    The layers are cut into ``K = pp * n_chunks`` chunks of ``n_layers /
    K`` consecutive layers, and global chunk ``k`` lives on stage ``k %
    pp`` as its local chunk ``k // pp`` (the JAX package's
    ``_interleave_perm``).  With one chunk, stage ``s`` owns layers
    ``[s L/pp, (s + 1) L/pp)``."""
    lc = _chunk_size(n_layers, pp, n_chunks)
    return [list(range((j * pp + stage) * lc, (j * pp + stage + 1) * lc))
            for j in range(n_chunks)]


def layer_stage(layer: int, n_layers: int, pp: int, n_chunks: int = 1) -> int:
    """The stage that owns ``layer`` (:func:`stage_layers`): its chunk
    modulo ``pp``."""
    return (layer // _chunk_size(n_layers, pp, n_chunks)) % pp


# An entry of block layer <i>: every family names its blocks ``blocks``
# (the decomposition's ``blocks``, whose index the pipeline runner owns
# layers by).
_BLOCK_ENTRY = re.compile(r"(?:.*\.)?blocks\.(\d+)\..*")


class StageShardingPlan(ShardingPlan):
    """``base``'s placements, with each block layer owned whole by one
    pipeline stage over ``axis``: the port's counterpart of the JAX
    package's ``pipeline_plan_overrides``.

    The reference puts the scan-stacked layer dim of every block weight on
    ``P("pp")``.  Here the blocks are separate entries
    (``blocks.<i>.…``), so a spec over ``pp`` would cut dim 0 of one
    layer's weight instead; this plan names an owner instead
    (:meth:`stage_of`, by :func:`layer_stage`).  The materializer draws
    and keeps a stage-owned entry only on the ranks of its stage, as this
    rank's shard of ``base``'s spec over the other axes; every other
    entry is placed by ``base``, replicated over ``axis``."""

    def __init__(self, base: ShardingPlan, n_layers: int, *,
                 axis: str = "pp", n_chunks: int = 1):
        super().__init__()
        self.base, self.n_layers = base, n_layers
        self.axis, self.n_chunks = axis, n_chunks

    def spec_for(self, name, shape, mesh=None):
        return self.base.spec_for(name, shape, mesh)

    def stage_of(self, name: str, mesh) -> Optional[int]:
        """The stage that owns entry ``name`` on ``mesh``, or None for an
        entry every stage holds."""
        m = _BLOCK_ENTRY.fullmatch(name)
        if m is None:
            return None
        pp = mesh_shape(mesh).get(self.axis, 1)
        return layer_stage(int(m.group(1)), self.n_layers, pp, self.n_chunks)


# -- from a spec to a layout ----------------------------------------------


def _dim_axes(spec: PartitionSpec) -> List[Tuple[str, ...]]:
    """Each tensor dim's mesh axes, major first."""
    return [() if a is None else tuple(a) if isinstance(a, (tuple, list))
            else (a,) for a in spec]


def placements_for(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements (one per mesh dim) for a spec resolved against
    ``mesh`` (as :meth:`ShardingPlan.spec_for` returns it).

    A dim over several axes is split with the first-named axis major, as
    PartitionSpec orders it.  DTensor splits over the mesh dims in mesh
    order, so a mesh dim whose axis comes after an axis that PartitionSpec
    makes more major takes ``_StridedShard`` with ``split_factor`` the
    product of those later mesh dims' sizes; otherwise it takes ``Shard``.
    """
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    shape = mesh_shape(mesh)
    order = list(shape)
    out: list = [Replicate()] * len(order)
    for dim, axes in enumerate(_dim_axes(spec)):
        for j, a in enumerate(axes):
            if a not in shape:
                raise ValueError(f"spec {spec!r} names axis {a!r}; mesh axes "
                                 f"are {tuple(order)}")
            i = order.index(a)
            split = 1
            for major in axes[:j]:
                if order.index(major) > i:
                    split *= shape[major]
            out[i] = Shard(dim) if split == 1 else _StridedShard(
                dim, split_factor=split)
    return tuple(out)


def shard_region(full_shape: Sequence[int], spec: PartitionSpec,
                 mesh: Mapping[str, int],
                 coordinate: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """``(start, length)`` per dim of the box of a tensor of
    ``full_shape`` that the device at ``coordinate`` (one index per mesh
    dim, in ``mesh``'s order) holds under ``spec``.  A dim over several
    axes is split with the first-named axis major.  Every sharded dim must
    be divisible by its axes' sizes (a resolved spec's are)."""
    shape = mesh_shape(mesh)
    where = dict(zip(shape, coordinate))
    region = [(0, int(size)) for size in full_shape]
    for dim, axes in enumerate(_dim_axes(spec)):
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            n *= shape[a]
            idx = idx * shape[a] + where[a]
        size = full_shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not divide over "
                             f"{axes} ({n} shards)")
        chunk = size // n
        region[dim] = (idx * chunk, chunk)
    return tuple(region)


def local_shard(full: torch.Tensor, spec: PartitionSpec,
                mesh: Mapping[str, int], coordinate: Sequence[int]) -> torch.Tensor:
    """The slice of ``full`` that the device at ``coordinate`` holds under
    ``spec`` — a view of :func:`shard_region`'s box."""
    out = full
    for dim, (start, length) in enumerate(
            shard_region(tuple(full.shape), spec, mesh, coordinate)):
        if length != full.shape[dim]:
            out = out.narrow(dim, start, length)
    return out
