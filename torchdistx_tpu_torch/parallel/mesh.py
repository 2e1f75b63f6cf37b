"""Device-mesh construction (the port's own copy of
``torchdistx_tpu/parallel/mesh.py``'s ``make_mesh``).

A named :class:`~torch.distributed.device_mesh.DeviceMesh` over the
ranks of the default process group, with the conventional axis names the
sharding plans use:

* ``dp``   — data parallel (pure replication of params, sharded batch);
* ``fsdp`` — fully-sharded data parallel (params sharded, batch sharded);
* ``tp``   — tensor/model parallel (Megatron-style);
* ``sp``   — sequence/context parallel (ring attention);
* ``ep``   — expert parallel (MoE);
* ``pp``   — pipeline parallel.

The caller starts the process group (``torch.distributed
.init_process_group`` with its own address, world size and rank, or
:func:`initialize_multihost` from the launcher's environment); the mesh
spans every rank of it.  :func:`make_hybrid_mesh` lays a mesh across
hosts: its DCN axes (the JAX name for the slow links between slices; here
between hosts) outermost, its ICI axes (within a host, over NVLink)
contiguous inside one host.  :class:`VirtualMesh` names one coordinate of
a mesh that has no process group behind it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Tuple

DEFAULT_AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")


def _ordered_axes(axes: Mapping[str, int], n_devices: int):
    """(names, sizes) in :data:`DEFAULT_AXIS_ORDER`, one ``-1`` inferred,
    the product checked against ``n_devices``."""
    names = [a for a in DEFAULT_AXIS_ORDER if a in axes]
    names += [a for a in axes if a not in names]
    sizes = [axes[a] for a in names]
    n_infer = sum(1 for s in sizes if s == -1)
    if n_infer > 1:
        raise ValueError("At most one axis size may be -1.")
    known = 1
    for s in sizes:
        if s != -1:
            known *= s
    if n_infer:
        if n_devices % known:
            raise ValueError(
                f"Cannot infer axis size: {n_devices} devices not divisible "
                f"by {known}."
            )
        sizes = [n_devices // known if s == -1 else s for s in sizes]
    total = 1
    for s in sizes:
        total *= s
    if total != n_devices:
        raise ValueError(
            f"Mesh axes {dict(zip(names, sizes))} require {total} devices, "
            f"but {n_devices} are available."
        )
    return names, sizes


def make_mesh(axes: Dict[str, int], *, device_type: str = "cuda"):
    """Create a named ``DeviceMesh`` from ``{axis_name: size}`` over the
    ranks of the default process group.

    Sizes must multiply to the world size; an axis size of ``-1`` is
    inferred.  Axis order follows :data:`DEFAULT_AXIS_ORDER` for the axes
    present (pp outermost → tp innermost, so tensor-parallel collectives
    ride the closest links).  ``device_type="cpu"`` builds a mesh of CPU
    ranks (gloo)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs the default process group: call "
            "torch.distributed.init_process_group first")
    names, sizes = _ordered_axes(axes, dist.get_world_size())
    ranks = torch.arange(dist.get_world_size()).reshape(sizes)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))


def single_device_mesh(*, device_type: str = "cuda"):
    return make_mesh({"dp": 1}, device_type=device_type)


def _resolve_axes(group: Mapping[str, int], total: int,
                  kind: str) -> Tuple[List[str], List[int]]:
    """Resolve one ``{axis: size}`` group against its budget (at most one
    ``-1`` size, inferred; the sizes must multiply to ``total``)."""
    names, sizes = list(group), list(group.values())
    if sizes.count(-1) > 1:
        raise ValueError(f"At most one {kind} axis size may be -1.")
    known = 1
    for s in sizes:
        if s != -1:
            known *= s
    if -1 in sizes:
        if total % known:
            raise ValueError(
                f"Cannot infer {kind} axis: {total} not divisible by {known}.")
        sizes = [total // known if s == -1 else s for s in sizes]
    product = 1
    for s in sizes:
        product *= s
    if product != total:
        raise ValueError(
            f"{kind} axes {dict(zip(names, sizes))} must multiply to {total} "
            f"({'slices' if kind == 'DCN' else 'devices per slice'}).")
    return names, sizes


def hybrid_layout(dcn_axes: Mapping[str, int], ici_axes: Mapping[str, int],
                  n_ranks: int, *, num_slices: Optional[int] = None):
    """``(axis names, rank array)`` of :func:`make_hybrid_mesh` over
    ``n_ranks`` ranks, without a process group: slice ``i`` holds the
    contiguous ranks ``[i * per, (i + 1) * per)`` (``num_slices`` of
    them, or one per host of ``LOCAL_WORLD_SIZE`` ranks), DCN axes
    outermost in the order given, then the ICI axes."""
    import torch

    if num_slices is None:
        per = int(os.environ.get("LOCAL_WORLD_SIZE", n_ranks) or n_ranks)
        if per < 1 or n_ranks % per:
            raise ValueError(f"{n_ranks} ranks are not whole hosts of "
                             f"LOCAL_WORLD_SIZE={per}.")
        num_slices = n_ranks // per
    if num_slices < 1 or n_ranks % num_slices:
        raise ValueError(
            f"{n_ranks} devices not divisible into {num_slices} slices.")
    per_slice = n_ranks // num_slices
    dcn_names, dcn_sizes = _resolve_axes(dcn_axes, num_slices, "DCN")
    ici_names, ici_sizes = _resolve_axes(ici_axes, per_slice, "ICI")
    overlap = set(dcn_names) & set(ici_names)
    if overlap:
        raise ValueError(
            f"Axes {sorted(overlap)} appear in both DCN and ICI groups.")
    ranks = torch.arange(n_ranks).reshape(dcn_sizes + ici_sizes)
    return tuple(dcn_names + ici_names), ranks


def make_hybrid_mesh(dcn_axes: Dict[str, int], ici_axes: Dict[str, int], *,
                     num_slices: Optional[int] = None,
                     device_type: str = "cuda"):
    """A named ``DeviceMesh`` whose ``dcn_axes`` stride across hosts and
    whose ``ici_axes`` stay within one (the counterpart of the JAX
    ``make_hybrid_mesh``): collectives over an ICI axis then ride NVLink
    only, those over a DCN axis cross hosts — the layout with dp / fsdp
    replicas across hosts and tp / sp / ep inside one.

    Hosts are the ranks grouped by ``LOCAL_WORLD_SIZE`` (torchrun's
    ranks per host; unset: one host), or ``num_slices`` equal
    contiguous blocks of ranks.  One size in each group may be ``-1``
    (inferred).  Needs the default process group
    (:func:`initialize_multihost`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_hybrid_mesh needs the default process group: call "
            "initialize_multihost (or init_process_group) first")
    names, ranks = hybrid_layout(dcn_axes, ici_axes, dist.get_world_size(),
                                 num_slices=num_slices)
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def initialize_multihost(init_method: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None, *,
                         backend: Optional[str] = None) -> int:
    """Start the default process group for a multi-host run and return
    this process's rank (the counterpart of the JAX
    ``initialize_multihost``, whose ``jax.distributed`` bootstrap this is
    for ``torch.distributed``).

    The arguments default to the launcher's environment:
    ``tcp://$MASTER_ADDR:$MASTER_PORT``, ``$WORLD_SIZE``, ``$RANK``.  The
    backend is NCCL where CUDA is available (each process then takes the
    card ``$LOCAL_RANK``), else gloo.  Idempotent: with a group already
    up it returns its rank; for one process with no address given it
    starts nothing and returns 0."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank()
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if init_method is None and os.environ.get("MASTER_ADDR"):
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if world_size == 1 and init_method is None:
        return 0
    if init_method is None:
        raise ValueError(f"a {world_size}-process run needs an address: "
                         f"init_method= or MASTER_ADDR / MASTER_PORT")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dist.get_rank()


class VirtualMesh:
    """One device's place in a mesh with no process group behind it: the
    ``{axis: size}`` shape (in :data:`DEFAULT_AXIS_ORDER`) and the
    device's ``coordinate``, ``{axis: index}``.  Materializing with it
    gives that device's local shards as plain tensors, so every
    coordinate of a mesh can be checked on one device."""

    def __init__(self, axes: Mapping[str, int], coordinate: Mapping[str, int]):
        if any(s < 1 for s in axes.values()):
            raise ValueError(f"a virtual mesh needs every size: {dict(axes)}")
        n = 1
        for s in axes.values():
            n *= s
        names, sizes = _ordered_axes(axes, n)
        self.shape: Dict[str, int] = dict(zip(names, sizes))
        if set(coordinate) != set(names) or not all(
                0 <= coordinate[a] < self.shape[a] for a in names):
            raise ValueError(f"coordinate {dict(coordinate)} is outside mesh "
                             f"{self.shape}")
        self.coordinate = tuple(coordinate[a] for a in names)

    def __repr__(self) -> str:
        return f"VirtualMesh({self.shape}, coordinate={self.coordinate})"
