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
.init_process_group`` with its own address, world size and rank); the
mesh spans every rank of it.  :class:`VirtualMesh` names one coordinate
of a mesh that has no process group behind it.
"""

from __future__ import annotations

from typing import Dict, Mapping

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
