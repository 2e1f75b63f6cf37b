"""Reshard execution (counterpart of ``torchdistx_tpu/reshard/engine.py``):
streaming checkpoint redistribution over the port's DCP payload.

A checkpoint of :mod:`..utils.checkpoint` stores each tensor leaf as
chunks (one per saved shard), each the raw bytes of the contiguous chunk
at a ``(file, offset, length)`` that DCP's ``.metadata`` records — the
topology lives in the chunk list, not in the values.  So the offline
reshard is a rechunk-copy: for each leaf, lay out plan B's shard blocks
in one of the destination's files, and stream budget-bounded slabs into
them, each slab assembled from the source chunks it overlaps (positioned
reads of only the bytes it needs) and written by positioned writes.  The destination's ``.metadata`` is the
source's with plan B's chunks, so it restores through the normal
:func:`~..utils.checkpoint.restore_checkpoint` path with the original
tree — proven bitwise-equal by the verify stage before the manifest +
commit marker are written.  Plain Python entries (the step counter) are
copied verbatim.

Memory bound (arXiv:2112.01075): every host-side staging buffer is a
chunk of at most ``TDX_RESHARD_CHUNK_MB`` (tracked by
:class:`_MemTracker`; :func:`last_transfer_peak_bytes` exposes the peak).
The online path (:func:`restore_resharded`) copies each slab into the
target shard on its device, so a full unsharded leaf never exists on
the host.

Failure contract (degrade-never-corrupt): any fault — including injected
``reshard``-site chaos — leaves the destination without a commit marker
(offline, and removes it), never quarantines anything, leaves the source
untouched, and raises :class:`~.diff.ReshardError`.  Online, a pytree
target comes back as new tensors and is never written; a train state is
restored in place (its module and optimizer are live objects), so after
a ``ReshardError`` its values are partly the checkpoint's and must not
be trained on (``run_elastic`` re-raises; relaunch with ``resume=True``).
"""

from __future__ import annotations

import dataclasses
import io
import os
import pickle
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import chaos, observe
from ..utils.checkpoint import (
    _IO_THREADS,
    _METADATA,
    _SUFFIX,
    _Location,
    _flatten,
    _from_bits,
    _is_array,
    _parallel,
    _pwrite_from,
    _read_box,
    _read_bytes,
    _read_metadata,
    _rebuild,
    _write_from,
    checkpoint_tree,
    is_committed,
    is_train_state,
    leaf_storage_name,
    read_manifest,
    state_topology,
    verify_checkpoint,
    write_manifest,
)
from ..utils.logging import get_logger
from .diff import (
    ReshardError,
    ReshardPlan,
    chunk_boxes,
    leaf_blocks,
    plan_from_manifest,
)

__all__ = [
    "last_transfer_peak_bytes",
    "needs_reshard",
    "plan_reshard",
    "reshard_checkpoint",
    "restore_resharded",
    "verify_reshard",
]


def _leaf_names(metadata) -> Tuple[List[str], List[str]]:
    """(tensor entries, plain-value entries) of a checkpoint, sorted."""
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    tensors, values = [], []
    for fqn, md in metadata.state_dict_metadata.items():
        (tensors if isinstance(md, TensorStorageMetadata) else values).append(fqn)
    return sorted(tensors), sorted(values)


def _slices(box):
    if not box:
        return Ellipsis  # rank-0 leaf
    return tuple(slice(lo, hi) for lo, hi in box)


def _box_bytes(box, itemsize: int) -> int:
    n = itemsize
    for lo, hi in box:
        n *= hi - lo
    return n


class _MemTracker:
    """Host staging-buffer accounting for the memory-bound contract
    (thread-safe: the verify stages compare slabs on several threads)."""

    __slots__ = ("current", "peak", "_lock")

    def __init__(self) -> None:
        self.current = 0
        self.peak = 0
        self._lock = threading.Lock()

    def alloc(self, nbytes: int) -> None:
        with self._lock:
            self.current += nbytes
            if self.current > self.peak:
                self.peak = self.current

    def free(self, nbytes: int) -> None:
        with self._lock:
            self.current -= nbytes


_last_tracker: Optional[_MemTracker] = None


def last_transfer_peak_bytes() -> int:
    """Peak tracked host staging bytes of the most recent reshard
    transfer in this process (0 if none ran) — the hook behind the
    "peak host memory stays bounded by the chunk budget" guarantee."""
    return _last_tracker.peak if _last_tracker else 0


def _budget_bytes(chunk_mb: Optional[float]) -> int:
    if chunk_mb is None:
        from .. import config

        chunk_mb = config.get().reshard_chunk_mb
    return max(1, int(float(chunk_mb) * (1 << 20)))


def _flip_chunk(buf: np.ndarray) -> None:
    """The ``reshard`` site's ``corrupt`` kind: damage the in-flight
    chunk buffer (torn-DMA model) — never a file."""
    flat = buf.reshape(-1)
    if flat.size:
        raw = flat.view(np.uint8)
        raw[0] ^= 0xFF


class _ChunkPump:
    """Shared read-chunk → chaos → account loop for both transfer paths."""

    def __init__(self, tracker: _MemTracker, chaos_plan) -> None:
        self.tracker = tracker
        self.chaos_plan = chaos_plan
        self.chunk_no = 0
        self.bytes_moved = 0

    def read(self, src: Path, metadata, name: str, box, itemsize: int
             ) -> np.ndarray:
        nbytes = _box_bytes(box, itemsize)
        self.tracker.alloc(nbytes)
        buf = _read_box(src, metadata, name, box)
        self.chunk_no += 1
        fired = chaos.maybe_inject(
            "reshard", self.chunk_no, plan=self.chaos_plan
        )
        if any(f.kind == "corrupt" for f in fired):
            _flip_chunk(buf)
        self.bytes_moved += nbytes
        observe.counter("tdx.reshard.chunks").inc()
        observe.counter("tdx.reshard.bytes_moved").inc(nbytes)
        return buf

    def release(self, box, itemsize: int) -> None:
        self.tracker.free(_box_bytes(box, itemsize))


def plan_reshard(src_dir, plan_b, mesh_b, *, chunk_mb: Optional[float] = None
                 ) -> ReshardPlan:
    """Compute the transfer schedule for redistributing ``src_dir`` to
    ``plan_b`` over ``mesh_b`` (a ``DeviceMesh``, ``VirtualMesh``,
    :class:`~.diff.MeshSpec`, or axes dict).  Pure metadata — safe on
    hosts with no GPU.  Emits a ``reshard.plan`` span."""
    src = Path(src_dir).absolute()
    budget = _budget_bytes(chunk_mb)
    with observe.span("reshard.plan", category="reshard", path=str(src)) as sp:
        manifest = read_manifest(src)
        if manifest is None:
            raise ReshardError(f"{src}: no manifest (is this a checkpoint?)")
        plan = plan_from_manifest(
            str(src), manifest, plan_b, mesh_b, budget_bytes=budget
        )
        sp.set(leaves=len(plan.leaves), chunks=plan.total_chunks,
               bytes=plan.total_bytes)
    return plan


def _dst_layout(metadata, plan: ReshardPlan):
    """Plan B's chunk list per tensor leaf, each leaf's blocks back to
    back in one of up to ``_IO_THREADS`` destination files (leaves dealt
    largest first to the lightest file): ``(state_dict_metadata,
    storage_data, blocks, values, file sizes)``, ``blocks`` as ``(file,
    name, box, offset, itemsize)`` and ``values`` as ``(file, name,
    source location, offset)``."""
    from torch.distributed.checkpoint.metadata import (
        ChunkStorageMetadata,
        MetadataIndex,
        TensorStorageMetadata,
    )

    by_name = plan.by_name
    tensors, values = _leaf_names(metadata)
    sizes = [0] * _IO_THREADS
    files = [f"__0_{k}{_SUFFIX}" for k in range(_IO_THREADS)]
    sd_md: Dict[str, Any] = {}
    storage: Dict[Any, _Location] = {}
    blocks: List[tuple] = []

    def nbytes(name):
        md = metadata.state_dict_metadata[name]
        return md.properties.dtype.itemsize * int(np.prod(list(md.size)))

    for name in sorted(tensors, key=nbytes, reverse=True):
        k = sizes.index(min(sizes))
        md = metadata.state_dict_metadata[name]
        shape = tuple(int(s) for s in md.size)
        itemsize = md.properties.dtype.itemsize
        entry = by_name.get(name)
        block = entry.dst_block_shape if entry else shape
        grid = tuple(s // max(1, b) for s, b in zip(shape, block))
        chunks = []
        for bbox in leaf_blocks(shape, grid):
            lo = torch.Size([a for a, _ in bbox])
            n = _box_bytes(bbox, itemsize)
            chunks.append(ChunkStorageMetadata(
                offsets=lo, sizes=torch.Size([b - a for a, b in bbox])))
            storage[MetadataIndex(name, lo)] = _Location(files[k], sizes[k], n)
            blocks.append((files[k], name, bbox, sizes[k], itemsize))
            sizes[k] += n
        sd_md[name] = TensorStorageMetadata(properties=md.properties,
                                            size=md.size, chunks=chunks)
    vals = []
    for name in values:
        loc = metadata.storage_data[MetadataIndex(name)]
        sd_md[name] = metadata.state_dict_metadata[name]
        storage[MetadataIndex(name)] = _Location(files[0], sizes[0], loc.length)
        vals.append((files[0], name, loc, sizes[0]))
        sizes[0] += loc.length
    blocks.sort(key=lambda blk: blk[1])  # leaves in name order, as stored
    return sd_md, storage, blocks, vals, dict(zip(files, sizes))


def reshard_checkpoint(
    src_dir,
    plan_b,
    mesh_b,
    dst_dir=None,
    *,
    chunk_mb: Optional[float] = None,
    verify: bool = True,
    chaos_plan=None,
) -> Path:
    """Redistribute a committed checkpoint to plan B's layout, offline.

    Streams each leaf from the source into a destination checkpoint whose
    chunks are plan B's shard blocks, copies the plain entries verbatim,
    bitwise-verifies leaf-by-leaf against a direct (chunked) read of the
    source, and only then writes the manifest — with plan B's topology
    block — and the commit marker.  Returns the destination path.

    On ANY failure the destination is removed (it never carried a commit
    marker), nothing is quarantined, the source is untouched, and a
    :class:`ReshardError` raises."""
    global _last_tracker
    src = Path(src_dir).absolute()
    ok, reason = verify_checkpoint(src)
    if not ok:
        raise ReshardError(f"source checkpoint failed verification: {reason}")
    plan = plan_reshard(src, plan_b, mesh_b, chunk_mb=chunk_mb)
    dst = Path(
        dst_dir
        if dst_dir is not None
        else src.with_name(f"{src.name}.reshard-{plan.dst_digest}")
    ).absolute()
    if dst == src:
        raise ReshardError(f"destination equals source: {dst}")
    log = get_logger()
    tracker = _MemTracker()
    _last_tracker = tracker
    pump = _ChunkPump(tracker, chaos_plan)
    try:
        if dst.exists():
            shutil.rmtree(dst)
        dst.mkdir(parents=True)
        metadata = _read_metadata(src)
        sd_md, storage, blocks, values, sizes = _dst_layout(metadata, plan)
        for fname, size in sizes.items():
            if size:
                with open(dst / fname, "wb") as f:
                    f.truncate(size)
        with observe.span(
            "reshard.transfer", category="reshard",
            src=str(src), dst=str(dst), mode="offline",
        ) as sp:
            fds = {fname: os.open(dst / fname, os.O_RDWR)
                   for fname, size in sizes.items() if size}
            try:
                last = None
                for fname, name, bbox, off, itemsize in blocks:
                    if name != last:
                        observe.counter("tdx.reshard.leaves").inc()
                    last = name
                    shape = tuple(hi - lo for lo, hi in bbox)
                    for cbox in chunk_boxes(bbox, itemsize, plan.budget_bytes):
                        buf = pump.read(src, metadata, name, cbox, itemsize)
                        try:
                            _write_from(fds[fname], off, shape, tuple(
                                lo for lo, _hi in _relative(cbox, bbox)), buf)
                        finally:
                            del buf
                            pump.release(cbox, itemsize)
                for fname, _name, loc, off in values:
                    _pwrite_from(fds[fname], memoryview(_read_bytes(src, loc)),
                                 off)
                for fd in fds.values():
                    os.fsync(fd)
            finally:
                for fd in fds.values():
                    os.close(fd)
            md = dataclasses.replace(metadata, state_dict_metadata=sd_md,
                                     storage_data=storage)
            with open(dst / _METADATA, "wb") as f:
                pickle.dump(md, f)
                f.flush()
                os.fsync(f.fileno())
            sp.set(leaves=len(plan.leaves), chunks=pump.chunk_no,
                   bytes=pump.bytes_moved, peak_host_bytes=tracker.peak)
        if verify:
            vok, vreason = verify_reshard(src, dst, chunk_mb=chunk_mb)
            if not vok:
                raise ReshardError(
                    f"bitwise verify failed after reshard: {vreason}"
                )
        write_manifest(
            dst,
            tree=read_manifest(src).get("tree"),
            topology=plan.to_topology(),
        )
        log.info(
            "reshard: %s -> %s (%d leaves, %d chunks, %d bytes, peak %d B)",
            src, dst, len(plan.leaves), pump.chunk_no, pump.bytes_moved,
            tracker.peak,
        )
        return dst
    except ReshardError:
        shutil.rmtree(dst, ignore_errors=True)
        raise
    except Exception as e:
        shutil.rmtree(dst, ignore_errors=True)
        raise ReshardError(f"reshard {src} -> {dst} failed: {e}") from e


def _compare_slabs(works, budget: int, compare) -> Optional[tuple]:
    """Run ``compare(work, box)`` over every budget-sized box of each work
    item ``(work, box of the leaf, itemsize)`` on up to ``_IO_THREADS``
    threads, each box a ``budget / threads`` slab so the slabs in flight
    stay within the budget; the first ``(work, box)`` in order whose
    compare is false, else None."""
    slab = max(1, budget // _IO_THREADS)
    jobs = [(work, cbox) for work, box, itemsize in works
            for cbox in chunk_boxes(box, itemsize, slab)]
    same = _parallel(lambda job: compare(*job), jobs)
    return next((job for job, ok in zip(jobs, same) if not ok), None)


def _verify_fail(sp, reason: str, **attrs) -> Tuple[bool, str]:
    sp.set(ok=False)
    observe.counter("tdx.reshard.verify_fail").inc()
    observe.instant("reshard.verify_fail", category="reshard",
                    reason=reason[:200], **attrs)
    return False, reason


def verify_reshard(src_dir, dst_dir, *, chunk_mb: Optional[float] = None,
                   ) -> "tuple[bool, str]":
    """Streaming bitwise leaf-by-leaf comparison of two checkpoints'
    stored values (chunked — bounded host memory; layout-independent, so
    a resharded copy compares clean against its source).  Committed
    sides additionally pass their own integrity manifest (whole-file
    CRCs), so damage to bytes no leaf read touches still fails the
    verify.  Returns ``(ok, reason)``; increments
    ``tdx.reshard.verify_fail`` on a mismatch."""
    from torch.distributed.checkpoint.metadata import MetadataIndex

    src, dst = Path(src_dir).absolute(), Path(dst_dir).absolute()
    budget = _budget_bytes(chunk_mb)
    with observe.span(
        "reshard.verify", category="reshard", src=str(src), dst=str(dst)
    ) as sp:
        for side, label in ((src, "src"), (dst, "dst")):
            if is_committed(side):
                iok, ireason = verify_checkpoint(side)
                if not iok:
                    return _verify_fail(sp, f"{label} integrity: {ireason}",
                                        side=label)
        ma, mb = _read_metadata(src), _read_metadata(dst)
        (ta, va), (tb, vb) = _leaf_names(ma), _leaf_names(mb)
        if ta != tb or va != vb:
            diff = sorted(set(ta + va) ^ set(tb + vb))
            return _verify_fail(sp, f"leaf sets differ: {diff}")
        for name in va:
            if _read_bytes(src, ma.storage_data[MetadataIndex(name)]) != \
                    _read_bytes(dst, mb.storage_data[MetadataIndex(name)]):
                return _verify_fail(sp, f"{name}: value differs", leaf=name)
        works = []
        for name in ta:
            a, b = ma.state_dict_metadata[name], mb.state_dict_metadata[name]
            if tuple(a.size) != tuple(b.size) or \
                    a.properties.dtype != b.properties.dtype:
                return _verify_fail(
                    sp, f"{name}: {tuple(a.size)} {a.properties.dtype} != "
                        f"{tuple(b.size)} {b.properties.dtype}", leaf=name)
            works.append((name, tuple((0, int(s)) for s in a.size),
                          a.properties.dtype.itemsize))

        def compare(name, cbox):
            return np.array_equal(
                _read_box(src, ma, name, cbox).reshape(-1).view(np.uint8),
                _read_box(dst, mb, name, cbox).reshape(-1).view(np.uint8))

        bad = _compare_slabs(works, budget, compare)
        if bad is not None:
            name, cbox = bad
            return _verify_fail(sp, f"{name}: bitwise mismatch in box {cbox}",
                                leaf=name, box=str(cbox))
        sp.set(ok=True, leaves=len(ta) + len(va))
    return True, "ok"


# ---------------------------------------------------------------------------
# online path: stream a checkpoint directly into a differently-sharded state


def needs_reshard(path, target: Any) -> bool:
    """Does ``path``'s recorded topology differ from the layout of the
    live ``target`` (a pytree or a train state)?  ``False`` for manifests
    without a topology block."""
    manifest = read_manifest(path)
    topo = (manifest or {}).get("topology")
    if not topo:
        return False
    cur = state_topology(target)
    if cur is None:
        return False
    return (
        topo.get("mesh_axes") != cur["mesh_axes"]
        or topo.get("specs") != cur["specs"]
    )


def _local_box(t: torch.Tensor) -> Tuple[torch.Tensor, tuple]:
    """``(the tensor this rank holds of t, its box in the global leaf)``:
    a DTensor's local shard, a plain tensor whole."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t, tuple((0, int(s)) for s in t.shape)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    if not all(isinstance(p, (Shard, Replicate)) and
               type(p) in (Shard, Replicate) for p in t.placements):
        raise ReshardError(
            f"placements {t.placements} do not hold one box of the leaf "
            f"per rank")
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return t._local_tensor, tuple((int(o), int(o) + int(s))
                                  for o, s in zip(offset, shape))


def restore_resharded(
    src_dir,
    target: Any,
    *,
    chunk_mb: Optional[float] = None,
    chaos_plan=None,
    verify: bool = True,
) -> Any:
    """Stream a committed checkpoint directly into ``target``'s layout —
    the in-flight elastic path when a relaunch lands on another mesh.

    Each tensor leaf of ``target`` is filled shard by shard: this rank's
    box of the leaf (a DTensor's local shard, a plain tensor whole) is
    read in budget-bounded slabs, each assembled from the stored chunks
    it overlaps and copied into place on the target's device, so no host
    ever stages more than a slab.  A pytree target comes back as new
    tensors laid out as its own; a train state is restored in place (see
    the module docstring) and returned.  ``verify=True`` re-reads the
    source and bitwise-compares every restored shard against it before
    returning: transfer-path corruption — including injected
    ``reshard`` chaos — surfaces as :class:`ReshardError`, never as
    silently wrong training state."""
    global _last_tracker
    src = Path(src_dir).absolute()
    if not is_committed(src):
        raise ReshardError(f"{src}: not a committed checkpoint")
    budget = _budget_bytes(chunk_mb)
    tracker = _MemTracker()
    _last_tracker = tracker
    pump = _ChunkPump(tracker, chaos_plan)
    train = is_train_state(target)
    try:
        from torch.distributed.checkpoint.metadata import (
            MetadataIndex,
            TensorStorageMetadata,
        )

        metadata = _read_metadata(src)
        pairs = _flatten(checkpoint_tree(target))
        out: Dict[tuple, Any] = {}
        with observe.span(
            "reshard.transfer", category="reshard",
            src=str(src), mode="online",
        ) as sp, torch.no_grad():
            for keypath, leaf in pairs:
                name = leaf_storage_name(keypath)
                md = metadata.state_dict_metadata.get(name)
                if md is None:
                    raise ReshardError(f"{src}: leaf {name!r} not stored")
                if not _is_array(leaf):
                    raw = _read_bytes(src, metadata.storage_data[
                        MetadataIndex(name)])
                    out[keypath] = torch.load(io.BytesIO(raw),
                                              weights_only=False)
                    continue
                if not isinstance(md, TensorStorageMetadata):
                    raise ReshardError(f"{name}: stored as a value, not a "
                                       f"tensor")
                if tuple(md.size) != tuple(leaf.shape):
                    raise ReshardError(
                        f"{name}: stored shape {tuple(md.size)} != "
                        f"target shape {tuple(leaf.shape)}"
                    )
                dt = md.properties.dtype
                if dt != leaf.dtype:
                    raise ReshardError(
                        f"{name}: stored dtype {dt} != target {leaf.dtype}"
                    )
                dest = leaf.detach() if train else torch.empty_like(
                    leaf.detach())
                local, box = _local_box(dest)
                for cbox in chunk_boxes(box, dt.itemsize, budget):
                    buf = pump.read(src, metadata, name, cbox, dt.itemsize)
                    try:
                        local[_slices(_relative(cbox, box))].copy_(
                            _from_bits(buf, dt))
                    finally:
                        del buf
                        pump.release(cbox, dt.itemsize)
                out[keypath] = leaf if train else dest
                observe.counter("tdx.reshard.leaves").inc()
            sp.set(leaves=len(pairs), chunks=pump.chunk_no,
                   bytes=pump.bytes_moved, peak_host_bytes=tracker.peak)
        if verify:
            _verify_restored(src, metadata, out, budget, tracker)
        if train:
            target["step"] = int(out[(("key", "step"),)])
            return target
        return _rebuild(target, out)
    except ReshardError:
        raise
    except Exception as e:
        raise ReshardError(f"online reshard from {src} failed: {e}") from e


def _relative(box, outer) -> tuple:
    return tuple((lo - o, hi - o) for (lo, hi), (o, _e) in zip(box, outer))


def _verify_restored(src: Path, metadata, restored: Dict[tuple, Any],
                     budget: int, tracker: _MemTracker) -> None:
    """Bitwise-compare every restored shard against a fresh chunked read
    of the source — the online degrade-never-corrupt gate."""
    with observe.span(
        "reshard.verify", category="reshard", src=str(src), mode="online"
    ) as sp:
        works = []
        for keypath, leaf in restored.items():
            if _is_array(leaf):
                local, box = _local_box(leaf.detach())
                works.append(((leaf_storage_name(keypath), local, box), box,
                              leaf.dtype.itemsize))

        def compare(work, cbox):
            name, local, box = work
            nbytes = 2 * _box_bytes(cbox, local.dtype.itemsize)
            tracker.alloc(nbytes)
            try:
                want = _read_box(src, metadata, name, cbox)
                got = local[_slices(_relative(cbox, box))].to("cpu")
                return np.array_equal(
                    want.reshape(-1).view(np.uint8),
                    got.contiguous().reshape(-1).view(torch.uint8).numpy())
            finally:
                tracker.free(nbytes)

        bad = _compare_slabs(works, budget, compare)
        if bad is not None:
            (name, _local, _box), cbox = bad
            observe.counter("tdx.reshard.verify_fail").inc()
            observe.instant(
                "reshard.verify_fail", category="reshard",
                leaf=name, box=str(cbox), mode="online",
            )
            sp.set(ok=False)
            raise ReshardError(
                f"online reshard verify failed for leaf {name!r} "
                f"(box {cbox}) — restored state discarded, source "
                f"checkpoint untouched"
            )
        sp.set(ok=True)
