"""Sharded checkpoint / resume over ``torch.distributed.checkpoint`` (DCP)
with integrity manifests (counterpart of ``torchdistx_tpu/utils/checkpoint.py``).

Materialized, sharded training state checkpoints through DCP with each
rank writing only its own shards (DTensor local shards, FSDP2's
included; a replicated tensor once), and restores into whatever layout
the target has, so a resume can change the mesh.

On top of the DCP payload every checkpoint carries a **manifest**
(``tdx_manifest.json``: the state's leaf tree plus per-file size +
CRC32) and an explicit **commit marker** (``TDX_COMMITTED``, written
last, with the manifest's own checksum).  Together they make three
guarantees the bare DCP layout cannot:

* a checkpoint without the marker was never fully written: resume code
  skips it instead of crashing mid-restore on a torn write;
* a committed checkpoint whose payload later rots (truncation, bit
  flips) fails :func:`verify_checkpoint` *before* restore reads garbage
  into training state;
* a bad checkpoint is :func:`quarantine_checkpoint`-renamed to
  ``<dir>.corrupt``: kept for forensics, invisible to resume scans.

The manifest also records a **topology block** (the mesh axis names and
sizes, each leaf's PartitionSpec string, a plan digest:
:func:`state_topology`), so a restore can detect that the checkpoint was
written under another plan or mesh and route through
:mod:`torchdistx_tpu_torch.reshard`.  The manifest's JSON schema is the
JAX package's.

**State.**  A state is a pytree (nested dicts, lists and tuples) of
tensors and plain Python values, or a train state of
:func:`..parallel.make_train_step` (``{"model", "params", "opt",
"step", ...}``, a live module and optimizer).  A train state is saved as
the tree ``{"params": {name: parameter}, "opt": {key: {name: tensor}},
"step": int}`` (:func:`checkpoint_tree`): each optimizer entry is named
after its parameter (``opt.exp_avg.blocks.0.attn.wq.weight``), so a
sharding plan's rules match the moments as they match the parameters,
and the optimizer's per-parameter ``step`` tensors ride along, so a
resume is bitwise.  Leaves are addressed by :func:`leaf_storage_name`,
the DCP key of each entry.

**Payload.**  DCP's planners, metadata and collectives, with a storage
layer of this module's own: each rank writes each of its chunks as the
raw bytes of the contiguous tensor into one of up to 8 files
(``__<rank>_<k>.distcp``, written and later checksummed on a thread
each) and records ``(file, offset, length)`` in DCP's ``.metadata``.
So any box of a leaf can be read in budget-sized slabs by the reshard
engine (:func:`_read_box`: positioned reads of a stored chunk's
contiguous runs, short runs a span of rows at a time through a small
bounce buffer).  DCP's own ``FileSystemWriter`` stores a ``torch.save``
record per chunk (not readable in slabs), and its ``SAFETENSORS``
format writes one safetensors blob per file whose recorded offsets are
not the tensors' (and needs the ``safetensors`` package).

Verification telemetry: ``ckpt.save`` / ``ckpt.restore`` /
``ckpt.verify`` spans, ``tdx.ckpt.verify_fail`` /
``tdx.ckpt.quarantined`` counters.
"""

from __future__ import annotations

import dataclasses
import io
import itertools
import json
import os
import pickle
import re
import shutil
import threading
import warnings
import zlib
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import observe

MANIFEST_NAME = "tdx_manifest.json"
COMMIT_MARKER = "TDX_COMMITTED"
QUARANTINE_SUFFIX = ".corrupt"
_METADATA = ".metadata"
_SUFFIX = ".distcp"

__all__ = [
    "AsyncCheckpointSaver",
    "CheckpointCorruptError",
    "checkpoint_tree",
    "checkpoint_version",
    "is_committed",
    "iter_payload_files",
    "leaf_storage_name",
    "quarantine_checkpoint",
    "read_manifest",
    "restore_checkpoint",
    "save_checkpoint",
    "state_topology",
    "verify_checkpoint",
    "write_manifest",
]


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (or has no commit
    marker).  Carries the human-readable reason in ``args[0]``."""


# ---------------------------------------------------------------------------
# process group helpers: every rank saves; rank 0 writes what is shared


def _dist_on() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _is_writer() -> bool:
    """Rank 0 of the default group (or a process without one): the rank
    that writes manifests, markers and renames."""
    import torch.distributed as dist

    return not _dist_on() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist

    if _dist_on():
        dist.barrier()


def _any_rank(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank of the default group (a
    collective: every rank calls it)."""
    import torch.distributed as dist

    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(flag)], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


# ---------------------------------------------------------------------------
# pytrees: nested dicts (keys sorted, as jax flattens them), lists, tuples


Keypath = Tuple[Tuple[str, Any], ...]  # (("key", name) | ("idx", i), ...)


def _flatten(tree: Any, prefix: Keypath = ()) -> List[Tuple[Keypath, Any]]:
    """``(keypath, leaf)`` pairs in jax's order; ``None`` is an empty
    subtree, as in jax."""
    if isinstance(tree, dict):
        out: List[Tuple[Keypath, Any]] = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (("key", k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, prefix + (("idx", i),))
        return out
    if tree is None:
        return []
    return [(prefix, tree)]


def _keystr(keypath: Keypath) -> str:
    """``jax.tree_util.keystr`` of the same path: ``['opt']['step'][0]``."""
    return "".join(f"[{k!r}]" if kind == "key" else f"[{k}]"
                   for kind, k in keypath)


def leaf_storage_name(keypath: Keypath) -> str:
    """The DCP key of a leaf: keypath components joined with ``.`` (dict
    keys by name, sequence positions by index) — ``{"opt": {"exp_avg":
    {"embed.weight": t}}}`` stores ``t`` as ``opt.exp_avg.embed.weight``.
    The reshard engine addresses leaves by it, and the manifest topology
    block's per-leaf spec table is keyed by it (the JAX package's
    joining rule)."""
    return ".".join(str(k) for _kind, k in keypath)


_KEYSTR_PART = re.compile(r"\['((?:[^'\\]|\\.)*)'\]|\[(\d+)\]")


def _parse_keystr(keystr: str) -> Keypath:
    out = []
    for m in _KEYSTR_PART.finditer(keystr):
        if m.group(1) is not None:
            out.append(("key", m.group(1)))
        else:
            out.append(("idx", int(m.group(2))))
    return tuple(out)


def _unflatten(pairs: List[Tuple[Keypath, Any]]) -> Any:
    """Nested dicts and lists from ``(keypath, value)`` pairs."""
    root: Dict[Any, Any] = {}
    for keypath, value in pairs:
        node = root
        for i, (_kind, k) in enumerate(keypath):
            if i == len(keypath) - 1:
                node[k] = value
            else:
                node = node.setdefault(k, {})

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and all(isinstance(k, int) for k in node):
            return [node[i] for i in sorted(node)]
        return node

    return fix(root)


def _is_array(leaf: Any) -> bool:
    return isinstance(leaf, torch.Tensor)


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` → ``"bfloat16"``: the manifest's dtype strings
    are numpy's / jax's names."""
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# train states: a live module and optimizer as a tree of tensors


def is_train_state(state: Any) -> bool:
    """A :func:`..parallel.make_train_step` state: ``model``, ``opt``,
    ``params``, ``step``."""
    return (isinstance(state, dict) and isinstance(state.get("model"), nn.Module)
            and isinstance(state.get("opt"), torch.optim.Optimizer)
            and "params" in state)


def _ensure_optimizer_state(opt: torch.optim.Optimizer) -> None:
    """Give every parameter of an Adam / AdamW optimizer the state its
    first ``step`` would create (zero moments, a zero step counter of the
    dtype and device torch gives it), so a checkpoint taken before the
    first step holds every entry and a restore has somewhere to write.
    The first step then runs exactly as from fresh state.  Other
    optimizers are left as they are (SGD without momentum keeps none)."""
    if not isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
        return
    for group in opt.param_groups:
        fused = bool(group.get("fused")) or bool(group.get("capturable"))
        for p in group["params"]:
            st = opt.state[p]
            if st:
                continue
            if fused:
                st["step"] = torch.zeros((), dtype=torch.float32,
                                         device=p.device)
            else:
                st["step"] = torch.tensor(
                    0.0, dtype=torch.float64
                    if torch.get_default_dtype() == torch.float64
                    else torch.float32)
            st["exp_avg"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            if group.get("amsgrad"):
                st["max_exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)


def checkpoint_tree(state: Any) -> Any:
    """What a checkpoint of ``state`` holds: the state itself for a
    pytree; for a train state, ``{"params": {name: parameter}, "opt":
    {key: {name: tensor}}, "step": int}`` over the parameters the
    optimizer updates (``state["params"]``), named as the module names
    them; the live tensors, not copies."""
    if not is_train_state(state):
        return state
    model, opt = state["model"], state["opt"]
    names = {id(p): n for n, p in model.named_parameters()}
    _ensure_optimizer_state(opt)
    params: Dict[str, torch.Tensor] = {}
    moments: Dict[str, Dict[str, torch.Tensor]] = {}
    for p in state["params"]:
        name = names[id(p)]
        params[name] = p
        for k, v in opt.state.get(p, {}).items():
            if isinstance(v, torch.Tensor):
                moments.setdefault(k, {})[name] = v
    tree: Dict[str, Any] = {"params": params, "step": int(state["step"])}
    if moments:
        tree["opt"] = moments
    return tree


def _flat_dict(tree: Any) -> Dict[str, Any]:
    """``{storage name: leaf}``, the dict DCP saves and loads."""
    return {leaf_storage_name(kp): leaf for kp, leaf in _flatten(tree)}


# ---------------------------------------------------------------------------
# manifest + commit marker


def iter_payload_files(path: "str | Path") -> Iterator[str]:
    """Relative paths of every file under ``path`` except our own
    manifest/marker — i.e. the DCP payload the checksums cover."""
    path = Path(path)
    for root, _dirs, files in os.walk(path):
        for name in files:
            if name in (MANIFEST_NAME, COMMIT_MARKER):
                continue
            yield str((Path(root) / name).relative_to(path))


# Files a rank writes its chunks to, each on a thread of its own; the
# CRC32 passes of the manifest and the verify run one file per thread
# (zlib and file reads release the GIL), so a checkpoint's files are
# checksummed in parallel.
_IO_THREADS = max(1, min(8, os.cpu_count() or 1))


def _parallel(fn, args: list) -> list:
    """``[fn(a) for a in args]``, on up to ``_IO_THREADS`` threads."""
    if len(args) <= 1:
        return [fn(a) for a in args]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(min(_IO_THREADS, len(args))) as ex:
        return list(ex.map(fn, args))


def _crc32_file(f: Path) -> Tuple[int, int]:
    """(size, crc32) streamed in chunks — checkpoints can dwarf RAM."""
    crc = 0
    size = 0
    with open(f, "rb") as fh:
        while True:
            chunk = fh.read(1 << 24)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return size, crc


def _leaf_tree(tree: Any) -> List[dict]:
    out: List[dict] = []
    for keypath, leaf in _flatten(tree):
        entry: dict = {"path": _keystr(keypath)}
        if _is_array(leaf):
            entry["shape"] = list(leaf.shape)
            entry["dtype"] = _dtype_name(leaf.dtype)
        out.append(entry)
    return out


def _mesh_axes(mesh) -> Dict[str, int]:
    root = getattr(mesh, "_get_root_mesh", None)
    mesh = root() if root is not None else mesh
    return {str(a): int(s) for a, s in zip(mesh.mesh_dim_names, mesh.shape)}


def _placement_spec(t) -> Any:
    """A DTensor's layout as a PartitionSpec (axes in mesh order; ``P()``
    when every dim is replicated)."""
    from ..parallel.sharding import PartitionSpec
    from ..parallel.spmd import axis_dims

    dims = axis_dims(t.placements, t.device_mesh.mesh_dim_names)
    per_dim = [tuple(a for a, d in dims.items() if d == i)
               for i in range(t.ndim)]
    if not any(per_dim):
        return PartitionSpec()
    return PartitionSpec(*(None if not a else a[0] if len(a) == 1 else a
                           for a in per_dim))


def state_topology(state: Any) -> Optional[dict]:
    """The manifest ``topology`` block of a state: mesh axis names and
    sizes, each tensor leaf's PartitionSpec string (keyed by storage
    name) and a plan digest over both.  ``None`` when the state has no
    tensor leaves.  A DTensor records its placements (and its root
    mesh); a plain tensor records as replicated, ``"()"``.  A train state
    over a mesh (``state["mesh"]``) records that mesh even where every
    tensor is plain (a data-parallel replica)."""
    from torch.distributed.tensor import DTensor

    from ..parallel.sharding import plan_digest, spec_str

    mesh_axes: dict = {}
    if is_train_state(state) and state.get("mesh") is not None:
        mesh_axes = _mesh_axes(state["mesh"])
    specs: dict = {}
    for keypath, leaf in _flatten(checkpoint_tree(state)):
        if not _is_array(leaf):
            continue
        if isinstance(leaf, DTensor):
            mesh_axes = mesh_axes or _mesh_axes(leaf.device_mesh)
            specs[leaf_storage_name(keypath)] = spec_str(_placement_spec(leaf))
        else:
            specs[leaf_storage_name(keypath)] = spec_str(None)
    if not specs:
        return None
    return {
        "mesh_axes": mesh_axes,
        "specs": specs,
        "plan_digest": plan_digest(mesh_axes, specs),
    }


def write_manifest(
    path: "str | Path",
    state: Any = None,
    *,
    tree: Optional[List[dict]] = None,
    topology: Optional[dict] = None,
) -> dict:
    """Checksum the payload, write ``tdx_manifest.json``, then commit by
    writing ``TDX_COMMITTED`` (containing the manifest's CRC32) LAST —
    marker presence therefore implies the manifest, and the manifest
    implies every payload byte it lists.  The leaf tree and topology
    block come from ``state``, or precomputed via ``tree`` / ``topology``
    (async savers stash them at save time).  Returns the manifest dict."""
    path = Path(path)
    rels = sorted(iter_payload_files(path))
    files = {rel: {"size": size, "crc32": f"{crc:08x}"} for rel, (size, crc)
             in zip(rels, _parallel(lambda r: _crc32_file(path / r), rels))}
    manifest = {"version": 1, "files": files}
    if state is not None:
        if tree is None:
            tree = _leaf_tree(checkpoint_tree(state))
        if topology is None:
            topology = state_topology(state)
    if tree is not None:
        manifest["tree"] = tree
    if topology is not None:
        manifest["topology"] = topology
    payload = json.dumps(manifest, indent=1, sort_keys=True).encode()
    tmp = path / (MANIFEST_NAME + ".tmp")
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path / MANIFEST_NAME)
    with open(path / COMMIT_MARKER, "w") as f:
        f.write(f"{zlib.crc32(payload):08x}\n")
        f.flush()
        os.fsync(f.fileno())
    return manifest


def is_committed(path: "str | Path") -> bool:
    """Cheap commit check: marker file present (no payload verification)."""
    return (Path(path) / COMMIT_MARKER).is_file()


def read_manifest(path: "str | Path") -> Optional[dict]:
    """The parsed ``tdx_manifest.json`` of a checkpoint, or ``None`` when
    there is no (readable) manifest."""
    mf = Path(path) / MANIFEST_NAME
    try:
        return json.loads(mf.read_bytes())
    except (OSError, ValueError):
        return None


def checkpoint_version(path: "str | Path") -> str:
    """The weight-version stamp of a checkpoint:
    ``<dirname>@<manifest-digest>`` — e.g. ``step_12@a1b2c3d4`` (the
    commit marker's CRC32 of the manifest bytes, which transitively
    covers every payload byte).  Uncommitted checkpoints stamp as
    ``<dirname>@uncommitted``."""
    path = Path(path)
    try:
        digest = (path / COMMIT_MARKER).read_text().strip()[:8]
    except OSError:
        digest = ""
    return f"{path.name}@{digest or 'uncommitted'}"


def verify_checkpoint(path: "str | Path") -> Tuple[bool, str]:
    """Integrity-check a checkpoint against its manifest.

    Returns ``(ok, reason)``; ``reason`` names the first failure
    (uncommitted, manifest/marker mismatch, missing file, size or CRC
    mismatch).  Extra files beyond the manifest are tolerated.
    Increments ``tdx.ckpt.verify_fail`` on failure."""
    path = Path(path)
    with observe.span("ckpt.verify", category="ckpt", path=str(path)) as sp:
        ok, reason = _verify(path)
        sp.set(ok=ok, **({} if ok else {"reason": reason}))
    if not ok:
        observe.counter("tdx.ckpt.verify_fail").inc()
        observe.instant("ckpt.verify_fail", category="ckpt",
                        path=str(path), reason=reason)
    return ok, reason


def _verify(path: Path) -> Tuple[bool, str]:
    if not path.is_dir():
        return False, f"not a directory: {path}"
    marker = path / COMMIT_MARKER
    if not marker.is_file():
        return False, "no commit marker (save never completed)"
    mf = path / MANIFEST_NAME
    if not mf.is_file():
        return False, "commit marker without manifest"
    raw = mf.read_bytes()
    try:
        want = marker.read_text().strip()
    except OSError as e:
        return False, f"unreadable commit marker: {e}"
    if f"{zlib.crc32(raw):08x}" != want:
        return False, "manifest checksum does not match commit marker"
    try:
        manifest = json.loads(raw)
    except ValueError as e:
        return False, f"unparseable manifest: {e}"
    listed = list(manifest.get("files", {}).items())
    for rel, meta in listed:
        # Presence and size first (a stat each), so a missing or
        # truncated payload is caught without reading anything; the
        # messages are the ones the CRC pass would give.
        f = path / rel
        if not f.is_file():
            return False, f"missing payload file: {rel}"
        size = f.stat().st_size
        if size != meta["size"]:
            return False, f"size mismatch for {rel}: {size} != {meta['size']}"
    sums = _parallel(lambda item: _crc32_file(path / item[0]), listed)
    for (rel, meta), (size, crc) in zip(listed, sums):
        if size != meta["size"]:
            return False, f"size mismatch for {rel}: {size} != {meta['size']}"
        if f"{crc:08x}" != meta["crc32"]:
            return False, f"crc mismatch for {rel}"
    return True, "ok"


def quarantine_checkpoint(path: "str | Path") -> Path:
    """Rename a bad checkpoint out of the resume scan's sight
    (``step_N`` → ``step_N.corrupt``, suffixed ``.2``, ``.3``… if a prior
    quarantine of the same step exists).  Returns the new path."""
    path = Path(path)
    dst = path.with_name(path.name + QUARANTINE_SUFFIX)
    n = 1
    while dst.exists():
        n += 1
        dst = path.with_name(path.name + f"{QUARANTINE_SUFFIX}.{n}")
    os.replace(path, dst)
    observe.counter("tdx.ckpt.quarantined").inc()
    observe.instant("ckpt.quarantined", category="ckpt",
                    path=str(path), quarantined_to=str(dst))
    return dst


# ---------------------------------------------------------------------------
# the storage layer: raw chunk bytes at recorded (file, offset, length)


@dataclasses.dataclass(frozen=True)
class _Location:
    """Where one stored chunk (or bytes entry) lies: DCP's
    ``storage_data`` value of this storage layer."""

    relative_path: str
    offset: int
    length: int


def _bits_dtype(itemsize: int) -> np.dtype:
    """The unsigned integer numpy type of ``itemsize`` bytes: chunks move
    as bits, so bfloat16 (which numpy lacks) moves as uint16."""
    try:
        return np.dtype({1: "u1", 2: "<u2", 4: "<u4", 8: "<u8"}[itemsize])
    except KeyError:
        raise ValueError(f"no {itemsize}-byte element type") from None


def _as_bits(t: torch.Tensor) -> np.ndarray:
    """The bytes of a contiguous CPU tensor, as a uint8 numpy view."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _from_bits(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A tensor of ``dtype`` over the bits of ``arr`` (a copy when ``arr``
    is not contiguous or not writable)."""
    if not arr.flags.c_contiguous or not arr.flags.writeable:
        arr = np.array(arr, copy=True, order="C")
    return torch.from_numpy(arr).view(dtype)


def _c_strides(shape) -> List[int]:
    out, n = [], 1
    for s in reversed(shape):
        out.append(n)
        n *= s
    return out[::-1]


def _runs(a_shape, a_lo, b_shape, b_lo, extent):
    """The runs that copy a box of ``extent`` elements from position
    ``a_lo`` of a C-order array of ``a_shape`` to position ``b_lo`` of
    one of ``b_shape``: ``(a start, b start, length)`` in elements, each
    run contiguous in both.  A run spans the trailing dims both arrays
    hold whole, and the one dim before them."""
    nd = len(extent)
    if nd == 0:
        yield 0, 0, 1
        return
    j = nd - 1
    while j > 0 and extent[j] == a_shape[j] == b_shape[j]:
        j -= 1
    n = 1
    for d in range(j, nd):
        n *= extent[d]
    sa, sb = _c_strides(a_shape), _c_strides(b_shape)
    base_a = sum(a_lo[d] * sa[d] for d in range(nd))
    base_b = sum(b_lo[d] * sb[d] for d in range(nd))
    for idx in itertools.product(*(range(extent[d]) for d in range(j))):
        yield (base_a + sum(i * sa[d] for d, i in enumerate(idx)),
               base_b + sum(i * sb[d] for d, i in enumerate(idx)), n)


def _pread_into(fd: int, view: memoryview, offset: int) -> None:
    while len(view):
        n = os.preadv(fd, [view], offset)
        if n <= 0:
            raise CheckpointCorruptError(
                f"short read at offset {offset}: the payload is truncated")
        view, offset = view[n:], offset + n


def _pwrite_from(fd: int, view: memoryview, offset: int) -> None:
    while len(view):
        n = os.pwritev(fd, [view], offset)
        view, offset = view[n:], offset + n


# Runs shorter than this are read in spans of several rows into a bounce
# buffer of about this size and copied out: one positioned read per span
# in place of one per row (a row may be a few KB).
_BOUNCE = 4 << 20


def _read_into(fd: int, offset: int, chunk_shape, region_lo, out: np.ndarray,
               out_lo, extent) -> None:
    """Copy the box of ``extent`` at ``region_lo`` of the chunk stored at
    ``offset`` (C order, ``chunk_shape``) into ``out`` at ``out_lo``.
    Long contiguous runs are read straight into ``out``; short ones (a
    box narrower than the chunk's rows) a span of rows at a time through
    a bounce buffer of about ``_BOUNCE`` bytes, read once and copied out
    by strided views."""
    isz = out.itemsize
    raw = memoryview(out.reshape(-1).view(np.uint8))
    runs = list(itertools.islice(
        _runs(chunk_shape, region_lo, out.shape, out_lo, extent), 2))
    if len(runs) < 2 or runs[0][2] * isz >= _BOUNCE:
        for a, b, n in _runs(chunk_shape, region_lo, out.shape, out_lo,
                             extent):
            _pread_into(fd, raw[b * isz:(b + n) * isz], offset + a * isz)
        return
    # The runs step along one row dim r (the dim before the run's): its
    # strides in the chunk and in out give each row's start.
    nd = len(extent)
    r = nd - 1
    while r > 0 and extent[r] == chunk_shape[r] == out.shape[r]:
        r -= 1
    r -= 1
    n = runs[0][2]
    sa, sb = _c_strides(chunk_shape)[r], _c_strides(out.shape)[r]
    rows = extent[r]
    per = max(1, _BOUNCE // (sa * isz))
    flat = out.reshape(-1)
    # Every run of row 0 of each outer index, then the rows in spans.
    for a0, b0, _n in _runs(chunk_shape, region_lo, out.shape, out_lo,
                            tuple(extent[:r]) + (1,) + tuple(extent[r + 1:])):
        for r0 in range(0, rows, per):
            k = min(per, rows - r0)
            span = np.empty((k - 1) * sa + n, flat.dtype)
            _pread_into(fd, memoryview(span.view(np.uint8)),
                        offset + (a0 + r0 * sa) * isz)
            src = np.lib.stride_tricks.as_strided(
                span, (k, n), (sa * isz, isz), writeable=False)
            dst = np.lib.stride_tricks.as_strided(
                flat[b0 + r0 * sb:], (k, n), (sb * isz, isz))
            dst[...] = src


def _write_from(fd: int, offset: int, block_shape, region_lo,
                buf: np.ndarray) -> None:
    """Write ``buf`` (a C-contiguous box) at ``region_lo`` of the block
    stored at ``offset`` (C order, ``block_shape``): one positioned write
    per contiguous run."""
    isz = buf.itemsize
    raw = memoryview(buf.reshape(-1).view(np.uint8))
    zero = (0,) * buf.ndim
    for a, b, n in _runs(buf.shape, zero, block_shape, region_lo, buf.shape):
        _pwrite_from(fd, raw[a * isz:(a + n) * isz], offset + b * isz)


def _item_bytes(item) -> int:
    from torch.distributed.checkpoint.planner import WriteItemType

    if item.type == WriteItemType.BYTE_IO:
        return 0
    n = item.tensor_data.properties.dtype.itemsize
    for s in item.tensor_data.chunk.sizes:
        n *= s
    return n


def _write_data_items(dirpath: Path, prefix: str, items, planner,
                      threads: int) -> list:
    """Write this rank's items: up to ``threads`` files
    (``<prefix><k>.distcp``), the items dealt largest first to the
    lightest, each file written (copied to the host, written, fsynced) on
    a thread of its own.  Returns DCP's write results."""
    from torch.distributed.checkpoint.planner import WriteItemType
    from torch.distributed.checkpoint.storage import WriteResult

    buckets: List[list] = [[] for _ in range(threads)]
    loads = [0] * threads
    for item in sorted(items, key=_item_bytes, reverse=True):
        k = loads.index(min(loads))
        buckets[k].append(item)
        loads[k] += max(1, _item_bytes(item))

    def write(k: int) -> list:
        name = f"{prefix}{k}{_SUFFIX}"
        results = []
        with open(dirpath / name, "wb") as f:
            for item in buckets[k]:
                data = planner.resolve_data(item)
                offset = f.tell()
                if item.type == WriteItemType.BYTE_IO:
                    f.write(data.getbuffer())
                else:
                    t = data.detach()
                    if t.device.type != "cpu":
                        t = t.to("cpu")
                    f.write(memoryview(_as_bits(t)))
                length = f.tell() - offset
                results.append(WriteResult(
                    index=item.index, size_in_bytes=length,
                    storage_data=_Location(name, offset, length)))
            f.flush()
            os.fsync(f.fileno())
        return results

    return [r for rs in _parallel(write, [k for k in range(threads)
                                          if buckets[k]]) for r in rs]


def _storage_classes():
    """The DCP storage writer and reader of this layer (built on first
    use: the module imports without ``torch.distributed.checkpoint``)."""
    global _Writer, _Reader
    if _Writer is not None:
        return _Writer, _Reader
    from torch.distributed.checkpoint.planner import LoadItemType
    from torch.distributed.checkpoint.storage import StorageReader, StorageWriter

    class Writer(StorageWriter):
        def __init__(self, path, threads: int = _IO_THREADS):
            super().__init__()
            self.path = Path(path)
            self.threads = threads

        def reset(self, checkpoint_id=None):
            if checkpoint_id is not None:
                self.path = Path(checkpoint_id)

        def set_up_storage_writer(self, is_coordinator, *args, **kwargs):
            self.is_coordinator = is_coordinator

        def prepare_local_plan(self, plan):
            self.path.mkdir(parents=True, exist_ok=True)
            return plan

        def prepare_global_plan(self, plans):
            return [dataclasses.replace(p, storage_data=f"__{i}_")
                    for i, p in enumerate(plans)]

        def write_data(self, plan, planner):
            fut = torch.futures.Future()
            fut.set_result(_write_data_items(self.path, plan.storage_data,
                                             plan.items, planner,
                                             self.threads))
            return fut

        def finish(self, metadata, results):
            metadata.storage_data = {wr.index: wr.storage_data
                                     for rs in results for wr in rs}
            tmp = self.path / (_METADATA + ".tmp")
            with open(tmp, "wb") as f:
                pickle.dump(metadata, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path / _METADATA)

        @classmethod
        def validate_checkpoint_id(cls, checkpoint_id):
            return True

    class Reader(StorageReader):
        def __init__(self, path):
            super().__init__()
            self.path = Path(path)

        def reset(self, checkpoint_id=None):
            if checkpoint_id is not None:
                self.path = Path(checkpoint_id)

        def read_metadata(self, *args, **kwargs):
            return _read_metadata(self.path)

        def set_up_storage_reader(self, metadata, is_coordinator, *args,
                                  **kwargs):
            self.metadata = metadata
            self.chunks = _chunk_table(metadata)

        def prepare_local_plan(self, plan):
            return plan

        def prepare_global_plan(self, plans):
            return plans

        def read_data(self, plan, planner):
            by_file: Dict[str, list] = {}
            for req in plan.items:
                loc = self.metadata.storage_data[req.storage_index]
                if req.type == LoadItemType.BYTE_IO:
                    planner.load_bytes(req, io.BytesIO(
                        _read_bytes(self.path, loc)))
                else:
                    by_file.setdefault(loc.relative_path, []).append(
                        (req, loc))

            def read(rel: str) -> None:
                # One file a thread: its items read and copied into place.
                with open(self.path / rel, "rb") as f:
                    for req, loc in by_file[rel]:
                        sizes, dtype = self.chunks[
                            (req.storage_index.fqn,
                             tuple(req.storage_index.offset))]
                        lengths = tuple(int(n) for n in req.lengths)
                        out = np.empty(lengths, _bits_dtype(dtype.itemsize))
                        _read_into(f.fileno(), loc.offset, sizes,
                                   tuple(int(o) for o in req.storage_offsets),
                                   out, (0,) * len(lengths), lengths)
                        piece = _from_bits(out, dtype)
                        target = planner.resolve_tensor(req).detach()
                        if target.size() != piece.size():
                            raise RuntimeError(
                                f"{req.storage_index.fqn}: stored piece "
                                f"{tuple(piece.size())} != target "
                                f"{tuple(target.size())}")
                        target.copy_(piece)
                        planner.commit_tensor(req, target)

            _parallel(read, sorted(by_file))
            fut = torch.futures.Future()
            fut.set_result(None)
            return fut

        @classmethod
        def validate_checkpoint_id(cls, checkpoint_id):
            return True

    _Writer, _Reader = Writer, Reader
    return Writer, Reader


_Writer = _Reader = None


def _read_metadata(path: "str | Path"):
    """The DCP ``Metadata`` of a checkpoint directory."""
    with open(Path(path) / _METADATA, "rb") as f:
        return pickle.load(f)


def _chunk_table(metadata) -> Dict[Tuple[str, tuple], Tuple[tuple, torch.dtype]]:
    """``(fqn, chunk offsets) -> (chunk sizes, dtype)`` of every stored
    tensor chunk."""
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    out = {}
    for fqn, md in metadata.state_dict_metadata.items():
        if isinstance(md, TensorStorageMetadata):
            for c in md.chunks:
                out[(fqn, tuple(c.offsets))] = (tuple(c.sizes),
                                                md.properties.dtype)
    return out


def _read_bytes(path: Path, loc: _Location) -> bytes:
    with open(path / loc.relative_path, "rb") as f:
        f.seek(loc.offset)
        data = f.read(loc.length)
    if len(data) != loc.length:
        raise CheckpointCorruptError(
            f"{path / loc.relative_path}: {len(data)} of {loc.length} bytes "
            f"at offset {loc.offset}")
    return data


def _leaf_chunks(metadata, fqn: str) -> List[Tuple[tuple, tuple, Any]]:
    """``(offsets, sizes, location)`` of each stored chunk of ``fqn``."""
    from torch.distributed.checkpoint.metadata import MetadataIndex

    md = metadata.state_dict_metadata[fqn]
    return [(tuple(c.offsets), tuple(c.sizes),
             metadata.storage_data[MetadataIndex(fqn, c.offsets)])
            for c in md.chunks]


def _read_box(path: Path, metadata, fqn: str, box) -> np.ndarray:
    """The region ``box`` (``((start, stop), ...)``) of stored tensor
    ``fqn`` as a new bits array, assembled from every stored chunk it
    intersects; only the intersections are read, by positioned reads of
    their contiguous runs."""
    md = metadata.state_dict_metadata[fqn]
    itemsize = md.properties.dtype.itemsize
    out = np.empty(tuple(hi - lo for lo, hi in box), _bits_dtype(itemsize))
    for offsets, sizes, loc in _leaf_chunks(metadata, fqn):
        inter = []
        for (lo, hi), o, s in zip(box, offsets, sizes):
            a, b = max(lo, o), min(hi, o + s)
            if a >= b:
                break
            inter.append((a, b))
        else:
            with open(path / loc.relative_path, "rb") as f:
                _read_into(f.fileno(), loc.offset, sizes,
                           tuple(a - o for (a, _b), o in zip(inter, offsets)),
                           out, tuple(a - lo for (a, _b), (lo, _hi) in
                                      zip(inter, box)),
                           tuple(b - a for a, b in inter))
    return out


# ---------------------------------------------------------------------------
# save / restore


def _prepare_dir(path: Path, force: bool) -> None:
    if _is_writer():
        if path.exists():
            if not force:
                raise FileExistsError(f"checkpoint {path} exists (force=False)")
            shutil.rmtree(path)
        path.mkdir(parents=True)
    _barrier()


def _dcp_save(flat: Dict[str, Any], path: Path, process_group=None,
              threads: int = _IO_THREADS) -> None:
    import torch.distributed.checkpoint as dcp

    writer, _ = _storage_classes()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # DCP's single-process notice
        dcp.save(flat, storage_writer=writer(path, threads),
                 process_group=process_group, no_dist=not _dist_on())


def _dcp_load(flat: Dict[str, Any], path: Path) -> None:
    """Load ``path`` into ``flat``'s tensors in place (its plain values
    replaced), each rank reading the chunks its shards overlap."""
    import torch.distributed.checkpoint as dcp

    _, reader = _storage_classes()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # DCP's single-process notice
        dcp.load(flat, storage_reader=reader(path), no_dist=not _dist_on())


def _commit(path: Path, tree: List[dict], topology: Optional[dict]) -> None:
    """Manifest and marker, written by rank 0 once every rank's payload
    is on disk; every rank returns after the marker exists."""
    if _is_writer():
        write_manifest(path, tree=tree, topology=topology)
    _barrier()


def save_checkpoint(
    path: "str | Path", state: Any, *, force: bool = True, manifest: bool = True
) -> None:
    """Save a state (a pytree of tensors, DTensors included, or a train
    state) with DCP, every rank of the default group its own shards, then
    write the integrity manifest + commit marker (``manifest=False``
    skips them)."""
    path = Path(path).absolute()
    with observe.span("ckpt.save", category="ckpt", path=str(path)):
        tree = checkpoint_tree(state)
        _prepare_dir(path, force)
        _dcp_save(_flat_dict(tree), path)
        if manifest:
            _commit(path, _leaf_tree(tree), state_topology(state))


def _stage(leaf: Any) -> Any:
    """A host copy of a tensor leaf (a DTensor keeps its mesh and
    placements, with a CPU local shard), taken now."""
    if not isinstance(leaf, torch.Tensor):
        return leaf
    t = leaf.detach()
    return t.to("cpu") if t.device.type != "cpu" else t.clone()


class AsyncCheckpointSaver:
    """Non-blocking sharded saves: :meth:`save` copies every tensor of the
    state to host memory before it returns (so the next optimizer step
    may run at once), and a background thread writes the copy with DCP
    while training continues.  Call :meth:`wait_until_finished` (or use
    as a context manager) before reading the files or exiting.

    The background write coordinates the ranks over a gloo group of its
    own, so its collectives never interleave with the training step's,
    and writes one file on one thread, leaving the host's cores to the
    step (a sync save writes up to 8 at once).
    A pending save COMMITS (gains its manifest + marker) at the next
    :meth:`wait_until_finished`; until then the directory has no
    ``TDX_COMMITTED`` and resume scans ignore it."""

    def __init__(self, *, manifest: bool = True) -> None:
        self._manifest = manifest
        self._group = None
        if _dist_on():
            import torch.distributed as dist

            self._group = dist.new_group(backend="gloo")
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # (path, leaf tree, topology) written but not yet committed.
        self._pending: List[Tuple[Path, List[dict], Optional[dict]]] = []

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, path: "str | Path", state: Any, *, force: bool = True) -> None:
        path = Path(path).absolute()
        self._join()  # one write at a time, as orbax's saver serializes
        tree = checkpoint_tree(state)
        leaf_tree, topology = _leaf_tree(tree), state_topology(state)
        staged = {k: _stage(v) for k, v in _flat_dict(tree).items()}
        _prepare_dir(path, force)

        def write():
            try:
                _dcp_save(staged, path, process_group=self._group, threads=1)
            except BaseException as e:  # noqa: BLE001 — re-raised at the join
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True,
                                        name="tdx-async-ckpt")
        self._thread.start()
        if self._manifest:
            self._pending.append((path, leaf_tree, topology))

    def wait_until_finished(self) -> None:
        try:
            self._join()
        finally:
            pending, self._pending = self._pending, []
        for path, tree, topology in pending:
            if path.is_dir():  # a force-overwrite may have replaced it
                _commit(path, tree, topology)

    def close(self) -> None:
        self._join()

    def __enter__(self) -> "AsyncCheckpointSaver":
        return self

    def __exit__(self, *exc) -> None:
        try:
            self.wait_until_finished()
        finally:
            self.close()


def _empty_like(leaf: Any) -> Any:
    if not isinstance(leaf, torch.Tensor):
        return leaf
    return torch.empty_like(leaf.detach())


def _read_whole(path: Path) -> Any:
    """Every stored entry as a host tensor (or its Python value), nested
    as the manifest's leaf tree says (a flat dict without one)."""
    from torch.distributed.checkpoint.metadata import BytesStorageMetadata

    metadata = _read_metadata(path)
    values: Dict[str, Any] = {}
    for fqn, md in metadata.state_dict_metadata.items():
        if isinstance(md, BytesStorageMetadata):
            from torch.distributed.checkpoint.metadata import MetadataIndex

            raw = _read_bytes(path, metadata.storage_data[MetadataIndex(fqn)])
            values[fqn] = torch.load(io.BytesIO(raw), weights_only=False)
        else:
            box = tuple((0, int(s)) for s in md.size)
            values[fqn] = _from_bits(_read_box(path, metadata, fqn, box),
                                     md.properties.dtype)
    manifest = read_manifest(path)
    if not manifest or "tree" not in manifest:
        return values
    pairs = []
    for entry in manifest["tree"]:
        kp = _parse_keystr(entry["path"])
        pairs.append((kp, values[leaf_storage_name(kp)]))
    return _unflatten(pairs)


def restore_checkpoint(
    path: "str | Path",
    *,
    target: Optional[Any] = None,
    verify: bool = False,
) -> Any:
    """Restore a checkpoint.

    With ``target`` (a pytree of tensors, DTensors included, or a train
    state) the values land in the target's layout, whatever layout the
    checkpoint was written in (DCP reads each target shard from the
    stored chunks it overlaps).  A pytree target comes back as a new tree
    of new tensors shaped and placed as the target's (the target's own
    storage is not written); a train state is restored in place — every
    parameter, every optimizer entry (the per-parameter step counters
    included) and ``state["step"]`` — and returned.  Without ``target``:
    every entry on the host, nested as the manifest's leaf tree.

    ``verify=True`` integrity-checks the manifest first and raises
    :class:`CheckpointCorruptError` instead of reading a damaged payload
    (``run_elastic`` verifies, and falls back to an older step)."""
    path = Path(path).absolute()
    if verify:
        ok, reason = verify_checkpoint(path)
        if not ok:
            raise CheckpointCorruptError(f"{path}: {reason}")
    with observe.span("ckpt.restore", category="ckpt", path=str(path)):
        if target is None:
            return _read_whole(path)
        if is_train_state(target):
            tree = checkpoint_tree(target)
            flat = _flat_dict(tree)
            with torch.no_grad():
                _dcp_load(flat, path)
            target["step"] = int(flat["step"])
            return target
        pairs = [(kp, _empty_like(leaf)) for kp, leaf in _flatten(target)]
        flat = {leaf_storage_name(kp): v for kp, v in pairs}
        _dcp_load(flat, path)
        return _rebuild(target, {kp: flat[leaf_storage_name(kp)]
                                 for kp, _ in pairs})


def _rebuild(tree: Any, values: Dict[Keypath, Any], prefix: Keypath = ()) -> Any:
    """``tree``'s structure (dict / list / tuple types kept) with each
    leaf replaced by ``values[keypath]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, prefix + (("key", k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, values, prefix + (("idx", i),))
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    if tree is None:
        return None
    return values[prefix]
