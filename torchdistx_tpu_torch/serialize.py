"""Serializable recordings: save and load the deferred-init replay graph
(the port's own copy of ``torchdistx_tpu/serialize.py``, in the same file
format, so either package reads the other's files).

A capability the reference torchdistx lacks: its op graph is in-memory
only, with type-erased C++ closures that cannot be serialized
(deferred_init.cc:165).  Here a recorded :class:`~._graph.Op` is an ATen
``OpOverload`` plus an immutable preserved stack, both of which
round-trip through a structured file, so the workflow can split across
machines: ``deferred_init`` a model on a login host with no GPU (its
fakes claim ``cuda`` with no CUDA runtime there), ship the recording
(graph metadata only: kilobytes for an 8B model, no weights, since no
weights exist yet), and materialize it on the card::

    # login host
    model = deferred_init(make_llama, LLAMA3_8B, device="cuda")
    save_recording(model, "llama.tdx")

    # the GPU host
    fakes = load_recording("llama.tdx")
    params = materialize_params_cuda(fakes, seed=0)   # on the card

Loaded fakes behave like freshly recorded ones: ``materialize_tensor``
replays them, and the keyed materializer's per-op generators, keyed by
the saved ``key_nr``s, give exactly the values the source recording
gives under the same seed.  ``materialize_params_cuda`` places them on
the GPU unless the caller asks for the CPU.

Format: a dict of pure-Python/torch-serializable records via
``torch.save``: ops as (namespace, name, overload) triples resolved
through ``torch.ops`` on load, leaves tagged per type, external real
tensor arguments embedded by value, and the manifest of entry names.
"""

from __future__ import annotations

from typing import Any, Dict, List, Union

import torch

from . import _graph
from ._graph import CONTEXT_KEY, DeferredInitContext, Op, OpNode, _Dep
from .fake import FakeTensor, get_fake_context, is_fake, is_param_like, set_fake_context

__all__ = ["save_recording", "load_recording"]

# v2 added the full per-op thread-local-state capture ("tls"); v1 files
# (grad mode only) still load, with default-TLS for the other fields.
_FORMAT_VERSION = 2


# ---------------------------------------------------------------------------
# leaf encoding
# ---------------------------------------------------------------------------


def _encode_leaf(obj, tensors: List[torch.Tensor]):
    if isinstance(obj, _Dep):
        return {"__tdx__": "dep", "i": obj.index}
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return {"__tdx__": "tensor", "i": len(tensors) - 1}
    if isinstance(obj, torch.device):
        return {"__tdx__": "device", "v": str(obj)}
    if isinstance(obj, torch.dtype):
        return {"__tdx__": "dtype", "v": str(obj).removeprefix("torch.")}
    if isinstance(obj, torch.layout):
        return {"__tdx__": "layout", "v": str(obj).removeprefix("torch.")}
    if isinstance(obj, torch.memory_format):
        return {"__tdx__": "memory_format", "v": str(obj).removeprefix("torch.")}
    if isinstance(obj, torch.Size):
        return {"__tdx__": "size", "v": list(obj)}
    if isinstance(obj, torch.Generator):
        raise RuntimeError(
            "A recording that captured an explicit torch.Generator argument "
            "cannot be serialized: generator state is process-local. "
            "Initialize with the global RNG (the default) to save recordings."
        )
    if isinstance(obj, (type(None), bool, int, float, complex, str)):
        return obj
    raise RuntimeError(
        f"Cannot serialize recorded argument of type `{type(obj).__name__}`."
    )


def _encode(obj, tensors: List[torch.Tensor]):
    if isinstance(obj, torch.Size):  # tuple subclass: must precede containers
        return _encode_leaf(obj, tensors)
    if isinstance(obj, (list, tuple)):
        enc = [_encode(x, tensors) for x in obj]
        return {"__tdx__": "tuple", "v": enc} if isinstance(obj, tuple) else enc
    if isinstance(obj, dict):
        return {"__tdx__": "dict", "v": {k: _encode(v, tensors) for k, v in obj.items()}}
    return _encode_leaf(obj, tensors)


def _decode(obj, tensors: List[torch.Tensor]):
    if isinstance(obj, list):
        return [_decode(x, tensors) for x in obj]
    if isinstance(obj, dict):
        tag = obj.get("__tdx__")
        if tag is None:
            return obj
        v = obj.get("v")
        if tag == "tuple":
            return tuple(_decode(x, tensors) for x in v)
        if tag == "dict":
            return {k: _decode(x, tensors) for k, x in v.items()}
        if tag == "dep":
            return _Dep(obj["i"])
        if tag == "tensor":
            return tensors[obj["i"]]
        if tag == "device":
            return torch.device(v)
        if tag == "dtype":
            return getattr(torch, v)
        if tag == "layout":
            return getattr(torch, v)
        if tag == "memory_format":
            return getattr(torch, v)
        if tag == "size":
            return torch.Size(v)
        raise RuntimeError(f"Unknown recording tag `{tag}`.")
    return obj


def _encode_tls(tls: _graph.ThreadLocalState, tensors) -> dict:
    return {
        "grad_enabled": tls.grad_enabled,
        "autocast": _encode(tls.autocast, tensors),
        "autocast_cache_enabled": tls.autocast_cache_enabled,
        "default_dtype": _encode_leaf(tls.default_dtype, tensors),
    }


def _decode_tls(rec: dict, tensors) -> _graph.ThreadLocalState:
    # On torch < 2.4 restore() cannot drive device-typed autocast at all
    # (capture() degrades the same way), so decode no autocast entries —
    # including from v2 files written by a newer torch.
    has_autocast = _graph.ThreadLocalState._HAS_DEVICE_AUTOCAST
    if "tls" not in rec:  # v1 file: grad mode only, neutral for the rest
        neutral = {"cpu": torch.bfloat16, "cuda": torch.float16}
        return _graph.ThreadLocalState(
            grad_enabled=rec["grad_enabled"],
            autocast=tuple(
                (d, False, dt) for d, dt in neutral.items()
            ) if has_autocast else (),
            autocast_cache_enabled=True,
            default_dtype=torch.float32,
        )
    t = rec["tls"]
    return _graph.ThreadLocalState(
        grad_enabled=t["grad_enabled"],
        autocast=_decode(t["autocast"], tensors) if has_autocast else (),
        autocast_cache_enabled=t["autocast_cache_enabled"],
        default_dtype=_decode(t["default_dtype"], tensors),
    )


def _encode_func(func) -> Dict[str, str]:
    for syn_name, syn_fn in _graph.SYNTHETIC_OPS.items():
        if func is syn_fn:
            return {"synthetic": syn_name}
    schema_name = getattr(getattr(func, "_schema", None), "name", None)
    overload = getattr(func, "_overloadname", None)
    if schema_name is None or overload is None:
        raise RuntimeError(
            f"Recorded op `{func}` is not an ATen OpOverload and cannot be "
            f"serialized."
        )
    ns, name = schema_name.split("::", 1)
    return {"ns": ns, "name": name, "overload": overload or "default"}


def _decode_func(ref: Dict[str, str]):
    if "synthetic" in ref:
        try:
            return _graph.SYNTHETIC_OPS[ref["synthetic"]]
        except KeyError:
            raise RuntimeError(
                f"Recording uses unknown synthetic op `{ref['synthetic']}`."
            ) from None
    packet = getattr(torch.ops, ref["ns"])
    op = getattr(packet, ref["name"])
    return getattr(op, ref["overload"])


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------


def _collect_fakes(obj) -> Dict[str, torch.Tensor]:
    if isinstance(obj, torch.nn.Module):
        from .cuda_bridge.materialize import named_fake_tensors

        return named_fake_tensors(obj)
    if isinstance(obj, dict):
        bad = [k for k, v in obj.items() if not is_fake(v)]
        if bad:
            raise ValueError(f"Entries are not fake tensors: {bad}")
        return dict(obj)
    raise TypeError("save_recording expects an nn.Module or a dict of fakes.")


def save_recording(obj: Union[torch.nn.Module, Dict[str, torch.Tensor]], path) -> None:
    """Save the replay graph of a deferred-init module (or named fakes).

    Saves graph metadata and embedded external tensor arguments only — no
    parameter data exists before materialization, so the file stays small
    regardless of model size.
    """
    fakes = _collect_fakes(obj)

    # Union call stack over all requested fakes, in chronological order
    # (the same closure materialize_many would replay).
    nodes: List[OpNode] = []
    index: Dict[int, int] = {}
    for f in fakes.values():
        ctx = get_fake_context(f, CONTEXT_KEY)
        if ctx is None:
            raise ValueError(
                "A tensor has no recording (already materialized, or made "
                "outside deferred_init) and cannot be saved."
            )
        for n in ctx.node.build_call_stack():
            if id(n) not in index:
                index[id(n)] = len(nodes)
                nodes.append(n)
    nodes.sort(key=lambda n: n.op_nr)
    index = {id(n): i for i, n in enumerate(nodes)}

    # Storage alias keys remapped to dense ints.
    storage_ids: Dict[int, int] = {}

    def sid(key: int) -> int:
        return storage_ids.setdefault(key, len(storage_ids))

    tensors: List[torch.Tensor] = []
    recs = []
    for n in nodes:
        if n.materialized:
            raise ValueError(
                f"Op `{n.op.name}` was already (partially) materialized; "
                f"only unmaterialized recordings can be saved."
            )
        # Same external-argument guarantees replay enforces
        # (_verify_external_args): saving must not launder a recording that
        # could no longer replay (mutated or inference external tensors).
        _graph._verify_external_args(n)
        for dep, _ in n.dependencies:
            if id(dep) not in index:
                if dep.materialized:
                    # Same condition as the in-set check above, detected
                    # on the dependency side: a value read materialized
                    # part of the chain early.
                    raise ValueError(
                        f"Op `{n.op.name}` depends on an already "
                        f"(partially) materialized op (`{dep.op.name}`); "
                        f"only unmaterialized recordings can be saved."
                    )
                raise RuntimeError(
                    f"Recording is not self-contained: `{n.op.name}` depends "
                    f"on an op outside the saved set."
                )
        recs.append(
            {
                "func": _encode_func(n.op.func),
                "name": n.op.name,
                "args": _encode(n.op.args, tensors),
                "kwargs": _encode(n.op.kwargs, tensors),
                "tls": _encode_tls(n.op.tls, tensors),
                "key_nr": n.key_nr,
                "deps": [(index[id(dep)], out) for dep, out in n.dependencies],
                "storages": sorted(sid(k) for k in n.storages),
                # Physical output geometry (the JAX package's bridge:
                # storage-relative ops over non-C-contiguous roots).
                # Optional: absent in older files, which fall back to
                # assuming contiguity.
                "geom": {
                    i: [list(g[0]), list(g[1]), g[2], g[3]]
                    for i, g in n.out_geom.items()
                },
            }
        )

    manifest = {}
    for name, f in fakes.items():
        ctx = get_fake_context(f, CONTEXT_KEY)
        manifest[name] = {
            "node": index[id(ctx.node)],
            "output": ctx.output_index,
            "shape": list(f.shape),
            "stride": list(f.stride()),
            "offset": f.storage_offset(),
            "dtype": _encode_leaf(f.dtype, tensors),
            "device": str(f._fake_device),
            "requires_grad": bool(f.requires_grad),
            "is_param": is_param_like(f),
        }

    torch.save(
        {
            "format": "torchdistx_tpu.recording",
            "version": _FORMAT_VERSION,
            "nodes": recs,
            "tensors": tensors,
            "manifest": manifest,
        },
        path,
    )


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------


def load_recording(path) -> Dict[str, FakeTensor]:
    """Load a saved recording as named fake tensors, ready to materialize
    via :func:`~.deferred_init.materialize_tensor` or the keyed
    ``materialize_params_cuda`` (on the GPU unless the caller asks for
    the CPU, sharded with a mesh and plan)."""
    # The payload is pure containers + plain tensors by construction;
    # weights_only keeps hostile .tdx files from executing pickle payloads.
    payload = torch.load(path, weights_only=True)
    if payload.get("format") != "torchdistx_tpu.recording":
        raise ValueError(f"`{path}` is not a torchdistx_tpu recording.")
    if payload["version"] > _FORMAT_VERSION:
        raise ValueError(
            f"Recording version {payload['version']} is newer than this "
            f"library supports ({_FORMAT_VERSION})."
        )
    tensors: List[torch.Tensor] = payload["tensors"]

    nodes: List[OpNode] = []
    for rec in payload["nodes"]:
        op = Op(
            func=_decode_func(rec["func"]),
            args=_decode(rec["args"], tensors),
            kwargs=_decode(rec["kwargs"], tensors),
            tls=_decode_tls(rec, tensors),
            name=rec["name"],
        )
        node = OpNode(op, key_nr=rec["key_nr"])
        node.loaded = True  # read-only graph: record_op refuses extensions
        node.storages = set(rec["storages"])
        node.out_geom = {
            int(i): (tuple(g[0]), tuple(g[1]), g[2], g[3])
            for i, g in rec.get("geom", {}).items()
        }
        node.dependencies = [(nodes[i], out) for i, out in rec["deps"]]
        for dep, _ in node.dependencies:
            dep.dependents.add(node)
        # Embedded tensor copies are private to the loaded graph; their
        # current versions are by construction the recorded ones.
        for t in _graph._iter_tensors((op.args, op.kwargs)):
            node.argument_versions.append((t, t._version))
        node._native_sync_edges()
        nodes.append(node)

    out: Dict[str, FakeTensor] = {}
    for name, m in payload["manifest"].items():
        meta = torch.empty(0, dtype=_decode(m["dtype"], tensors), device="meta")
        meta = meta.as_strided(m["shape"], m["stride"], m["offset"])
        fake = FakeTensor(meta, torch.device(m["device"]), m["requires_grad"])
        if m["is_param"]:
            fake._is_param = True
        set_fake_context(
            fake, CONTEXT_KEY, DeferredInitContext(nodes[m["node"]], m["output"])
        )
        # Keep every node of the loaded graph alive as long as any loaded
        # fake is: in-place/view nodes reachable only through weak
        # dependent edges must survive for the call-stack walks.
        fake._tdx_loaded_graph = nodes
        out[name] = fake
    return out
