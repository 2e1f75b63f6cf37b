"""ctypes bindings for the native graph engine (``csrc/tdx_graph.cc``), the
port's own copy of ``torchdistx_tpu/_native.py``.

The library is compiled by the host C++ compiler (no CUDA) through
:mod:`.ops._build`, with the same cache → registry → compile lookup and
CRC sidecar as the kernel libraries.  Nothing is built or loaded at
import: :func:`ensure` builds or fetches and loads it (a warm bring-up
does so too, through ``registry.scheduler.path_sources``).  The graph
walks in :mod:`._graph` run natively whenever the library is loaded,
as in the JAX package; ``TDX_NATIVE=0`` (``config.native``) forces the
Python walks, which stay the reference.  A failed build raises with the
compiler's output; :func:`available` reports a library that is not
loaded.

:data:`walks` counts this process's call-stack walks by engine
(``native``, ``python``): the Python count includes the walks of graphs
that a cross-thread dependency poisoned.
"""

from __future__ import annotations

import ctypes
import sys
import threading
from typing import Dict, List, Optional

SOURCE = "tdx_graph.cc"

#: Call-stack walks since the last :func:`reset_walks`, by engine.
walks: Dict[str, int] = {"native": 0, "python": 0}

_configured: Dict[int, ctypes.CDLL] = {}


def reset_walks() -> None:
    for k in walks:
        walks[k] = 0


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.tdx_graph_create.restype = ctypes.c_void_p
    lib.tdx_graph_destroy.argtypes = [ctypes.c_void_p]
    lib.tdx_node_create.argtypes = [ctypes.c_void_p]
    lib.tdx_node_create.restype = ctypes.c_uint64
    lib.tdx_node_destroy.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.tdx_node_add_storage.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
    ]
    lib.tdx_node_add_dep.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int32,
    ]
    lib.tdx_node_set_materialized.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32,
    ]
    lib.tdx_last_in_place.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.tdx_last_in_place.restype = ctypes.c_uint64
    lib.tdx_build_call_stack.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
    ]
    lib.tdx_build_call_stack.restype = ctypes.c_uint64
    return lib


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library with its signatures set, or None when it has
    not been loaded in this process.  Called for every recorded op, so
    it imports nothing: a library is loaded only through ``ops._build``,
    which is then imported already."""
    build = sys.modules.get(__package__ + ".ops._build")
    raw = build._libs.get(SOURCE) if build is not None else None
    if raw is None:
        return None
    out = _configured.get(id(raw))
    if out is None:
        out = _configured[id(raw)] = _configure(raw)
    return out


def ensure() -> ctypes.CDLL:
    """Load the library, building or fetching it first where the local
    cache lacks it; raises with the compiler's output if the build
    fails."""
    from .ops import _build

    _build.load(SOURCE)
    return lib()


def available() -> bool:
    """Whether new recordings use the native engine: the library is
    loaded and ``config.native`` is on."""
    if lib() is None:
        return False
    from . import config

    return config.get().native


class NativeGraph:
    """One native graph per thread (op_nr ordering is thread-local, like
    the reference's TLS counter, deferred_init.cc:668)."""

    _tls = threading.local()

    def __init__(self):
        self.lib = lib()
        self.handle = ctypes.c_void_p(self.lib.tdx_graph_create())
        # nid -> weakref(OpNode); entries removed by OpNode.__del__.
        self.py_nodes = {}
        # Set when a cross-thread dependency makes this graph's topology
        # incomplete; walks then run in Python.
        self.poisoned = False

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.tdx_graph_destroy(self.handle)

    @classmethod
    def current(cls) -> "NativeGraph":
        g = getattr(cls._tls, "graph", None)
        if g is None:
            g = cls()
            cls._tls.graph = g
        return g

    # -- node ops ---------------------------------------------------------

    def node_create(self) -> int:
        return self.lib.tdx_node_create(self.handle)

    def node_destroy(self, nid: int) -> None:
        self.lib.tdx_node_destroy(self.handle, nid)

    def add_storage(self, nid: int, key: int) -> None:
        self.lib.tdx_node_add_storage(self.handle, nid,
                                      key & 0xFFFFFFFFFFFFFFFF)

    def add_dep(self, nid: int, dep: int, out_idx: int) -> None:
        self.lib.tdx_node_add_dep(self.handle, nid, dep, out_idx)

    def set_materialized(self, nid: int, value: bool) -> None:
        self.lib.tdx_node_set_materialized(self.handle, nid, 1 if value else 0)

    # -- walks ------------------------------------------------------------

    def last_in_place(self, nid: int) -> int:
        return self.lib.tdx_last_in_place(self.handle, nid)

    def build_call_stack(self, nid: int) -> List[int]:
        cap = 256
        while True:
            buf = (ctypes.c_uint64 * cap)()
            n = self.lib.tdx_build_call_stack(self.handle, nid, buf, cap)
            if n <= cap:
                walks["native"] += 1
                return [buf[i] for i in range(n)]
            cap = n

    def nodes_of(self, ids: List[int]) -> Optional[list]:
        """The live OpNodes of ``ids``, or None if one has died."""
        out = []
        for nid in ids:
            ref = self.py_nodes.get(nid)
            n = ref() if ref is not None else None
            if n is None:
                return None
            out.append(n)
        return out
