"""The port's native graph engine (``torchdistx_tpu_torch/_native.py`` over
``torchdistx_tpu_torch/csrc/tdx_graph.cc``): built by the host C++
compiler through ``ops._build`` into a cache under ``tmp_path``, its
call-stack walks equal the Python walks (and the JAX package's walk, as
op sequences), a poisoned graph walks in Python, a failed build raises
with the compiler's output, and the port's copy of ``csrc/test_graph.cc``
passes.  The cases of the JAX package's ``tests/test_native.py``."""

import gc
import importlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch
import torch.nn as nn

import torchdistx_tpu_torch.config as tdx_config
from torchdistx_tpu_torch import _native
from torchdistx_tpu_torch._graph import CONTEXT_KEY, get_fake_context
from torchdistx_tpu_torch.ops import _build

port_di = importlib.import_module("torchdistx_tpu_torch.deferred_init")

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cxx():
    if shutil.which(os.environ.get("CXX") or "c++") is None:
        pytest.skip("no C++ compiler to build the native graph engine")


@pytest.fixture(scope="module")
def native(cxx, tmp_path_factory):
    """The library built into a fresh cache and loaded; unloaded after
    the module, so other test files in this process record in Python."""
    cache = tmp_path_factory.mktemp("native-cache")
    before = dict(_build.counts)
    _build._libs.pop(_native.SOURCE, None)
    with tdx_config.override(cache_dir=str(cache), registry_dir=None):
        lib = _native.ensure()
        so = _build.library_path(_native.SOURCE)
    assert lib is not None and _native.available()
    yield {"cache": cache, "so": so, "builds": _build.counts["builds"]
           - before["builds"]}
    _build._libs.pop(_native.SOURCE, None)


def _record_view_chain(di=port_di):
    def make():
        w = torch.empty(4, 4)
        w.fill_(1.0)
        v = w[0]
        v.add_(5.0)
        u = w.view(16)
        u.mul_(2.0)
        return w, v, u

    return di.deferred_init(make)


def test_library_built_with_the_host_compiler(native):
    so = native["so"]
    assert native["builds"] == 1 and so.exists()
    assert so.parent == native["cache"]
    assert _build.verified(so)  # CRC sidecar beside it
    assert _build.outcomes[_native.SOURCE] == "miss"
    assert _build.group(_native.SOURCE) == 3
    # The compiler's version line is part of the key.
    assert _build.cxx_version() and _build.program_fp(_native.SOURCE)
    with tdx_config.override(cache_dir=str(native["cache"])):
        assert _build.build(_native.SOURCE) == so
    assert _build.outcomes[_native.SOURCE] == "hit"


def test_call_stack_matches_python_and_the_jax_walk(native):
    w, v, u = _record_view_chain()
    node = get_fake_context(w, CONTEXT_KEY).node
    assert node._ng is not None
    before = dict(_native.walks)
    native_stack = node.build_call_stack()
    assert _native.walks["native"] == before["native"] + 1
    ng = node._ng
    try:
        node._ng = None
        python_stack = node.build_call_stack()
    finally:
        node._ng = ng
    assert [n.op_nr for n in native_stack] == [n.op_nr for n in python_stack]
    assert node.last_in_place_node() is python_stack[-1]
    # As an op sequence, the JAX package's walk of the same recording.
    jax_di = importlib.import_module("torchdistx_tpu.deferred_init")
    from torchdistx_tpu._graph import CONTEXT_KEY as JAX_KEY
    from torchdistx_tpu.fake import get_fake_context as jax_context

    jw, _, _ = _record_view_chain(jax_di)
    jax_stack = jax_context(jw, JAX_KEY).node.build_call_stack()
    assert [n.op.name for n in native_stack] == \
        [n.op.name for n in jax_stack]


def test_materialize_values_and_nodes_released(native):
    w, v, u = _record_view_chain()
    rw = port_di.materialize_tensor(w)
    assert rw[0, 0].item() == 12.0  # (1 + 5) * 2
    assert rw[1, 1].item() == 2.0
    g = _native.NativeGraph.current()
    gc.collect()
    before = len(g.py_nodes)
    t = port_di.deferred_init(lambda: torch.ones(3) * 2)
    del t
    gc.collect()
    assert len(g.py_nodes) <= before + 1  # transient nodes were released


def test_python_walks_same_results(native):
    def build():
        return nn.Sequential(nn.Linear(8, 16), nn.Linear(16, 4))

    torch.manual_seed(0)
    m = port_di.deferred_init(build)
    assert get_fake_context(m[0].weight, CONTEXT_KEY).node._ng is not None
    port_di.materialize_module(m, device="cpu")
    native_vals = [p.detach().clone() for p in m.parameters()]
    with tdx_config.override(native=False):
        assert not _native.available()
        torch.manual_seed(0)
        m2 = port_di.deferred_init(build)
        assert get_fake_context(m2[0].weight, CONTEXT_KEY).node._ng is None
        before = _native.walks["python"]
        port_di.materialize_module(m2, device="cpu")
        assert _native.walks["python"] > before
    for a, b in zip(native_vals, m2.parameters()):
        assert torch.equal(a, b)
    # TDX_NATIVE=0 is the same switch.
    env = {**os.environ, "TDX_NATIVE": "0"}
    code = ("import torchdistx_tpu_torch.config as c; "
            "print(c.get().native)")
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, cwd=Path(__file__).parent.parent)
    assert out.stdout.strip() == "False", out.stderr[-500:]


def test_python_only_mutation_poisons_native_graph(native):
    w = port_di.deferred_init(lambda: torch.zeros(4))
    zeros_node = get_fake_context(w, CONTEXT_KEY).node
    assert zeros_node._ng is not None and not zeros_node._ng.poisoned
    with tdx_config.override(native=False):
        port_di.enable_deferred_init(True)
        try:
            w.fill_(7.0)  # a Python-only node mutating the native graph
        finally:
            port_di.enable_deferred_init(False)
    assert zeros_node._ng.poisoned
    assert torch.equal(port_di.materialize_tensor(w), torch.full((4,), 7.0))
    _native.NativeGraph._tls.graph = None  # later tests start a whole graph


def test_cross_thread_dependency_poisons_both_graphs(native):
    box = {}

    def record():
        box["w"] = port_di.deferred_init(lambda: torch.ones(4))

    t = threading.Thread(target=record)
    t.start()
    t.join()
    w = box["w"]
    other = get_fake_context(w, CONTEXT_KEY).node._ng
    mine = _native.NativeGraph.current()
    assert other is not mine
    port_di.enable_deferred_init(True)
    try:
        w.mul_(3.0)  # recorded on this thread, depends on the other's node
    finally:
        port_di.enable_deferred_init(False)
    assert other.poisoned and mine.poisoned
    assert torch.equal(port_di.materialize_tensor(w), torch.full((4,), 3.0))
    _native.NativeGraph._tls.graph = None


def test_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    stub = tmp_path / "bad-cxx"
    stub.write_text("#!/bin/sh\n"
                    "if [ \"$1\" = --version ]; then echo 'bad-cxx 0.0'; "
                    "exit 0; fi\n"
                    "echo 'bad-cxx: refused to compile' >&2\nexit 3\n")
    stub.chmod(0o755)
    monkeypatch.setenv("CXX", str(stub))
    saved = _build._libs.pop(_native.SOURCE, None)
    try:
        with tdx_config.override(cache_dir=str(tmp_path / "c"),
                                 registry_dir=None):
            with pytest.raises(RuntimeError, match="refused to compile"):
                _native.ensure()
        assert _native.lib() is None and not _native.available()
    finally:
        if saved is not None:
            _build._libs[_native.SOURCE] = saved


def test_native_unit_tests_pass(cxx, tmp_path):
    exe = tmp_path / "test_graph"
    csrc = _build.HOST_CSRC
    cxx = _build.cxx_path()
    flags = [f for f in _build.NATIVE_CXXFLAGS if f != "-shared"]
    subprocess.run([cxx, *flags, "-pthread", "-o", str(exe),
                    str(csrc / "tdx_graph.cc"), str(csrc / "test_graph.cc")],
                   check=True, capture_output=True, text=True, timeout=300)
    proc = subprocess.run([str(exe)], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
