"""The port's recordings against the JAX package's: one ``nn.Module``
constructor recorded, saved and loaded by each package gives the same
decoded ops (namespace, name, overload) and ``key_nr``s in the same
order, the same values under one ``torch.manual_seed``, and each package
loads the other's file.  (The HF model case of ``tests/test_serialize.py``
is in ``test_torch_hf.py``, which imports ``transformers`` already.)"""

import importlib

import torch
import torch.nn as nn

from torchdistx_tpu_torch.cuda_bridge.materialize import materialize_params_cuda

# The modules (each package re-exports deferred_init's function under its
# name).
jax_di = importlib.import_module("torchdistx_tpu.deferred_init")
jax_ser = importlib.import_module("torchdistx_tpu.serialize")
port_di = importlib.import_module("torchdistx_tpu_torch.deferred_init")
port_ser = importlib.import_module("torchdistx_tpu_torch.serialize")

torch.set_num_threads(2)


def build():
    return nn.Sequential(
        nn.Embedding(16, 8, padding_idx=0),
        nn.Linear(8, 12),
        nn.LayerNorm(12),
        nn.Linear(12, 4, bias=False),
    )


def _ops(path):
    payload = torch.load(path, weights_only=True)
    return [(tuple(sorted(rec["func"].items())), rec["key_nr"])
            for rec in payload["nodes"]], payload["manifest"]


def _values(di, loaded, seed=0):
    torch.manual_seed(seed)
    return {n: di.materialize_tensor(f).detach() for n, f in loaded.items()}


def test_same_ops_key_nrs_and_values(tmp_path):
    jp, pp = tmp_path / "jax.tdx", tmp_path / "port.tdx"
    jax_ser.save_recording(jax_di.deferred_init(build), jp)
    port_ser.save_recording(port_di.deferred_init(build), pp)
    j_ops, j_manifest = _ops(jp)
    p_ops, p_manifest = _ops(pp)
    assert p_ops == j_ops and len(p_ops) > 8
    assert [k for _, k in p_ops] == sorted(k for _, k in p_ops)
    assert list(p_manifest) == list(j_manifest)
    assert {n: m["shape"] for n, m in p_manifest.items()} == \
        {n: m["shape"] for n, m in j_manifest.items()}
    j_vals = _values(jax_di, jax_ser.load_recording(jp))
    p_vals = _values(port_di, port_ser.load_recording(pp))
    assert list(p_vals) == list(j_vals)
    for n in j_vals:
        assert torch.equal(p_vals[n], j_vals[n]), n


def test_each_package_loads_the_others_file(tmp_path):
    jp, pp = tmp_path / "jax.tdx", tmp_path / "port.tdx"
    jax_ser.save_recording(jax_di.deferred_init(build), jp)
    port_ser.save_recording(port_di.deferred_init(build), pp)
    want = _values(port_di, port_ser.load_recording(pp), seed=3)
    from_jax_file = _values(port_di, port_ser.load_recording(jp), seed=3)
    from_port_file = _values(jax_di, jax_ser.load_recording(pp), seed=3)
    for n in want:
        assert torch.equal(from_jax_file[n], want[n]), n
        assert torch.equal(from_port_file[n], want[n]), n
    # The keyed materializer reads a JAX-saved recording's key_nrs too.
    a = materialize_params_cuda(port_ser.load_recording(jp), seed=9,
                                device="cpu")
    b = materialize_params_cuda(port_ser.load_recording(pp), seed=9,
                                device="cpu")
    assert all(torch.equal(a[n], b[n]) for n in b)
