"""The port's serializable recordings (``torchdistx_tpu_torch.serialize``):
the cases of the JAX package's ``tests/test_serialize.py`` that apply to
the port, with the keyed materializer on ``device="cpu"`` in place of the
JAX bridge (bitwise, and gathered from the shards of a virtual mesh), and
the login-host case: a model recorded with ``device="cuda"`` on a host
with no CUDA (ROADMAP C15).  The HF model case and the comparison with
the JAX package's own files are in ``test_torch_serialize_jax.py``."""

import copy
import itertools

import pytest
import torch
import torch.nn as nn

from torchdistx_tpu_torch.cuda_bridge.materialize import (
    materialize_params_cuda,
    named_fake_tensors,
)
from torchdistx_tpu_torch.deferred_init import (
    deferred_init,
    materialize_module,
    materialize_tensor,
)
from torchdistx_tpu_torch.fake import fake_mode, is_fake
from torchdistx_tpu_torch.serialize import load_recording, save_recording

torch.set_num_threads(2)


def _roundtrip(fakes, tmp_path):
    p = tmp_path / "rec.tdx"
    save_recording(fakes, p)
    return load_recording(p)


def _keyed(fakes, **kw):
    return materialize_params_cuda(fakes, device="cpu", **kw)


class TestTorchReplay:
    def test_factory_chain(self, tmp_path):
        t = deferred_init(lambda: (torch.ones(4, 3) * 2).add_(1))
        loaded = _roundtrip({"t": t}, tmp_path)["t"]
        assert is_fake(loaded) and loaded.shape == (4, 3)
        real = materialize_tensor(loaded)
        assert torch.equal(real, torch.full((4, 3), 3.0))
        # The original recording is untouched by save/load.
        assert torch.equal(materialize_tensor(t), real)

    def test_rng_replay_matches(self, tmp_path):
        # Replay draws from the replay-time global RNG: the same seed at
        # both replay sites gives the same values.
        t = deferred_init(lambda: torch.empty(32).uniform_())
        loaded = _roundtrip({"t": t}, tmp_path)["t"]
        torch.manual_seed(7)
        a = materialize_tensor(loaded)
        torch.manual_seed(7)
        b = materialize_tensor(t)
        assert torch.equal(a, b)

    def test_in_place_through_view(self, tmp_path):
        def make():
            w = torch.ones(4, 3)
            w[2].add_(5)  # view + in-place: the hard graph semantics
            return w

        loaded = _roundtrip({"t": deferred_init(make)}, tmp_path)["t"]
        expect = torch.ones(4, 3)
        expect[2] += 5
        assert torch.equal(materialize_tensor(loaded), expect)

    def test_external_tensor_argument(self, tmp_path):
        ext = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        t = deferred_init(lambda: torch.zeros(2, 3).add_(ext))
        loaded = _roundtrip({"t": t}, tmp_path)["t"]
        assert torch.equal(materialize_tensor(loaded), ext)

    def test_mutating_external_after_save_is_safe(self, tmp_path):
        ext = torch.ones(3)
        t = deferred_init(lambda: torch.zeros(3).add_(ext))
        p = tmp_path / "rec.tdx"
        save_recording({"t": t}, p)
        ext.mul_(99)
        loaded = load_recording(p)["t"]
        assert torch.equal(materialize_tensor(loaded),
                           torch.ones(3))

    def test_parameter_class_preserved(self, tmp_path):
        loaded = _roundtrip(deferred_init(nn.Linear, 4, 2), tmp_path)
        w = materialize_tensor(loaded["weight"])
        assert isinstance(w, nn.Parameter) and w.requires_grad


class TestModuleRoundTrip:
    def test_module_manifest_names(self, tmp_path):
        loaded = _roundtrip(deferred_init(nn.Linear, 4, 2), tmp_path)
        assert set(loaded) == {"weight", "bias"}
        assert loaded["weight"].shape == (2, 4)

    def test_torch_replay_matches_eager(self, tmp_path):
        def build():
            return nn.Sequential(nn.Embedding(16, 8, padding_idx=0),
                                 nn.Linear(8, 4))

        loaded = _roundtrip(deferred_init(build), tmp_path)
        torch.manual_seed(0)
        eager_sd = build().state_dict()
        # Replay in manifest (construction) order under the same seed:
        # the RNG stream matches eager construction draw for draw.
        torch.manual_seed(0)
        for name, fake in loaded.items():
            assert torch.equal(materialize_tensor(fake),
                               eager_sd[name]), name

    def test_keyed_materialize_matches_original(self, tmp_path):
        """The JAX case's ``materialize_params_jax`` is the keyed
        materializer here: a loaded recording gives the original's values
        bitwise, whole and gathered from a sharded virtual mesh."""
        from torchdistx_tpu_torch.models.configs import TINY
        from torchdistx_tpu_torch.models.llama import make_llama
        from torchdistx_tpu_torch.models.plans import decoder_lm_plan
        from torchdistx_tpu_torch.parallel.mesh import VirtualMesh
        from torchdistx_tpu_torch.parallel.sharding import (
            local_shard,
            mesh_shape,
        )

        m = deferred_init(make_llama, TINY, device="cpu")
        p = tmp_path / "rec.tdx"
        save_recording(m, p)
        orig = _keyed(named_fake_tensors(m), seed=5)
        loaded = load_recording(p)
        assert list(loaded) == list(orig)
        again = _keyed(loaded, seed=5)
        for k in orig:
            assert torch.equal(orig[k], again[k]), k
        # The shards of a {fsdp 2, tp 2} virtual mesh are the original's.
        axes = {"fsdp": 2, "tp": 2}
        plan = decoder_lm_plan(TINY)
        shape = mesh_shape(VirtualMesh(axes, {a: 0 for a in axes}))
        sharded = 0
        for coord in itertools.product(range(2), range(2)):
            mesh = VirtualMesh(axes, dict(zip(shape, coord)))
            local = _keyed(loaded, seed=5, mesh=mesh, plan=plan)
            for name, value in local.items():
                spec = plan.spec_for(name, tuple(orig[name].shape), shape)
                want = local_shard(orig[name], spec, shape, coord)
                assert torch.equal(value, want), (coord, name)
                sharded += value.numel() < orig[name].numel()
        assert sharded


class TestErrors:
    def test_materialized_recording_rejected(self, tmp_path):
        t = deferred_init(lambda: torch.ones(3).mul_(2))
        materialize_tensor(t, retain_context=True)
        with pytest.raises(ValueError, match="materialized"):
            save_recording({"t": t}, tmp_path / "x.tdx")

    def test_non_fake_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="not fake"):
            save_recording({"t": torch.ones(3)}, tmp_path / "x.tdx")

    def test_unrecorded_fake_rejected(self, tmp_path):
        with fake_mode():
            t = torch.ones(3)
        with pytest.raises(ValueError, match="no recording"):
            save_recording({"t": t}, tmp_path / "x.tdx")

    def test_loaded_recordings_are_read_only(self, tmp_path):
        t = deferred_init(lambda: torch.ones(4, 3))
        loaded = _roundtrip({"t": t}, tmp_path)["t"]
        with pytest.raises(RuntimeError, match="loaded recording"):
            deferred_init(lambda: loaded[2].add_(5))

    def test_mutated_external_rejected_at_save(self, tmp_path):
        ext = torch.ones(3)
        t = deferred_init(lambda: torch.zeros(3).add_(ext))
        ext.mul_(99)
        with pytest.raises(RuntimeError, match="modified in place"):
            save_recording({"t": t}, tmp_path / "x.tdx")

    def test_size_argument_roundtrips_as_size(self):
        from torchdistx_tpu_torch.serialize import _decode, _encode

        tensors = []
        enc = _encode(torch.Size([2, 3]), tensors)
        assert enc == {"__tdx__": "size", "v": [2, 3]}
        assert isinstance(_decode(enc, tensors), torch.Size)

    def test_bad_file_rejected(self, tmp_path):
        p = tmp_path / "junk.pt"
        torch.save({"something": 1}, p)
        with pytest.raises(ValueError, match="not a torchdistx_tpu recording"):
            load_recording(p)


class TestSessionIsolation:
    def test_load_during_active_session_keeps_key_nrs(self, tmp_path):
        """Loading a recording while a session records must not consume
        the session's key_nr counter (every later op's RNG key, and so
        its values, would shift)."""
        p = tmp_path / "rec.tdx"
        save_recording({"x": deferred_init(lambda: torch.empty(4).normal_())},
                       p)

        def make(load):
            a = torch.empty(8)
            a.normal_()
            if load:
                load_recording(p)  # mid-session
            b = torch.empty(8)
            b.normal_()
            return a, b

        ref_a, ref_b = deferred_init(make, False)
        got_a, got_b = deferred_init(make, True)
        ref = _keyed({"a": ref_a, "b": ref_b}, seed=3)
        got = _keyed({"a": got_a, "b": got_b}, seed=3)
        assert torch.equal(ref["a"], got["a"])
        assert torch.equal(ref["b"], got["b"])


class TestTlsRoundTrip:
    def test_autocast_tls_roundtrips(self, tmp_path):
        def make():
            with torch.autocast("cpu"):
                return torch.mm(torch.ones(4, 4), torch.ones(4, 4))

        t = deferred_init(make)
        assert t.dtype == torch.bfloat16
        out = materialize_tensor(_roundtrip({"t": t}, tmp_path)["t"])
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, torch.full((4, 4), 4.0, dtype=torch.bfloat16))

    def test_set_data_synthetic_op_roundtrips(self, tmp_path):
        class M(nn.Module):
            def __init__(self):
                super().__init__()
                self.lin = nn.Linear(3, 3, bias=False)
                self.lin.weight.data = torch.full((3, 3), 1.25)

        loaded = _roundtrip(deferred_init(M), tmp_path)
        w = materialize_tensor(loaded[next(iter(loaded))])
        assert torch.equal(w, torch.full((3, 3), 1.25))


def test_noncontiguous_root_geometry_survives_roundtrip(tmp_path):
    """The saved ``geom`` of a dense-but-permuted root (read by the JAX
    package's bridge) survives save/load, and the port replays it."""
    def build():
        a = torch.arange(12, dtype=torch.float32).reshape(2, 6)
        b = a.transpose(0, 1).abs().add(3.0)
        return (copy.deepcopy(b),)

    eager = build()[0]
    fakes = deferred_init(build)
    p = tmp_path / "rec.tdx"
    save_recording({"0": fakes[0]}, p)
    payload = torch.load(p, weights_only=True)
    assert any(rec["geom"] for rec in payload["nodes"])
    loaded = load_recording(p)
    assert torch.equal(_keyed(loaded, seed=0)["0"], eager)


def test_login_host_records_cuda_claims(tmp_path):
    """ROADMAP C15: a host with no CUDA (this CPU-only torch) records a
    model that claims ``cuda``: every fake claims cuda, nothing is
    allocated, no CUDA runtime starts, and the recording travels."""
    from torchdistx_tpu_torch.models.configs import TINY
    from torchdistx_tpu_torch.models.llama import make_llama

    if torch.cuda.is_available():
        pytest.skip("the login-host case needs a host with no CUDA device")
    m = deferred_init(make_llama, TINY, device="cuda")
    fakes = named_fake_tensors(m)
    assert fakes and all(is_fake(f) for f in fakes.values())
    assert {f.device.type for f in fakes.values()} == {"cuda"}
    assert all(not isinstance(f, torch.Tensor) or f._meta.device.type == "meta"
               for f in fakes.values())
    assert not torch.cuda.is_initialized()
    # A fake-mode factory call claims cuda too.
    with fake_mode():
        t = torch.ones(10, device="cuda")
    assert is_fake(t) and t.device.type == "cuda"
    # The recording travels and materializes where the caller asks.
    loaded = _roundtrip(m, tmp_path)
    assert {f.device.type for f in loaded.values()} == {"cuda"}
    got = _keyed(loaded, seed=1)
    want = _keyed(fakes, seed=1)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert {v.device.type for v in got.values()} == {"cpu"}
    # Eager replay of the cuda-claiming recording onto the CPU.
    materialize_module(m, device="cpu")
    assert not any(is_fake(p) for p in m.parameters())
