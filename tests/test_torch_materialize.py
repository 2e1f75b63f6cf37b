"""The port's keyed materializer (``cuda_bridge``, run with
``device="cpu"``) held against the JAX package's
``materialize_module_jax`` on the same model recorded by each package's
frontend: tiny gpt2, llama and T5, a module with a buffer and a tied
weight, and a tiny HF GPT-2 through both ``hf.py``s.

Both draw from keyed generators of their own (threefry there, torch's
CPU generator here), so their random values differ; what must agree:

* names (tied entries once), shapes and dtypes, with and without
  ``param_dtype=bfloat16`` — Parameters cast, buffers not;
* every entry whose recording draws nothing, bit for bit;
* every random entry of at least 4096 elements, its std within 10 %.

And of the port alone: the same seed gives the same values, another
seed changes every random entry, two recordings of one model give equal
values, a recording stays fake and materializes again, the global
generator is not touched, the eager ``materialize_module`` still equals
eager construction afterwards, and a virtual mesh's coordinates
reassemble into the unsharded values.
"""

import itertools

import numpy as np
import pytest
import torch
from torch import nn

from torchdistx_tpu.deferred_init import deferred_init as ref_deferred_init
from torchdistx_tpu.jax_bridge import materialize_module_jax
from torchdistx_tpu_torch import _graph, deferred_init, is_fake, materialize_module
from torchdistx_tpu_torch._graph import CONTEXT_KEY
from torchdistx_tpu_torch.cuda_bridge import (
    materialize_module_cuda,
    materialize_tensor_cuda,
    named_fake_tensors,
)
from torchdistx_tpu_torch.fake import get_fake_context
from torchdistx_tpu_torch.models import (
    TINY,
    TINY_GPT2,
    TINY_T5,
    make_gpt2,
    make_llama,
    make_t5,
)
from torchdistx_tpu_torch.models.plans import decoder_lm_plan
from torchdistx_tpu_torch.parallel import VirtualMesh, gspmd_2d_plan
from torchdistx_tpu_torch.parallel.sharding import local_shard, mesh_shape

STD_RTOL = 0.10
STD_MIN_NUMEL = 4096


class TiedWithBuffer(nn.Module):
    """An embedding tied to the head (the head's own init is a dead draw),
    a float buffer, and an integer buffer."""

    def __init__(self, device=None):
        super().__init__()
        self.emb = nn.Embedding(128, 64, device=device)
        self.proj = nn.Linear(64, 64, device=device)
        self.head = nn.Linear(64, 128, bias=False, device=device)
        self.head.weight = self.emb.weight
        self.register_buffer("inv_freq", 1.0 / (10000.0 ** (
            torch.arange(0, 16, 2, dtype=torch.float32, device=device) / 16)))
        self.register_buffer("steps", torch.zeros((), dtype=torch.int32,
                                                  device=device))


MODELS = {
    "gpt2": (make_gpt2, (TINY_GPT2,)),
    "llama": (make_llama, (TINY,)),
    "t5": (make_t5, (TINY_T5,)),
    "tied": (TiedWithBuffer, ()),
}


def _record(family):
    make, args = MODELS[family]
    return deferred_init(make, *args, device="cpu")


def _draws(fake) -> bool:
    """Whether the recording behind ``fake`` draws random numbers."""
    ctx = get_fake_context(fake, CONTEXT_KEY)
    return any(_graph._is_rng_op(n.op.func)
               for n in ctx.node.build_call_stack())


def _compare_with_jax(fakes, port, ref, param_dtype):
    assert list(port) == list(ref)
    for name, value in port.items():
        want = np.asarray(ref[name])
        got = value.float().numpy() if value.dtype == torch.bfloat16 \
            else value.numpy()
        assert tuple(value.shape) == want.shape, name
        assert str(value.dtype).removeprefix("torch.") == str(want.dtype), name
        is_param = isinstance(fakes[name], nn.Parameter)
        if param_dtype is not None and value.is_floating_point():
            want_dtype = param_dtype if is_param else fakes[name].dtype
            assert value.dtype == want_dtype, name
        if not _draws(fakes[name]):
            assert np.array_equal(got, want.astype(got.dtype)), name
        elif value.numel() >= STD_MIN_NUMEL:
            s_got, s_want = float(got.std()), float(want.astype(np.float32).std())
            assert abs(s_got - s_want) <= STD_RTOL * s_want, (name, s_got, s_want)


@pytest.mark.parametrize("family", list(MODELS))
@pytest.mark.parametrize("param_dtype", [None, torch.bfloat16])
def test_matches_the_jax_bridge(family, param_dtype):
    make, args = MODELS[family]
    ours = _record(family)
    ref = ref_deferred_init(make, *args, device="cpu")
    fakes = named_fake_tensors(ours)
    port = materialize_module_cuda(ours, param_dtype=param_dtype, device="cpu")
    jax_values = materialize_module_jax(
        ref, param_dtype=None if param_dtype is None else "bfloat16")
    _compare_with_jax(fakes, port, jax_values, param_dtype)
    if family == "tied":
        assert "head.weight" not in port and "emb.weight" in port
        assert port["inv_freq"].dtype == torch.float32
        assert port["steps"].dtype == torch.int32


def test_hf_gpt2_through_both_hf_layers():
    transformers = pytest.importorskip("transformers")
    from torchdistx_tpu import hf as ref_hf
    from torchdistx_tpu_torch import hf

    cfg = transformers.GPT2Config(n_layer=2, n_embd=64, n_head=4,
                                  vocab_size=256, n_positions=64)
    ours = hf.deferred_init_from_config(cfg)
    ref = ref_hf.deferred_init_from_config(cfg)
    fakes = named_fake_tensors(ours)
    for param_dtype, jax_dtype in ((None, None), (torch.bfloat16, "bfloat16")):
        port = hf.materialize_sharded(ours, param_dtype=param_dtype,
                                      device="cpu")
        want = ref_hf.materialize_sharded(ref, param_dtype=jax_dtype)
        _compare_with_jax(fakes, port, want, param_dtype)
    assert all(is_fake(p) for p in ours.parameters())


@pytest.mark.parametrize("family", ["llama", "t5", "tied"])
def test_keyed_values_are_a_function_of_seed_and_recording(family):
    m = _record(family)
    fakes = named_fake_tensors(m)
    state = torch.get_rng_state()
    a = materialize_module_cuda(m, seed=0, device="cpu")
    assert torch.equal(torch.get_rng_state(), state)  # global stream untouched
    b = materialize_module_cuda(m, seed=0, device="cpu")
    c = materialize_module_cuda(m, seed=1, device="cpu")
    other = _record(family)  # a second recording in the same process
    d = materialize_module_cuda(other, seed=0, device="cpu")
    for name in a:
        assert torch.equal(a[name], b[name]), name
        assert torch.equal(a[name], d[name]), name
        assert torch.equal(a[name], c[name]) != _draws(fakes[name]), name
    # the recording was not consumed: still fake, still replayable
    assert all(is_fake(t) for t in named_fake_tensors(m).values())
    assert set(named_fake_tensors(m)) == set(a)


def test_eager_route_is_unchanged_after_keyed_runs():
    """Keyed runs leave the recording and the global generator as they
    were: eager ``materialize_module`` afterwards still equals eager
    construction under the same seed."""
    m = _record("llama")
    materialize_module_cuda(m, device="cpu")
    torch.manual_seed(0)
    got = materialize_module(m, device="cpu").state_dict()
    torch.manual_seed(0)
    want = make_llama(TINY, device="cpu").state_dict()
    assert list(got) == list(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("plan,axes", [
    (decoder_lm_plan(TINY), {"fsdp": 2, "tp": 4}),
    (gspmd_2d_plan(min_size=1), {"fsdp": 2, "tp": 4}),
    (gspmd_2d_plan(("tp", "fsdp"), min_size=1), {"dp": 2, "fsdp": 2, "tp": 2}),
])
def test_virtual_mesh_coordinates_reassemble(plan, axes):
    """Each coordinate's local shards, materialized on their own, are the
    planned slices of the unsharded values."""
    m = _record("llama")
    full = materialize_module_cuda(m, device="cpu")
    shape = mesh_shape(VirtualMesh(axes, {a: 0 for a in axes}))
    specs = {n: plan.spec_for(n, tuple(t.shape), shape) for n, t in full.items()}
    sharded = 0
    for coord in itertools.product(*(range(s) for s in shape.values())):
        mesh = VirtualMesh(axes, dict(zip(shape, coord)))
        local = materialize_module_cuda(m, mesh=mesh, plan=plan, device="cpu")
        for name, value in local.items():
            assert value.is_contiguous()
            want = local_shard(full[name], specs[name], shape, coord)
            assert torch.equal(value, want), (coord, name)
            sharded += value.numel() < full[name].numel()
    assert sharded


def test_materialize_tensor():
    t = deferred_init(lambda: torch.randn(64, 64, device="cpu").mul_(2))
    a = materialize_tensor_cuda(t, device="cpu")
    assert torch.equal(a, materialize_tensor_cuda(t, device="cpu"))
    assert 1.7 < float(a.std()) < 2.3
    b = materialize_tensor_cuda(t, param_dtype=torch.bfloat16, device="cpu")
    assert b.dtype == torch.bfloat16 and torch.equal(b, a.to(torch.bfloat16))
    with pytest.raises(ValueError, match="not fake"):
        materialize_tensor_cuda(a, device="cpu")


def test_gpu_is_the_default():
    m = _record("tied")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            materialize_module_cuda(m)


def test_values_read_while_recording_are_copied_not_mutated():
    """A value read during recording replays early; the keyed run copies
    it, so in-place ops recorded after the read do not pile up across
    runs."""

    def build():
        w = torch.ones(4, device="cpu")
        if float(w.sum()) > 0:  # a value read: early replay
            w.add_(torch.randn(4, device="cpu"))
        return w

    t = deferred_init(build)
    a = materialize_tensor_cuda(t, device="cpu").clone()
    b = materialize_tensor_cuda(t, device="cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, torch.ones(4))
