"""The port's keyed materializer (``cuda_bridge``, run with
``device="cpu"``) held against the JAX package's
``materialize_module_jax`` on the same model recorded by each package's
frontend: tiny gpt2, llama and T5, a module with a buffer and a tied
weight, and a tiny HF GPT-2 through both ``hf.py``s (``test_torch_hf.py``).

Both draw from keyed generators of their own (threefry there, torch's
CPU generator here), so their random values differ; what must agree:

* names (tied entries once), shapes and dtypes, with and without
  ``param_dtype=bfloat16`` — Parameters cast, buffers not;
* every entry whose recording draws nothing, bit for bit;
* every random entry of at least 4096 elements, its std within 10 %.

And of the port alone: the eager ``materialize_module`` still equals
eager construction after keyed runs; the keyed values' own contract
(seeds, recordings, virtual meshes): ``test_torch_materialize_keyed.py``.
"""


import numpy as np
import pytest
import torch
from torch import nn

from torchdistx_tpu.deferred_init import deferred_init as ref_deferred_init
from torchdistx_tpu.jax_bridge import materialize_module_jax
from torchdistx_tpu_torch import _graph, deferred_init, materialize_module
from torchdistx_tpu_torch._graph import CONTEXT_KEY
from torchdistx_tpu_torch.cuda_bridge import (
    materialize_module_cuda,
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

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

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
