"""The port's fake tensors and deferred init: materialization equals eager
construction bitwise under one ``torch.manual_seed``, and equals the JAX
package's torch frontend (its ``deferred_init``/``materialize_module``,
which replay onto the CPU) on the same module, bitwise; fakes allocate
nothing; tied weights stay tied; no entry point falls back to the CPU."""

import resource

import pytest
import torch
from torch import nn

from torchdistx_tpu.deferred_init import deferred_init as ref_deferred_init
from torchdistx_tpu.deferred_init import materialize_module as ref_materialize
from torchdistx_tpu_torch import (
    deferred_init,
    fake_mode,
    is_fake,
    materialize_module,
    materialize_tensor,
)
from torchdistx_tpu_torch._graph import ReplayTarget
from torchdistx_tpu_torch.models import LLAMA3_8B, TINY, TINY_GPT2
from torchdistx_tpu_torch.serve import engine as serve_engine
from torchdistx_tpu_torch.serve import make_model, spin_up_replica

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

MODELS = {"llama": TINY, "gpt2": TINY_GPT2}


def _assert_bitwise(a: nn.Module, b: nn.Module):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and sa[k].device == sb[k].device, k
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("family", ["llama", "gpt2"])
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_materialize_equals_eager_and_reference(family, param_dtype):
    cfg = MODELS[family].replace(param_dtype=param_dtype)
    torch.manual_seed(7)
    eager = make_model(family, cfg, device="cpu")

    fake = deferred_init(make_model, family, cfg, "cpu")
    assert all(is_fake(p) for p in fake.parameters())
    torch.manual_seed(7)
    ours = materialize_module(fake, device="cpu")
    assert not any(is_fake(p) for p in ours.parameters())
    _assert_bitwise(ours, eager)

    ref_fake = ref_deferred_init(make_model, family, cfg, "cpu")
    torch.manual_seed(7)
    _assert_bitwise(ours, ref_materialize(ref_fake))


def test_fakes_allocate_nothing():
    """A 16 GB llama3-8b records as fakes without host memory to match."""
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    fake = deferred_init(make_model, "llama", LLAMA3_8B, "cpu")
    grew = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 - rss0
    params = list(fake.parameters())
    claimed = sum(p.numel() * p.element_size() for p in params)
    assert all(is_fake(p) for p in params)
    assert claimed > 30e9  # f32 parameters as the preset stores them
    assert grew < claimed / 100
    with fake_mode():
        big = torch.empty(2**20, 2**19)
    assert is_fake(big) and "fake=True" in repr(big)
    with pytest.raises(RuntimeError, match="no storage"):
        big.tolist()


class _Tied(nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = nn.Embedding(16, 8)
        self.mid = nn.Linear(8, 8)
        self.head = nn.Linear(8, 16, bias=False)
        self.head.weight = self.emb.weight


def test_tied_weights_stay_tied():
    """The dead RNG draw of the overwritten head init replays too, so the
    weights after the tie match eager construction bitwise."""
    torch.manual_seed(3)
    eager = _Tied()
    fake = deferred_init(_Tied)
    torch.manual_seed(3)
    m = materialize_module(fake, device="cpu")
    assert m.head.weight is m.emb.weight
    _assert_bitwise(m, eager)


def test_materialize_tensor_and_probes():
    fake = deferred_init(nn.Linear, 4, 3)
    t = torch.ones(2)
    assert materialize_tensor(t) is t  # non-fakes pass through
    real = materialize_tensor(fake.weight, target=ReplayTarget("cpu"))
    assert isinstance(real, nn.Parameter) and real.shape == (3, 4)
    with pytest.raises(ValueError, match="already been materialized"):
        materialize_tensor(fake.weight, target=ReplayTarget("cpu"))


def test_no_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA path")
    fake = deferred_init(nn.Linear, 4, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        materialize_module(fake)
    assert is_fake(fake.weight)  # nothing was replayed


def test_spin_up_replica_records_with_zero_storage(monkeypatch):
    """spin_up_replica hands materialize_module a recording whose every
    parameter is a fake (no storage), then serves from real ones."""
    seen = {}

    def spy(module, **kw):
        seen["fakes"] = [is_fake(p) for p in module.parameters()]
        return real_materialize(module, **kw)

    real_materialize = serve_engine.materialize_module
    monkeypatch.setattr(serve_engine, "materialize_module", spy)
    eng = spin_up_replica("tiny", device="cpu")
    assert seen["fakes"] and all(seen["fakes"])
    assert not any(is_fake(p) for p in eng.model.parameters())
