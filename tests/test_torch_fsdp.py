"""The port's FSDP hooks: ``param_init_fn`` materializes a module in
place (tied weights once), replaying what the JAX package's torch
frontend replays, bit for bit, under one seed; ``install_torchdistx_shim``
makes ``torchdistx`` resolve to the port."""

import sys

import torch
from torch import nn

from torchdistx_tpu.deferred_init import deferred_init as ref_deferred_init
from torchdistx_tpu.fsdp import make_param_init_fn as ref_make_param_init_fn
from torchdistx_tpu._graph import ReplayTarget as RefReplayTarget
from torchdistx_tpu_torch import deferred_init, is_fake
from torchdistx_tpu_torch import fake as port_fake_mod
from torchdistx_tpu_torch import fsdp
from torchdistx_tpu_torch._graph import ReplayTarget
from torchdistx_tpu_torch.models import TINY_GPT2, make_gpt2

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)


port_deferred_init_mod = sys.modules["torchdistx_tpu_torch.deferred_init"]


class Tied(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.emb = nn.Embedding(64, 32, device=device)
        self.body = nn.Linear(32, 32, device=device)
        self.head = nn.Linear(32, 64, bias=False, device=device)
        self.head.weight = self.emb.weight


def _per_unit(init_fn, module):
    """Materialize block by block, then the rest, as FSDP's wrapping of
    each block does."""
    for blk in module.blocks:
        init_fn(blk)
    init_fn(module)


def _whole(init_fn, module):
    init_fn(module)


def test_param_init_fn_materializes_in_place_like_the_reference():
    for make, args, how in ((Tied, (), _whole),
                            (make_gpt2, (TINY_GPT2,), _per_unit)):
        ours = deferred_init(make, *args, device="cpu")
        ref = ref_deferred_init(make, *args, device="cpu")
        torch.manual_seed(0)
        how(fsdp.make_param_init_fn(target=ReplayTarget("cpu")), ours)
        torch.manual_seed(0)
        how(ref_make_param_init_fn(target=RefReplayTarget("cpu")), ref)
        assert not any(is_fake(t) for t in ours.state_dict().values())
        got, want = ours.state_dict(), ref.state_dict()
        assert list(got) == list(want)
        for name in want:
            assert torch.equal(got[name], want[name]), name
        if make is Tied:  # tied weights were materialized once, to one tensor
            assert ours.head.weight is ours.emb.weight
            assert isinstance(ours.emb.weight, nn.Parameter)


def test_shim_resolves_torchdistx_to_the_port(monkeypatch):
    for name in ("torchdistx", "torchdistx.fake", "torchdistx.deferred_init"):
        monkeypatch.setitem(sys.modules, name, None)
    fsdp.install_torchdistx_shim(force=True)
    from torchdistx import deferred_init as shim_deferred_init
    from torchdistx import fake as shim_fake
    import torchdistx.deferred_init

    assert shim_deferred_init is port_deferred_init_mod
    assert shim_fake is port_fake_mod
    assert torchdistx.deferred_init.materialize_module is \
        port_deferred_init_mod.materialize_module
    m = torchdistx.deferred_init.deferred_init(Tied, device="cpu")
    assert shim_fake.is_fake(m.emb.weight)
