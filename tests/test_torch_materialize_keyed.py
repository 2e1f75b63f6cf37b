"""The keyed materializer's own contract: values a function of the seed and
the recording, virtual-mesh coordinates that reassemble the full values,
``materialize_tensor_cuda``, the CUDA default, values read while recording.

Kept apart from ``test_torch_materialize.py`` so that neither file holds
more than 9 tests: pytest-xdist's ``--dist loadfile`` starts the files
with the most tests first, and the JAX package's longest files hold few
(``test_rollover.py`` 9), so a slow port file of more than 9 would start
before them and delay them.
"""

import itertools

import pytest
import torch

from torchdistx_tpu_torch import deferred_init, is_fake
from torchdistx_tpu_torch.cuda_bridge import (
    materialize_module_cuda,
    materialize_tensor_cuda,
    named_fake_tensors,
)
from torchdistx_tpu_torch.models import TINY
from torchdistx_tpu_torch.models.plans import decoder_lm_plan
from torchdistx_tpu_torch.parallel import VirtualMesh, gspmd_2d_plan
from torchdistx_tpu_torch.parallel.sharding import local_shard, mesh_shape
from test_torch_materialize import _draws, _record

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)


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
