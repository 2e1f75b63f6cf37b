"""The keyed materializer on real ``DeviceMesh``es of CPU ranks (gloo, a
file rendezvous under ``tmp_path``): 4 ranks over ``{fsdp: 4}`` and
``{fsdp: 2, tp: 2}``, 8 ranks over ``{dp: 2, fsdp: 2, tp: 2}``.  Each rank
materializes tiny llama and T5 under the stock plan and under a plan
that splits dims over two axes in both orders, and checks, per entry:
the placements are the planned ones, the local tensor is its
coordinate's planned share, and ``full_tensor()`` equals the unsharded
run bit for bit.  Also ``make_mesh``'s ``-1`` inference and its errors,
against the JAX package's.

No JAX at module level: the spawned ranks import this module.
"""

import re
import warnings

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torchdistx_tpu_torch import deferred_init
from torchdistx_tpu_torch.cuda_bridge import materialize_module_cuda
from torchdistx_tpu_torch.models import TINY, TINY_T5, make_llama, make_t5
from torchdistx_tpu_torch.models.plans import decoder_lm_plan, t5_plan
from torchdistx_tpu_torch.parallel import (
    PartitionSpec as P,
    ShardingPlan,
    local_shard,
    make_mesh,
    placements_for,
)
from torchdistx_tpu_torch.parallel.mesh import _ordered_axes
from torchdistx_tpu_torch.parallel.sharding import mesh_shape

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

# Dims over two axes in both orders (the first named is the major one).
TWO_AXIS_PLAN = ShardingPlan([
    (r".*w[qkv]\.weight", P(("tp", "fsdp"), None)),
    (r".*wo\.weight", P(None, ("fsdp", "tp"))),
    (r".*w_(gate|up)\.weight", P(("tp", "dp", "fsdp"), None)),
    (r".*(embed|lm_head)\.weight", P(("fsdp", "tp"), None)),
], default=P(("tp", "fsdp")))


def _check_rank(rank: int, world: int, init_file: str, meshes) -> None:
    from torch.distributed.tensor import DTensor

    torch.set_num_threads(1)  # the ranks share the test worker's cores
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    warnings.simplefilter("ignore")  # indivisible dims and absent axes
    try:
        for axes in meshes:
            mesh = make_mesh(axes, device_type="cpu")
            shape = mesh_shape(mesh)
            coord = mesh.get_coordinate()
            for make, cfg, plan in ((make_llama, TINY, decoder_lm_plan(TINY)),
                                    (make_t5, TINY_T5, t5_plan(TINY_T5))):
                m = deferred_init(make, cfg, device="cpu")
                full = materialize_module_cuda(m, device="cpu")
                for p in (plan, TWO_AXIS_PLAN):
                    got = materialize_module_cuda(m, mesh=mesh, plan=p)
                    assert list(got) == list(full)
                    sharded = 0
                    for name, value in got.items():
                        spec = p.spec_for(name, tuple(full[name].shape), mesh)
                        assert isinstance(value, DTensor), name
                        assert tuple(value.placements) == \
                            placements_for(spec, mesh), name
                        want = local_shard(full[name], spec, shape, coord)
                        assert torch.equal(value.to_local(), want), name
                        assert torch.equal(value.full_tensor(), full[name]), name
                        sharded += want.numel() < full[name].numel()
                    assert sharded, (axes, cfg)
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, world, meshes):
    mp.spawn(_check_rank, args=(world, str(tmp_path / "rdzv"), meshes),
             nprocs=world, join=True)


def test_four_ranks(tmp_path):
    _spawn(tmp_path, 4, [{"fsdp": 4}, {"fsdp": -1, "tp": 2}])


def test_eight_ranks(tmp_path):
    _spawn(tmp_path, 8, [{"tp": 2, "fsdp": 2, "dp": -1}])


@pytest.mark.parametrize("axes", [
    {"fsdp": -1, "tp": 2}, {"tp": 4, "fsdp": 2}, {"dp": -1, "fsdp": -1},
    {"fsdp": 3}, {"fsdp": -1, "tp": 3}, {"x": 2, "tp": 2, "fsdp": 2},
])
def test_make_mesh_axes_like_the_reference(axes):
    """Axis order, the inferred ``-1`` and every error, as the JAX
    package's ``make_mesh`` over its 8 CPU devices."""
    from torchdistx_tpu.parallel.mesh import make_mesh as jax_make_mesh

    try:
        jm = jax_make_mesh(axes)
        want = [list(jm.axis_names), list(jm.devices.shape)]
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            _ordered_axes(axes, 8)
        return
    assert list(map(list, _ordered_axes(axes, 8))) == want


def test_make_mesh_needs_a_process_group():
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="init_process_group"):
            make_mesh({"fsdp": 1}, device_type="cpu")
