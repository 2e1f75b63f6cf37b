"""Multi-host meshes (``parallel/mesh.py``): ``make_hybrid_mesh``'s
layouts against the JAX ``make_hybrid_mesh`` on the 8 virtual CPU
devices (``tests/test_parallel.py::TestHybridMesh``'s cases: DCN axes
across the slices, each ICI submesh inside one slice, axis inference and
the three errors), the same meshes built by 8 gloo ranks brought up by
``initialize_multihost`` (each rank's coordinate, ``LOCAL_WORLD_SIZE``
as the host size, the call idempotent), the one-process no-op, and a
train step from keyed values on a one-rank hybrid mesh equal bit for bit
to the one on ``{fsdp 1, tp 1}``.

No JAX at module level: the spawned ranks import this module.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torchdistx_tpu_torch import deferred_init
from torchdistx_tpu_torch.cuda_bridge import bind_values, materialize_module_cuda
from torchdistx_tpu_torch.models import TINY, make_llama
from torchdistx_tpu_torch.models.plans import decoder_lm_plan
from torchdistx_tpu_torch.parallel import (
    initialize_multihost,
    make_hybrid_mesh,
    make_mesh,
    make_train_step,
)
from torchdistx_tpu_torch.parallel.mesh import hybrid_layout

torch.set_num_threads(2)

CASES = [  # (dcn axes, ici axes, num_slices)
    ({"dp": 2}, {"fsdp": 2, "tp": 2}, 2),
    ({"dp": -1}, {"tp": -1}, 2),
    ({"dp": 2, "fsdp": 2}, {"tp": 2}, 4),
    ({"dp": 1}, {"fsdp": 4, "tp": 2}, 1),
]
ERRORS = [  # (dcn axes, ici axes, num_slices, message)
    ({"dp": 3}, {"tp": 4}, 2, "multiply"),
    ({"dp": 2}, {"dp": 4}, 2, "both"),
    ({"dp": -1}, {"tp": -1}, 3, "divisible"),
]


def test_layouts_are_the_jax_hybrid_meshes():
    import jax

    from torchdistx_tpu.parallel import make_hybrid_mesh as jax_hybrid

    ids = {d: i for i, d in enumerate(jax.devices())}
    for dcn, ici, slices in CASES:
        want = jax_hybrid(dcn, ici, num_slices=slices)
        names, ranks = hybrid_layout(dcn, ici, 8, num_slices=slices)
        assert names == tuple(want.axis_names)
        assert ranks.tolist() == np.vectorize(ids.get)(want.devices).tolist()
    for dcn, ici, slices, msg in ERRORS:
        with pytest.raises(ValueError, match=msg):
            jax_hybrid(dcn, ici, num_slices=slices)
        with pytest.raises(ValueError, match=msg):
            hybrid_layout(dcn, ici, 8, num_slices=slices)


def _rank(rank: int, world: int, init_file: str, out_dir: str) -> None:
    import json

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE="4")
    got = initialize_multihost(f"file://{init_file}", backend="gloo")
    assert initialize_multihost() == got == rank  # idempotent
    rows = []
    try:
        for dcn, ici, slices in CASES:
            mesh = make_hybrid_mesh(dcn, ici, num_slices=slices,
                                    device_type="cpu")
            rows.append({"names": list(mesh.mesh_dim_names),
                         "ranks": mesh.mesh.tolist(),
                         "coord": list(mesh.get_coordinate())})
        # Hosts from LOCAL_WORLD_SIZE: 2 hosts of 4 ranks.
        mesh = make_hybrid_mesh({"dp": -1}, {"fsdp": 2, "tp": 2},
                                device_type="cpu")
        rows.append({"names": list(mesh.mesh_dim_names),
                     "ranks": mesh.mesh.tolist(),
                     "coord": list(mesh.get_coordinate())})
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rows, f)


def test_eight_gloo_ranks_build_the_layouts(tmp_path):
    import json

    world = 8
    mp.spawn(_rank, args=(world, str(tmp_path / "rdzv"), str(tmp_path)),
             nprocs=world, join=True)
    cases = CASES + [({"dp": -1}, {"fsdp": 2, "tp": 2}, 2)]
    for rank in range(world):
        rows = json.loads((tmp_path / f"rank{rank}.json").read_text())
        for row, (dcn, ici, slices) in zip(rows, cases):
            names, ranks = hybrid_layout(dcn, ici, world, num_slices=slices)
            assert row["names"] == list(names)
            assert row["ranks"] == ranks.tolist()
            where = (ranks == rank).nonzero()[0].tolist()
            assert row["coord"] == where
        # ICI axes within a host: the (fsdp, tp) block of each dp index
        # holds one host's 4 ranks.
        assert [sorted(sum(blk, [])) for blk in rows[-1]["ranks"]] == [
            [0, 1, 2, 3], [4, 5, 6, 7]]


def test_initialize_multihost_one_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost() == 0
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        make_hybrid_mesh({"dp": 1}, {"tp": 1}, device_type="cpu")
    with pytest.raises(ValueError, match="address"):
        initialize_multihost(world_size=2, rank=0)


def _losses(mesh, steps: int = 2):
    model = deferred_init(make_llama, TINY, device="cpu")
    bind_values(model, materialize_module_cuda(
        model, mesh=mesh, plan=decoder_lm_plan(TINY), device="cpu"))
    init_state, train_step, shard_batch = make_train_step(
        model, TINY, device="cpu", mesh=mesh)
    state = init_state(model)
    out = []
    for step in range(steps):
        toks = np.random.RandomState(step).randint(0, TINY.vocab_size, (4, 16))
        state, metrics = train_step(state, shard_batch(toks))
        out.append(float(metrics["loss"]))
    return out


def test_one_rank_hybrid_mesh_steps_like_the_flat_mesh():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        assert initialize_multihost() == 0
        hybrid = make_hybrid_mesh({"dp": 1}, {"fsdp": 1, "tp": 1},
                                  device_type="cpu")
        assert hybrid.mesh_dim_names == ("dp", "fsdp", "tp")
        got = _losses(hybrid)
        want = _losses(make_mesh({"fsdp": 1, "tp": 1}, device_type="cpu"))
    finally:
        dist.destroy_process_group()
    assert got == want
