"""The train step's options: those not ported yet raise, the attention
function comes from the model (``attn_fn=`` sets only a pipeline's), the
device defaults to CUDA.

Kept apart from ``test_torch_train.py`` so that neither file holds more
than 9 tests: pytest-xdist's ``--dist loadfile`` starts the files with
the most tests first, and the JAX package's longest files hold few
(``test_rollover.py`` 9), so a slow port file of more than 9 would start
before them and delay them.
"""

import pytest
import torch

from torchdistx_tpu_torch.models import (
    TINY,
    TINY_MOE,
    make_llama,
    make_mixtral,
)
from torchdistx_tpu_torch.models.layers import default_attention
from torchdistx_tpu_torch.ops import make_flash_attention
from torchdistx_tpu_torch.parallel import make_train_step

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)


@pytest.mark.parametrize("kw,what", [
    (dict(pipeline=True), (ValueError, "needs a mesh with a 'pp' axis")),
    (dict(attn_fn=default_attention), (ValueError, "constructor")),
    (dict(mesh={"fsdp": 1, "sp": 1}), None),
    (dict(mesh={"ep": 1, "tp": 1}), None),
    (dict(mesh={"pp": 1, "fsdp": 1}, pipeline=True), None),
    (dict(mesh={"fsdp": 1}, moe=True), None),
    (dict(mesh={"fsdp": 1}, pipeline=True),
     (ValueError, "needs a mesh with a 'pp' axis")),
], ids=["pipeline", "attn-fn", "mesh-sp", "mesh-ep", "mesh-pp", "mesh-moe",
        "mesh-pipeline"])
def test_unported_options_raise(kw, what):
    """Options and mesh axes the port does not carry yet raise, naming
    their ROADMAP item (meshes: one gloo rank, an in-memory store).
    Misused options raise ``ValueError``: a pipeline without a ``pp`` mesh
    axis, ``attn_fn`` without a pipeline.  The ``ep`` axis and a MoE
    config (``what`` None), ported with ROADMAP A9, the ``sp`` axis,
    ported with A10, and a pipeline over ``pp`` with ``fsdp``, ported with
    A11.2, are taken; the pipelines themselves in
    ``test_torch_pipeline*.py``."""
    import torch.distributed as dist

    from torchdistx_tpu_torch.parallel import make_mesh

    kw = dict(kw)
    moe = kw.pop("moe", False)
    cfg = TINY_MOE if moe else TINY
    model = (make_mixtral if moe else make_llama)(cfg, device="cpu")
    axes = kw.pop("mesh", None)
    if axes is None:
        with pytest.raises(what[0], match=what[1]):
            make_train_step(model, cfg, device="cpu", **kw)
        return
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(axes, device_type="cpu")
        if what is None:
            make_train_step(model, cfg, device="cpu", mesh=mesh, **kw)
        else:
            with pytest.raises(what[0], match=what[1]):
                make_train_step(model, cfg, device="cpu", mesh=mesh, **kw)
    finally:
        dist.destroy_process_group()


def test_moe_config_raises():
    """Training takes a MoE config (ROADMAP A9); serving one still raises,
    as the JAX engine refuses MoE decode."""
    from torchdistx_tpu_torch.serve.programs import make_model

    model = make_mixtral(TINY_MOE, device="cpu")
    make_train_step(model, TINY_MOE, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        make_model("llama", TINY_MOE, device="cpu")


def test_attn_fn_override_and_cuda_default():
    """An ``attn_fn`` override without a pipeline raises (attention is the
    model constructor's; the JAX argument sets the pipelined stages') and
    leaves the model untouched; the default device is the GPU, which
    raises where there is none."""
    model = make_llama(TINY, device="cpu")
    with pytest.raises(ValueError, match="constructor"):
        make_train_step(model, TINY, attn_fn=make_flash_attention(),
                        device="cpu")
    assert all(b.attn.attn_fn is default_attention for b in model.blocks)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_train_step(model, TINY)
