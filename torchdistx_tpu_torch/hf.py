"""HuggingFace convenience layer (counterpart of ``torchdistx_tpu/hf.py``).

The torchdistX workflow on HF models in three lines::

    from transformers import LlamaConfig
    from torchdistx_tpu_torch.hf import deferred_init_from_config, materialize_sharded
    from torchdistx_tpu_torch.parallel import make_mesh

    model = deferred_init_from_config(LlamaConfig())       # 0 bytes
    params = materialize_sharded(model, make_mesh({"fsdp": -1}), seed=0)

``deferred_init_from_config`` resolves the architecture through the
transformers Auto classes (``AutoModelForCausalLM`` by default — pass
``auto_cls`` for other heads) and records its construction;
``materialize_sharded`` replays the recording into this rank's shards
with a size-based FSDP plan when none is given.  ``transformers`` is
imported only inside these calls.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .deferred_init import deferred_init

__all__ = ["deferred_init_from_config", "materialize_sharded"]


def deferred_init_from_config(
    config: Any,
    *,
    auto_cls: Optional[type] = None,
    **kwargs: Any,
) -> torch.nn.Module:
    """``deferred_init(AutoModel*.from_config, config)``.

    ``config`` is any transformers ``PretrainedConfig``; the model class
    is resolved from it by ``auto_cls`` (default
    ``AutoModelForCausalLM``; use e.g. ``AutoModelForSeq2SeqLM`` for T5,
    or pass a concrete model class with a ``from_config``/``__call__``
    that accepts the config).
    """
    if auto_cls is None:
        from transformers import AutoModelForCausalLM

        auto_cls = AutoModelForCausalLM
    ctor = getattr(auto_cls, "from_config", auto_cls)
    return deferred_init(ctor, config, **kwargs)


def materialize_sharded(
    module: torch.nn.Module,
    mesh=None,
    *,
    plan=None,
    seed: int = 0,
    min_shard_size: int = 1 << 16,
    param_dtype=None,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Replay the module's recording into this rank's (sharded) tensors.

    With a mesh and no plan, parameters above ``min_shard_size`` elements
    are FSDP-sharded along their largest divisible dim (the name-agnostic
    plan — correct for any HF param naming scheme).  ``param_dtype``
    (e.g. ``torch.bfloat16``) stores floating parameters at that
    precision.  ``device`` as in
    :func:`.cuda_bridge.materialize_module_cuda`."""
    from .cuda_bridge import materialize_module_cuda

    if mesh is not None and plan is None:
        from .parallel import fsdp_plan

        plan = fsdp_plan(min_size=min_shard_size)
    return materialize_module_cuda(
        module, mesh=mesh, plan=plan, seed=seed, param_dtype=param_dtype,
        device=device,
    )
