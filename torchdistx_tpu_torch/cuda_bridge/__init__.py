"""Keyed, sharded materialization of deferred-init recordings on the
GPU (counterpart of ``torchdistx_tpu/jax_bridge``'s public API)."""

from .materialize import (
    bind_values,
    materialize_module_cuda,
    materialize_params_cuda,
    materialize_tensor_cuda,
    named_fake_tensors,
)

__all__ = [
    "bind_values",
    "materialize_module_cuda",
    "materialize_params_cuda",
    "materialize_tensor_cuda",
    "named_fake_tensors",
]
