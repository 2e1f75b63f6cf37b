"""torchdistx_tpu_torch: the PyTorch/CUDA port of torchdistx_tpu.

Fake tensors and deferred module initialization (record a model's
construction with no storage, then materialize its parameters straight
into GPU memory), the GPT-2/Llama model families, training
(``parallel.make_train_step``) through flash attention whose forward and
backward are hand-written CUDA kernels for Hopper
(``ops/csrc/flash_attention.cu``), and the paged-decode serving runtime,
whose decode attention is another (``ops/csrc/paged_decode.cu``).
``cuda_bridge.materialize_module_cuda`` replays a recording with keyed
RNG straight into each rank's planned shard on a ``DeviceMesh``
(``parallel.make_mesh``, the plans of ``parallel.sharding`` and
``models.plans``), leaving the module fake; ``cuda_bridge.bind_values``
binds the shards, and ``make_train_step(mesh=)`` trains them with tensor
parallelism and FSDP2 (``parallel.spmd``), its steps measured by
``observe`` when telemetry is on; ``hf`` and ``fsdp`` carry the
HuggingFace and torch-FSDP entry points.

The port imports nothing of the JAX package ``torchdistx_tpu``; it keeps
its own copies of what it needs.  Entry points run on the GPU
(``device="cuda"``) unless the caller passes ``device="cpu"``; when CUDA
is absent and the CPU was not asked for, they raise.
"""

from .deferred_init import (
    deferred_init,
    materialize_module,
    materialize_tensor,
)
from .fake import fake_mode, is_fake

__all__ = [
    "deferred_init",
    "fake_mode",
    "is_fake",
    "materialize_module",
    "materialize_tensor",
]
