"""The port's flash launch-shape tuner against the real kernels on the
card: every built launch shape measured, the winner one of them, a
second call served from the cache with no measurement, and an unbuilt
shape refused.  Skipped without an NVIDIA GPU (the CUDA kernels have no
CPU mode); ``chip_smoke.py``'s ``flash_tune`` runs the same at the llama
shape."""

import pytest
import torch

import torchdistx_tpu_torch.config as port_config
from torchdistx_tpu_torch.ops import autotune
from torchdistx_tpu_torch.ops import flash_attention as port_flash_fn
from torchdistx_tpu_torch.ops.autotune import BlockConfigError, tune_flash_blocks
from torchdistx_tpu_torch.ops.flash_attention import built_blocks


@pytest.mark.cuda
def test_measure_and_tune_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    with port_config.override(cache_dir=str(tmp_path)):
        autotune.reset_counts()
        blocks = tune_flash_blocks(batch=1, seq_len=256, heads=4, kv_heads=2,
                                   head_dim=128, workload="bwd")
        assert blocks in built_blocks(torch.bfloat16, 128)
        assert autotune.measurements == 2
        assert all(0 < t < float("inf")
                   for t in autotune.last_timings.values())
        assert tune_flash_blocks(batch=1, seq_len=256, heads=4, kv_heads=2,
                                 head_dim=128, workload="bwd") == blocks
        assert autotune.measurements == 2
        with pytest.raises(BlockConfigError, match="built blocks"):
            q = torch.randn(1, 64, 2, 64, device="cuda", dtype=torch.bfloat16)
            port_flash_fn(q, q, q, block_q=128, block_k=64)
