"""The paged-decode CUDA kernel against its plain version on the card
(marked ``cuda``: skipped without a GPU).

Kept apart from ``test_torch_paged_attention.py`` so that neither file
holds more than 9 tests: pytest-xdist's ``--dist loadfile`` starts the
files with the most tests first, and the JAX package's longest files
hold few (``test_rollover.py`` 9), so a slow port file of more than 9
would start before them and delay them.
"""

import numpy as np
import pytest
import torch

from torchdistx_tpu_torch.ops import paged_attention, paged_attention_reference
from torchdistx_tpu_torch.ops.paged_attention import kernel_plan, split_plan
from test_torch_paged_attention import (
    _both,
    _f32,
    _np_case,
    _split_boundary_case,
)

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "split-boundaries"])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (8, 1)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, atol, H, KV, case):
    """The hand-written kernel against the plain version on the card,
    idle rows exactly zero; each launch is counted.  ``split-boundaries``
    takes a table wide enough for several splits on this card and lengths
    either side of the first boundary."""
    B, D, page, maxp = 5, 16, 8, 3
    lengths = [1, page * maxp, 0, 7, 13]
    if case == "split-boundaries":
        B, maxp = 7, 128
        splits, span = split_plan(
            B, H, KV, maxp * page,
            torch.cuda.get_device_properties(cuda_device).multi_processor_count)
        assert splits > 1
        lengths = _split_boundary_case(span, page, maxp)
    q, kp, vp, table = _np_case(0, B=B, H=H, KV=KV, D=D, page=page,
                                n_pages=1 + B * maxp, maxp=maxp)
    _, tx = _both(q, kp, vp, lengths, table, dtype, device=cuda_device)
    before = paged_attention.launches
    merges = paged_attention.merge_launches
    out = paged_attention(*tx)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    splits, _ = kernel_plan(tx[0], tx[1], tx[4])
    assert paged_attention.merge_launches == merges + (splits > 1)
    ref = paged_attention_reference(*tx)
    live = torch.tensor(lengths, device=cuda_device) > 0
    assert torch.all(out[~live] == 0)
    np.testing.assert_allclose(_f32(out[live].cpu()), _f32(ref[live].cpu()),
                               atol=atol)
