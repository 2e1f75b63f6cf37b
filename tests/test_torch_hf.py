"""The Hugging Face path of the keyed materializer (``hf.deferred_init_from_config``
-> ``hf.materialize_sharded``) against the JAX package's, both param dtypes;
and an HF model's recording saved and loaded (``serialize``), the HF case
of the JAX package's ``tests/test_serialize.py``.

Kept apart from ``test_torch_materialize.py`` so that neither file holds
more than 9 tests: pytest-xdist's ``--dist loadfile`` starts the files
with the most tests first, and the JAX package's longest files hold few
(``test_rollover.py`` 9), so a slow port file of more than 9 would start
before them and delay them.
"""

import pytest
import torch

from torchdistx_tpu_torch import is_fake
from torchdistx_tpu_torch.cuda_bridge import named_fake_tensors
from test_torch_materialize import _compare_with_jax

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)


def test_hf_gpt2_through_both_hf_layers():
    transformers = pytest.importorskip("transformers")
    from torchdistx_tpu import hf as ref_hf
    from torchdistx_tpu_torch import hf

    cfg = transformers.GPT2Config(n_layer=2, n_embd=64, n_head=4,
                                  vocab_size=256, n_positions=64)
    ours = hf.deferred_init_from_config(cfg)
    ref = ref_hf.deferred_init_from_config(cfg)
    fakes = named_fake_tensors(ours)
    for param_dtype, jax_dtype in ((None, None), (torch.bfloat16, "bfloat16")):
        port = hf.materialize_sharded(ours, param_dtype=param_dtype,
                                      device="cpu")
        want = ref_hf.materialize_sharded(ref, param_dtype=jax_dtype)
        _compare_with_jax(fakes, port, want, param_dtype)
    assert all(is_fake(p) for p in ours.parameters())


def test_hf_gpt2_recording_roundtrip(tmp_path):
    transformers = pytest.importorskip("transformers")
    from torchdistx_tpu_torch import deferred_init
    from torchdistx_tpu_torch.cuda_bridge import materialize_params_cuda
    from torchdistx_tpu_torch.serialize import load_recording, save_recording

    cfg = transformers.GPT2Config(n_layer=1, n_head=2, n_embd=32,
                                  vocab_size=128, n_positions=32)
    m = deferred_init(transformers.GPT2LMHeadModel, cfg)
    save_recording(m, tmp_path / "gpt2.tdx")
    loaded = load_recording(tmp_path / "gpt2.tdx")
    params = materialize_params_cuda(loaded, seed=0, device="cpu")
    assert params["transformer.wte.weight"].shape == (128, 32)
    assert all(torch.isfinite(v).all() for v in params.values()
               if v.is_floating_point())
    want = materialize_params_cuda(named_fake_tensors(m), seed=0, device="cpu")
    assert all(torch.equal(params[n], want[n]) for n in want)
