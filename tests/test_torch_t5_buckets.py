"""T5's relative-position bucket map against the JAX one.

Kept apart from ``test_torch_t5.py`` so that neither file holds more
than 9 tests: pytest-xdist's ``--dist loadfile`` starts the files with
the most tests first, and the JAX package's longest files hold few
(``test_rollover.py`` 9), so a slow port file of more than 9 would start
before them and delay them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistx_tpu.models.t5 import _relative_buckets as jax_buckets
from torchdistx_tpu_torch.models import TINY_T5
from torchdistx_tpu_torch.models.t5 import _relative_buckets

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)


@pytest.mark.parametrize("length", [114, 512, 2048])
@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bidirectional", "causal"])
def test_relative_buckets_match_jax(length, bidirectional):
    cfg = TINY_T5.encoder
    kw = dict(bidirectional=bidirectional, num_buckets=cfg.relative_pos_buckets,
              max_distance=cfg.relative_pos_max_distance)
    rel = np.arange(length)[None, :] - np.arange(length)[:, None]
    want = np.asarray(jax_buckets(jnp.asarray(rel), **kw))
    got = _relative_buckets(torch.from_numpy(rel), **kw).numpy()
    assert got.min() >= 0 and got.max() < cfg.relative_pos_buckets
    np.testing.assert_array_equal(got, want)
