"""The pieces of sequence parallelism that need no process group: the
ring's softmax merge and its backward on rows that see no key, which key
blocks a rank launches, the models on a chunk at its positions
(``seq_shard``), and ``shard_batch``'s chunk with the next token."""

import pytest
import torch

from torchdistx_tpu_torch.models import TINY, TINY_GPT2, TINY_T5, make_gpt2, make_llama
from torchdistx_tpu_torch.models.decomposition import chunk_positions
from torchdistx_tpu_torch.models.t5 import RelativePositionBias
from torchdistx_tpu_torch.ops.flash_attention import flash_forward_reference
from torchdistx_tpu_torch.parallel.ring_flash import Ring, _merge, ring_flash_backward
from torchdistx_tpu_torch.parallel.train import _chunk_with_next

torch.set_num_threads(2)


def _ring(n: int = 1, idx: int = 0) -> Ring:
    """A ring position with no process group (n = 1 sends nothing)."""
    ring = Ring.__new__(Ring)
    ring.n, ring.idx, ring.group = n, idx, None
    return ring


def test_merge_of_blocks_is_the_whole_softmax():
    """Three key blocks merged pairwise give the softmax over all keys."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(4, 8, 16, generator=g)
    k, v = torch.randn(4, 24, 16, generator=g), torch.randn(4, 24, 16, generator=g)
    want, want_lse = flash_forward_reference(q, k, v, causal=False)
    o = torch.zeros(4, 8, 16)
    lse = torch.full((4, 8), -1e30)
    for b in range(3):
        o_b, lse_b = flash_forward_reference(q, k[:, 8 * b:8 * b + 8],
                                             v[:, 8 * b:8 * b + 8], False)
        o, lse = _merge(o, lse, o_b, lse_b)
    assert torch.allclose(o, want, atol=1e-6)
    assert torch.allclose(lse, want_lse, atol=1e-5)


def test_merge_of_empty_blocks_stays_empty():
    """Rows that see no key in either block (lse -1e30, output 0) merge to
    a zero row with lse -1e30, not NaN; an empty block leaves a full one
    as it was."""
    empty_o, empty_lse = torch.zeros(2, 3, 4), torch.full((2, 3), -1e30)
    o, lse = _merge(empty_o, empty_lse, empty_o.clone(), empty_lse.clone())
    assert torch.equal(o, empty_o) and bool((lse <= -1e29).all())
    full_o = torch.randn(2, 3, 4)
    full_lse = torch.randn(2, 3)
    o, lse = _merge(full_o, full_lse, empty_o, empty_lse)
    assert torch.allclose(o, full_o) and torch.equal(lse, full_lse)


def test_backward_rows_that_see_no_key():
    """A query whose segment appears among no key has lse -1e30; the
    backward pins it large and positive, so a large bias cannot turn
    exp(s - lse) into inf: its gradients are zero and all are finite."""
    g = torch.Generator().manual_seed(1)
    q, do = torch.randn(2, 4, 16, generator=g), torch.randn(2, 4, 16, generator=g)
    k, v = torch.randn(2, 6, 16, generator=g), torch.randn(2, 6, 16, generator=g)
    q_seg = torch.tensor([[0, 0, 1, 9]])  # id 9 is among no key
    kv_seg = torch.tensor([[0, 0, 0, 1, 1, 1]])
    bias = torch.full((2, 4, 6), 80.0)
    out, lse = flash_forward_reference(q, k, v, False, (q_seg, kv_seg), bias,
                                       heads=2)
    assert bool((lse[:, 3] <= -1e29).all())
    delta = (do * out).sum(-1)
    dq, dk, dv, dbias = ring_flash_backward(
        q, k, v, do, lse, delta, _ring(), False, bias=bias, heads=2,
        q_seg=q_seg, kv_seg=kv_seg, want_dbias=True)
    for t in (dq, dk, dv, dbias):
        assert bool(torch.isfinite(t).all())
    assert bool((dq[:, 3] == 0).all()) and bool((dbias[:, 3] == 0).all())


def test_ring_launches_past_and_diagonal_blocks_only():
    """Under causal masking rank r runs the blocks before it unmasked, its
    own causal, and skips the later ones: r + 1 launches."""
    for idx in range(4):
        ring = _ring(4, idx)
        kinds = [ring.kind(src, True) for src in range(4)]
        assert kinds == [False] * idx + [True] + [None] * (3 - idx)
        assert all(ring.kind(src, False) is False for src in range(4))


def _identity_attention(q, k, v, *, causal=True, bias=None, segment_ids=None):
    """Each position sees only itself: a chunk's output is then its slice
    of the whole sequence's exactly when its positions are right."""
    G = q.shape[2] // v.shape[2]
    return v.repeat_interleave(G, dim=2)


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_chunk_forward_at_its_positions(family):
    """``seq_shard=(r, n)``: rope angles (llama) or ``wpe`` rows (GPT-2) of
    the chunk's absolute positions, so a position-wise model gives each
    chunk its slice of the whole forward."""
    make, cfg = (make_llama, TINY) if family == "llama" else (make_gpt2, TINY_GPT2)
    torch.manual_seed(0)
    model = make(cfg.replace(dtype=torch.float32), attn_fn=_identity_attention,
                 device="cpu")
    if family == "llama":
        # rope rotates q and k only: let the attention read q
        for blk in model.blocks:
            blk.attn.attn_fn = lambda q, k, v, **kw: q
    tokens = torch.randint(0, cfg.vocab_size, (2, 32))
    with torch.no_grad():
        whole = model(tokens)
        for r in range(4):
            got = model(tokens[:, 8 * r:8 * r + 8], seq_shard=(r, 4))
            assert torch.allclose(got, whole[:, 8 * r:8 * r + 8], atol=1e-5)


def test_t5_bias_rows_of_a_chunk():
    """The relative-position bias of chunk r: its rows against every key
    column, computed from the relative positions, equal to the rows of
    the whole [H, S, S] bias; positions of a chunk start at r * length."""
    assert chunk_positions((2, 4), 8).tolist() == list(range(16, 24))
    with pytest.raises(ValueError, match="outside"):
        chunk_positions((4, 4), 8)
    torch.manual_seed(0)
    for bidirectional in (True, False):
        rel = RelativePositionBias(TINY_T5.encoder, bidirectional, "cpu")
        whole = rel(32, 32)
        for r in range(4):
            assert torch.equal(rel(8, 8, (r, 4)), whole[:, 8 * r:8 * r + 8])


def test_chunk_with_next_token():
    """Each rank's chunk is followed by the next position's entry; -1
    past the row's end; a row that does not split raises."""
    t = torch.arange(12).view(2, 6)
    assert _chunk_with_next(t, 0, 3).tolist() == [[0, 1, 2], [6, 7, 8]]
    assert _chunk_with_next(t, 2, 3).tolist() == [[4, 5, -1], [10, 11, -1]]
    with pytest.raises(ValueError, match="equal chunks"):
        _chunk_with_next(t, 0, 4)
