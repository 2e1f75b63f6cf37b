"""The port's paged decode attention held against the JAX package.

Every case of tests/test_paged_attention.py, with the same inputs (made
from a seed with numpy) going through the JAX functions — the Pallas
kernel in interpret mode, as that file runs it, and its jnp reference —
and through the port's plain PyTorch version, which is what the port's
``paged_attention`` runs on CPU tensors.  Tolerances are those of the
JAX suite: float32 1e-5, bfloat16 3e-2 (the two frameworks round the
bf16 inputs identically; the sums run in a different order).  Idle rows
(length 0) are excluded from kernel comparisons: the kernel writes zeros
there, the plain versions a uniform softmax the callers ignore.

The ragged and page-size cases: ``test_torch_paged_attention_ragged.py``;
the kernel against its plain version on the card (marked ``cuda``):
``test_torch_paged_attention_cuda.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from torchdistx_tpu.models.layers import default_attention as jax_default_attention
from torchdistx_tpu.ops import flash_attention as jax_flash_attention
from torchdistx_tpu.ops import paged_attention as jax_paged_attention
from torchdistx_tpu.ops import paged_attention_reference as jax_reference
from torchdistx_tpu.ops import paged_prefill_attention as jax_prefill
from torchdistx_tpu_torch.models.layers import default_attention
from torchdistx_tpu_torch.ops import (
    paged_attention,
    paged_attention_reference,
    paged_prefill_attention,
)
from torchdistx_tpu_torch.ops.paged_attention import split_plan

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np_case(seed, *, B, H, KV, D, page, n_pages, maxp):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(n_pages, page, KV, D).astype(np.float32)
    vp = rng.randn(n_pages, page, KV, D).astype(np.float32)
    perm = rng.permutation(n_pages - 1) + 1  # never the null page
    table = perm[: B * maxp].reshape(B, maxp).astype(np.int32)
    return q, kp, vp, table


def _both(q, kp, vp, lengths, table, dtype, device="cpu"):
    """(jax operands, torch operands) from the same numpy arrays."""
    lens = np.asarray(lengths, np.int32)
    jx = (jnp.asarray(q, JAX_DTYPE[dtype]), jnp.asarray(kp, JAX_DTYPE[dtype]),
          jnp.asarray(vp, JAX_DTYPE[dtype]), jnp.asarray(lens),
          jnp.asarray(table))
    td = TORCH_DTYPE[dtype]
    tx = tuple(torch.from_numpy(a).to(device, td) for a in (q, kp, vp)) + (
        torch.from_numpy(lens).to(device), torch.from_numpy(table).to(device))
    return jx, tx


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _check_against_jax(jx, tx, lengths, atol):
    port = paged_attention_reference(*tx)
    assert port.dtype == tx[0].dtype
    np.testing.assert_allclose(_f32(port), _f32(jax_reference(*jx)),
                               atol=atol)
    live = np.asarray(lengths) > 0
    np.testing.assert_allclose(_f32(port)[live],
                               _f32(jax_paged_attention(*jx))[live],
                               atol=atol)
    # The wrapper on CPU tensors is the plain version.
    np.testing.assert_array_equal(_f32(paged_attention(*tx)), _f32(port))


def test_idle_lane_matches_jax():
    """A length-0 lane: the plain versions agree with each other on every
    row; the JAX kernel's zero row is excluded."""
    q, kp, vp, table = _np_case(2, B=2, H=4, KV=2, D=8, page=8, n_pages=8,
                                maxp=2)
    jx, tx = _both(q, kp, vp, [0, 5], table, "float32")
    _check_against_jax(jx, tx, [0, 5], 1e-5)
    assert np.all(_f32(jax_paged_attention(*jx))[0] == 0.0)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_contiguous_single_page_matches_flash(dtype, atol):
    """Page b holds sequence b, all full: decode == flash attention's
    last-token causal output (JAX), and == the JAX paged kernel."""
    B, S, H, KV, D = 3, 16, 4, 2, 16
    rng = np.random.RandomState(3)
    qf = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, KV, D).astype(np.float32)
    v = rng.randn(B, S, KV, D).astype(np.float32)
    table = np.arange(B, dtype=np.int32)[:, None]
    jx, tx = _both(qf[:, -1], k, v, [S] * B, table, dtype)
    port = _f32(paged_attention_reference(*tx))
    jd = JAX_DTYPE[dtype]
    fl = jax_flash_attention(jnp.asarray(qf, jd), jnp.asarray(k, jd),
                             jnp.asarray(v, jd), causal=True)[:, -1]
    np.testing.assert_allclose(port, _f32(fl), atol=atol)
    np.testing.assert_allclose(port, _f32(jax_paged_attention(*jx)), atol=atol)


def test_ragged_lengths_match_dense_attention():
    """Decode of the L-th token == dense causal attention at position
    L-1, for the port's own default_attention and the JAX one."""
    B, S, H, KV, D = 3, 24, 4, 2, 8
    page, maxp = 8, 3
    lengths = [5, 24, 17]
    rng = np.random.RandomState(4)
    qf = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, KV, D).astype(np.float32)
    v = rng.randn(B, S, KV, D).astype(np.float32)
    kp = np.zeros((1 + B * maxp, page, KV, D), np.float32)
    vp = np.zeros_like(kp)
    table = np.zeros((B, maxp), np.int32)
    for b in range(B):
        for j in range(maxp):
            pid = 1 + b * maxp + j
            table[b, j] = pid
            kp[pid] = k[b, j * page:(j + 1) * page]
            vp[pid] = v[b, j * page:(j + 1) * page]
    q_last = np.stack([qf[b, L - 1] for b, L in enumerate(lengths)])
    jx, tx = _both(q_last, kp, vp, lengths, table, "float32")
    _check_against_jax(jx, tx, lengths, 1e-5)
    out = _f32(paged_attention_reference(*tx))
    for b, L in enumerate(lengths):
        sl = (slice(b, b + 1), slice(0, L))
        dense = default_attention(torch.from_numpy(qf[sl]),
                                  torch.from_numpy(k[sl]),
                                  torch.from_numpy(v[sl]), causal=True)[0, -1]
        jdense = jax_default_attention(jnp.asarray(qf[sl]), jnp.asarray(k[sl]),
                                       jnp.asarray(v[sl]), causal=True)[0, -1]
        np.testing.assert_allclose(out[b], _f32(dense), atol=1e-5)
        np.testing.assert_allclose(_f32(dense), _f32(jdense), atol=1e-5)


def test_gqa_grouping_matches_per_head_loop():
    """The (kv, group) head packing equals a per-head numpy computation."""
    B, H, KV, D, page, maxp = 2, 4, 2, 8, 4, 2
    lengths = [6, 8]
    q, kp, vp, table = _np_case(5, B=B, H=H, KV=KV, D=D, page=page,
                                n_pages=8, maxp=maxp)
    jx, tx = _both(q, kp, vp, lengths, table, "float32")
    _check_against_jax(jx, tx, lengths, 1e-5)
    ref = _f32(paged_attention_reference(*tx))
    groups = H // KV
    k = kp[table].reshape(B, maxp * page, KV, D)
    v = vp[table].reshape(B, maxp * page, KV, D)
    for b in range(B):
        L = lengths[b]
        for h in range(H):
            kv = h // groups
            logits = (q[b, h] / np.sqrt(D)) @ k[b, :L, kv].T
            p = np.exp(logits - logits.max())
            p /= p.sum()
            np.testing.assert_allclose(ref[b, h], p @ v[b, :L, kv], atol=1e-5)


def test_prefill_attention_matches_jax():
    """Chunked-prefill attention through the page table (ported for the
    chunked-prefill slice): each valid query row equals the JAX one."""
    B, S, H, KV, D, page, maxp = 2, 5, 4, 2, 8, 4, 4
    rng = np.random.RandomState(6)
    q = rng.randn(B, S, H, D).astype(np.float32)
    _, kp, vp, table = _np_case(6, B=B, H=H, KV=KV, D=D, page=page,
                                n_pages=12, maxp=maxp)
    start = np.array([3, 9], np.int32)
    lengths = np.array([3 + S, 9 + 3], np.int32)  # lane 1: 2 padded rows
    pos = (start[:, None] + np.arange(S, dtype=np.int32)[None]).astype(np.int32)
    got = paged_prefill_attention(*(torch.from_numpy(a) for a in
                                    (q, kp, vp, pos, lengths, table)))
    want = jax_prefill(*(jnp.asarray(a) for a in (q, kp, vp, pos, lengths,
                                                  table)))
    valid = pos < lengths[:, None]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=1e-5)


def test_shape_validation_matches_jax():
    q = torch.zeros(2, 4, 8)
    kp = torch.zeros(4, 8, 2, 8)
    lens = torch.zeros(2, dtype=torch.int32)
    table = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of KV heads"):
        paged_attention(torch.zeros(2, 3, 8), kp, kp, lens, table)
    with pytest.raises(ValueError, match="head_dim mismatch"):
        paged_attention(torch.zeros(2, 4, 4), kp, kp, lens, table)
    with pytest.raises(ValueError, match="batch mismatch"):
        paged_attention(q, kp, kp, lens, torch.zeros(3, 2, dtype=torch.int32))


def _split_merge(q, kp, vp, lengths, table, span):
    """The CUDA kernel pair's arithmetic as a plain torch function: each
    split s takes positions [s*span, (s+1)*span) below lengths[b], forms
    its max m_s, its sum l_s = sum exp(score - m_s) and its unnormalized
    partial o_s = sum exp(score - m_s) v; the merge weighs the splits
    that hold a position by exp(m_s - max_s m_s) and divides the weighted
    partials by the weighted sums.  A split past lengths[b] weighs 0 and
    an idle lane is an exact zero row."""
    B, H, D = q.shape
    page, KV = kp.shape[1], kp.shape[2]
    G, T = H // KV, table.shape[1] * page
    k = kp[table.long()].reshape(B, T, KV, D).float()
    v = vp[table.long()].reshape(B, T, KV, D).float()
    qf = q.float().reshape(B, KV, G, D) / np.sqrt(D)
    scores = torch.einsum("bkgd,btkd->bkgt", qf, k)
    out = torch.zeros(B, KV, G, D)
    for b in range(B):
        L = int(lengths[b])
        parts = []
        for s0 in range(0, L, span):
            sl = slice(s0, min(s0 + span, L))
            m = scores[b, :, :, sl].amax(-1, keepdim=True)
            p = torch.exp(scores[b, :, :, sl] - m)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("kgt,tkd->kgd", p, v[b, sl])))
        if not parts:
            continue
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        num = sum(torch.exp(m - mx) * o for m, _, o in parts)
        den = sum(torch.exp(m - mx) * l for m, l, _ in parts)
        out[b] = num / den
    return out.reshape(B, H, D)


def _split_boundary_case(span, page, maxp):
    """Lengths on both sides of the first split boundary: idle, one
    position, one page, boundary - 1, boundary, boundary + 1, full."""
    return [0, 1, page, span - 1, span, span + 1, maxp * page]


def test_split_plan_is_static_and_covers_the_table():
    """Splits come from the table width and the SM count alone; every
    position of the table lies in exactly one split, and a short table
    or a batch that fills the card takes one split."""
    assert split_plan(4, 32, 8, 48, 132) == (1, 64)
    assert split_plan(128, 32, 8, 4096, 132)[0] == 1  # 1024 CTAs already
    for B, H, KV, positions in ((8, 32, 8, 4096), (8, 12, 12, 1024),
                                (4, 32, 8, 1008), (7, 4, 2, 512)):
        splits, span = split_plan(B, H, KV, positions, 132)
        assert splits > 1 and span % 64 == 0 and span >= 256
        assert (splits - 1) * span < positions <= splits * span


def test_split_merge_matches_jax_at_split_boundaries():
    """The split-and-merge arithmetic, at the split plan of a 7-lane table
    of 512 positions, on lengths either side of a boundary: equal to the
    JAX Pallas kernel (interpret) and its reference within 1e-5 (f32) on
    live lanes, and an exact zero row on the idle lane."""
    B, H, KV, D, page, maxp = 7, 4, 2, 16, 128, 4
    splits, span = split_plan(B, H, KV, maxp * page, 132)
    assert splits == 2 and span == 256
    lengths = _split_boundary_case(span, page, maxp)
    rng = np.random.RandomState(8)
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(1 + B * maxp, page, KV, D).astype(np.float32)
    vp = rng.randn(1 + B * maxp, page, KV, D).astype(np.float32)
    table = (rng.permutation(B * maxp) + 1).reshape(B, maxp).astype(np.int32)
    jx, tx = _both(q, kp, vp, lengths, table, "float32")
    got = _split_merge(*tx, span).numpy()
    live = np.asarray(lengths) > 0
    assert np.all(got[~live] == 0.0)
    np.testing.assert_allclose(got[live], _f32(jax_reference(*jx))[live],
                               atol=1e-5)
    np.testing.assert_allclose(got, _f32(jax_paged_attention(*jx)), atol=1e-5)
    np.testing.assert_allclose(got[live],
                               _f32(paged_attention_reference(*tx))[live],
                               atol=1e-5)
