"""The port's flash attention with an additive bias held against the JAX
package's.

The bias cases of tests/test_ops.py (``test_bias_kernel_matches_xla``,
``test_bias_gradients_match_xla``, ``test_bias_gqa_cross_lengths``,
``test_segment_ids_with_bias_and_gqa`` and the row-broadcast
``test_bias_row_broadcast_alibi_style``): the same inputs, made from a
seed with numpy, go through the JAX ``flash_attention`` — the Pallas
kernels in interpret mode with 16-wide blocks, the d(bias) kernel
included — and through the port's ``flash_attention``, which on CPU
tensors runs its plain versions.  The forward output and the gradients
of ``sum(sin(out))`` with respect to q, k, v and the bias are compared
within 1e-5 x max(1, |JAX value|), the JAX suite's float32 band (the same
math, summed in another order).

The kernel-vs-plain test on the card is marked ``cuda``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torchdistx_tpu.ops import flash_attention as jax_flash_attention
from torchdistx_tpu_torch.ops import flash_attention
from torchdistx_tpu_torch.ops.flash_attention import (
    bias_launches,
    flash_backward,
    flash_backward_reference,
    flash_forward,
    flash_forward_reference,
    launches,
)

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

ATOL = 1e-5

CASES = {  # shape, causal, bias shape (by letters), segment ids
    "S50-causal-full": (dict(B=2, S=50, H=4, D=16), True, "HST", False),
    "S50-causal-broadcast": (dict(B=2, S=50, H=4, D=16), True, "1ST", False),
    "S50-full-full": (dict(B=2, S=50, H=4, D=16), False, "HST", False),
    "S50-full-broadcast": (dict(B=2, S=50, H=4, D=16), False, "1ST", False),
    "S48-causal-full": (dict(B=2, S=48, H=4, D=16), True, "HST", False),
    "S48-causal-broadcast": (dict(B=2, S=48, H=4, D=16), True, "1ST", False),
    "gqa-cross-24x64": (dict(B=1, S=24, T=64, H=8, KV=2, D=16), True, "HST",
                        False),
    "segments-gqa": (dict(B=2, S=32, H=4, KV=2, D=16), True, "HST", True),
    "row-broadcast": (dict(B=1, S=32, H=2, D=16), True, "H1T", False),
    # The d(bias) kernel's ring of rows: one plane for all B*H = 8 rows,
    # GQA, causal with T > S and T % 4 != 0.
    "ring-of-rows-broadcast-gqa": (dict(B=2, S=40, T=50, H=4, KV=2, D=16),
                                   True, "1ST", False),
}


def _inputs(seed, bias_dims, *, B, S, H, D, T=None, KV=None):
    T = S if T is None else T
    KV = H if KV is None else KV
    rng = np.random.RandomState(seed)
    bias_shape = [{"H": H, "1": 1, "S": S, "T": T}[c] for c in bias_dims]
    return (rng.randn(B, S, H, D).astype(np.float32),
            rng.randn(B, T, KV, D).astype(np.float32),
            rng.randn(B, T, KV, D).astype(np.float32),
            rng.randn(*bias_shape).astype(np.float32))


def _halves(B, S):
    return np.tile((np.arange(S) >= S // 2).astype(np.int32), (B, 1))


def _close(got, want, what, atol=ATOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= atol, f"{what}: {err.max()}"


@pytest.mark.parametrize("name", list(CASES))
def test_bias_forward_and_grads_match_jax(name):
    shape, causal, bias_dims, segs = CASES[name]
    arrays = _inputs(0, bias_dims, **shape)
    seg = _halves(shape["B"], shape["S"]) if segs else None

    @jax.jit  # one compile of forward and backward: faster than eager
    def jax_fwd_bwd(q, k, v, b):
        def fn(q, k, v, b):
            return jax_flash_attention(
                q, k, v, causal=causal, bias=b,
                segment_ids=None if seg is None else jnp.asarray(seg),
                block_q=16, block_k=16)
        out, vjp = jax.vjp(fn, q, k, v, b)
        return out, vjp(jnp.cos(out))  # d sum(sin(out))

    want, want_grads = jax_fwd_bwd(*(jnp.asarray(a) for a in arrays))

    tx = [torch.from_numpy(a).requires_grad_() for a in arrays]
    before = dict(launches)
    got = flash_attention(*tx[:3], causal=causal, bias=tx[3],
                          segment_ids=None if seg is None
                          else torch.from_numpy(seg))
    torch.sin(got).sum().backward()
    assert launches == before  # CPU tensors run the plain versions

    _close(got.detach(), want, "out")
    for what, t, w in zip(("dq", "dk", "dv", "dbias"), tx, want_grads):
        _close(t.grad, w, what)


def test_dbias_sums_the_rows_of_each_plane():
    """At the raw layout, d(bias) of a per-head bias sums the rows b*H + h
    of every batch item b into plane h; a head-broadcast bias sums every
    row.  flash_forward / flash_backward on CPU tensors are the plain
    versions, the heads taken from the bias."""
    B, H, S, D = 2, 3, 20, 16
    rng = np.random.RandomState(4)
    q, do = (torch.from_numpy(rng.randn(B * H, S, D).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(B * H, S, D).astype(np.float32))
            for _ in range(2))
    for bias in (torch.from_numpy(rng.randn(H, S, S).astype(np.float32)),
                 torch.from_numpy(rng.randn(1, S, S).astype(np.float32))):
        out, lse = flash_forward(q, k, v, causal=True, bias=bias)
        r_out, r_lse = flash_forward_reference(q, k, v, True, None, bias, H)
        assert torch.equal(out, r_out) and torch.equal(lse, r_lse)
        delta = (do * out).sum(-1)
        grads = flash_backward(q, k, v, do, lse, delta, causal=True,
                               bias=bias, heads=H, want_dbias=True)
        assert len(grads) == 4 and grads[3].shape == bias.shape
        assert len(flash_backward(q, k, v, do, lse, delta, bias=bias)) == 3
        rows = []
        for bh in range(B * H):
            plane = bias[bh % H if bias.shape[0] > 1 else 0][None]
            one = slice(bh, bh + 1)
            rows.append(flash_backward_reference(
                q[one], k[one], v[one], do[one], lse[one], delta[one], True,
                None, plane)[3][0])
        rows = torch.stack(rows)
        want = (rows.view(B, H, S, S).sum(0) if bias.shape[0] > 1
                else rows.sum(0, keepdim=True))
        np.testing.assert_allclose(grads[3].numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("bias_shape,match", [
    ((3, 16, 16), "bias must be"),
    ((4, 16), "bias must be"),
    ((4, 16, 17), "bias must be"),
], ids=["heads", "rank", "keys"])
def test_bias_validation_raises(bias_shape, match):
    q = torch.zeros(1, 16, 4, 16)
    with pytest.raises(ValueError, match=match):
        flash_attention(q, q, q, causal=False, bias=torch.zeros(bias_shape))


def test_raw_bias_validation_raises():
    """The raw layout takes only a full [H or 1, S, T] plane, and heads
    that split the rows into batch items."""
    q = torch.zeros(8, 16, 16)
    with pytest.raises(ValueError, match="bias must be"):
        flash_forward(q, q, q, bias=torch.zeros(4, 1, 16), heads=4)
    with pytest.raises(ValueError, match="heads=3"):
        flash_forward(q, q, q, bias=torch.zeros(1, 16, 16), heads=3)
    with pytest.raises(ValueError, match="want_dbias"):
        flash_backward(q, q, q, q, q[..., 0], q[..., 0], want_dbias=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("float32", ATOL), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][2] != "H1T"])
def test_cuda_bias_kernels_match_plain(cuda_device, name, dtype, atol):
    """The four kernels with the bias against the plain versions on the
    card (float32 within 1e-5, bfloat16 within 3e-2, relative above
    magnitude 1), each launch counted."""
    shape, causal, bias_dims, segs = CASES[name]
    B, S, H = shape["B"], shape["S"], shape["H"]
    q, k, v, bias = (torch.from_numpy(a).to(cuda_device) for a in
                     _inputs(2, bias_dims, **shape))
    qh = q.transpose(1, 2).reshape(B * H, S, -1).contiguous()
    kh, vh = (t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])
              .contiguous() for t in (k, v))
    do = torch.randn_like(qh)
    qh, kh, vh, do = (t.to(getattr(torch, dtype)) for t in (qh, kh, vh, do))
    seg = None
    if segs:
        ids = torch.from_numpy(_halves(B, S)).to(cuda_device)
        seg = (ids, ids)
    kw = dict(causal=causal, segment_ids=seg, bias=bias, heads=H)
    before = dict(bias_launches)
    out, lse = flash_forward(qh, kh, vh, **kw)
    r_out, r_lse = flash_forward_reference(qh, kh, vh, causal, seg, bias, H)
    delta = (do.float() * r_out.float()).sum(-1)
    grads = flash_backward(qh, kh, vh, do, r_lse, delta, want_dbias=True, **kw)
    r_grads = flash_backward_reference(qh, kh, vh, do, r_lse, delta, causal,
                                       seg, bias, H)
    torch.cuda.synchronize()
    assert {n: bias_launches[n] - before[n] for n in bias_launches} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
        "flash_dbias": 1}
    for what, a, b in zip(("out", "lse", "dq", "dk", "dv", "dbias"),
                          (out, lse, *grads), (r_out, r_lse, *r_grads)):
        _close(a.float().cpu(), b.float().cpu(), what, atol)
