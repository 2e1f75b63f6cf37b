"""The port's flash attention held against the JAX package's.

The same inputs, made from a seed with numpy, go through the JAX
``flash_attention`` — the Pallas kernels in interpret mode with 16-wide
blocks, as tests/test_ops.py runs them — and through the port's
``flash_attention``, which on CPU tensors runs its plain versions.  The
forward output and the gradients of ``sum(sin(out))`` (``jax.vjp`` against
``torch.autograd``) are compared.  Tolerances are those of the JAX suite:
float32 1e-5 (the same math, summed in another order), bfloat16 3e-2
times max(1, |JAX value|) — both frameworks compute in float32 and round
the result to bfloat16 once, so a value of magnitude above 1 may differ
by its own rounding step.  Rows that see no key are zero in both.

The kernel-vs-plain tests on the card are marked ``cuda``.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torchdistx_tpu.ops import flash_attention as jax_flash_attention
from torchdistx_tpu_torch.models.layers import default_attention
from torchdistx_tpu_torch.ops import flash_attention, make_flash_attention
from torchdistx_tpu_torch.ops.flash_attention import (
    _dense_probs,
    _flash_forward,
    flash_backward,
    flash_backward_dkv,
    flash_backward_dq,
    flash_backward_reference,
    flash_forward,
    flash_forward_reference,
    launches,
)

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ATOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _segments(kind, B):
    """The packings of tests/test_ops.py as numpy ([B, S], [B, T]) ids."""
    def ids(*runs):
        row = np.concatenate([np.full(n, i, np.int32)
                              for i, n in enumerate(runs)])
        return np.tile(row, (B, 1))

    if kind == "three":  # 3 documents packed into S=50
        return ids(20, 18, 12), None
    if kind == "halves":
        return ids(16, 16), None
    return ids(12, 12), ids(25, 15)  # cross-attention pair, S=24, T=40


CASES = {  # shape, causal, segments, dtype
    "mha-ragged-50-causal": (dict(B=2, S=50, H=4, D=16), True, None,
                             "float32"),
    "mha-ragged-50-full": (dict(B=2, S=50, H=4, D=16), False, None,
                           "float32"),
    "gqa": (dict(B=1, S=32, H=8, KV=2, D=16), True, None, "float32"),
    "mqa": (dict(B=1, S=32, H=8, KV=1, D=16), True, None, "float32"),
    "cross-24x64-causal": (dict(B=1, S=24, T=64, H=2, D=16), True, None,
                           "float32"),
    "cross-64x24-empty-rows": (dict(B=1, S=64, T=24, H=2, D=16), True, None,
                               "float32"),
    "bfloat16": (dict(B=1, S=32, H=2, D=16), True, None, "bfloat16"),
    "bfloat16-gqa-ragged": (dict(B=1, S=50, H=4, KV=2, D=16), False, None,
                            "bfloat16"),
    "segments-causal": (dict(B=2, S=50, H=4, D=16), True, "three", "float32"),
    "segments-cross-pair": (dict(B=1, S=24, T=40, H=2, D=16), False, "pair",
                            "float32"),
}


# On the card only: the bf16 dk/dv kernel's tiles (64 keys; 64 queries,
# 32 at D = 128) at head dims 32, 64 and 128, S and T multiples of
# neither; the bf16 forward and dq kernels' tiles (64 rows, 64 keys) at
# D = 128, causal with S > T (the first 50 rows see no key); and their
# bias tile by 4-byte copies (T = 114) at D = 64, one plane ("Hb": 1) for
# every head.
CARD_CASES = {
    "dkv-ragged-d32-causal-gqa": (dict(B=2, S=100, T=150, H=4, KV=2, D=32),
                                  True, None, "bfloat16"),
    "dkv-ragged-d64-full-mqa": (dict(B=2, S=150, T=100, H=4, KV=1, D=64),
                                False, None, "bfloat16"),
    "dkv-ragged-d128-causal-gqa": (dict(B=1, S=114, T=178, H=4, KV=2,
                                        D=128), True, None, "bfloat16"),
    "dkv-ragged-d128-segments": (dict(B=2, S=50, H=4, D=128), True, "three",
                                 "bfloat16"),
    "fq-ragged-d128-causal-empty-rows": (dict(B=1, S=150, T=100, H=4, KV=2,
                                              D=128), True, None, "bfloat16"),
    "fq-d64-broadcast-bias-t114": (dict(B=2, S=70, T=114, H=4, D=64, Hb=1),
                                   True, None, "bfloat16"),
}


def _inputs(seed, *, B, S, H, D, T=None, KV=None):
    T = S if T is None else T
    KV = H if KV is None else KV
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, D).astype(np.float32),
            rng.randn(B, T, KV, D).astype(np.float32),
            rng.randn(B, T, KV, D).astype(np.float32))


def _close(got, want, dtype, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= ATOL[dtype], f"{what}: {err.max()}"


@pytest.mark.parametrize("name", list(CASES))
def test_forward_and_grads_match_jax(name):
    shape, causal, segs, dtype = CASES[name]
    q, k, v = _inputs(0, **shape)
    seg = None
    if segs is not None:
        qs, ks = _segments(segs, shape["B"])
        seg = qs if ks is None else (qs, ks)

    def jax_fn(q, k, v):
        jseg = None if seg is None else jax.tree.map(jnp.asarray, seg)
        return jax_flash_attention(q, k, v, causal=causal, segment_ids=jseg,
                                   block_q=16, block_k=16)

    @jax.jit  # one compile of forward and backward: faster than eager
    def jax_fwd_bwd(q, k, v):
        out, vjp = jax.vjp(jax_fn, q, k, v)
        return out, vjp(jnp.cos(out))  # d sum(sin(out))

    jx = [jnp.asarray(a, JAX_DTYPE[dtype]) for a in (q, k, v)]
    want, want_grads = jax_fwd_bwd(*jx)

    tx = [torch.from_numpy(a).to(TORCH_DTYPE[dtype]).requires_grad_()
          for a in (q, k, v)]
    tseg = None if seg is None else (
        torch.from_numpy(seg) if ks is None
        else tuple(torch.from_numpy(s) for s in seg))
    before = dict(launches)
    got = flash_attention(*tx, causal=causal, segment_ids=tseg)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == tx[0].shape
    torch.sin(got).sum().backward()
    assert launches == before  # CPU tensors run the plain versions

    _close(got.detach().float(), jnp.asarray(want, jnp.float32), dtype, "out")
    for what, t, w in zip(("dq", "dk", "dv"), tx, want_grads):
        _close(t.grad.float(), jnp.asarray(w, jnp.float32), dtype, what)


def test_rows_without_keys_are_zero():
    """Causal with S > T: the first S - T queries see no key; output,
    lse and gradients there are those of the TPU kernel (0, -1e30, 0)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, B=1, S=40, T=16, H=2,
                                                     D=16))
    qh = q.transpose(1, 2).reshape(2, 40, 16)
    kh = k.transpose(1, 2).reshape(2, 16, 16)
    vh = v.transpose(1, 2).reshape(2, 16, 16)
    out, lse = flash_forward_reference(qh, kh, vh, causal=True)
    assert torch.all(out[:, :24] == 0) and torch.all(lse[:, :24] == -1e30)
    assert torch.all(out[:, 24:].abs().sum(-1) > 0)
    do = torch.ones_like(out)
    delta = (do * out).sum(-1)
    dq, dk, dv = flash_backward_reference(qh, kh, vh, do, lse, delta, True)
    assert torch.all(dq[:, :24] == 0) and torch.isfinite(dk).all()


def test_raw_entry_points_are_the_plain_versions_on_cpu():
    """flash_forward / flash_backward at the [B*H, S, D] layout on CPU
    tensors equal the plain versions, GQA rows routed bh -> bh // G."""
    rng = np.random.RandomState(5)
    q, do = (torch.from_numpy(rng.randn(8, 24, 32).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(2, 24, 32).astype(np.float32))
            for _ in range(2))
    out, lse = flash_forward(q, k, v, causal=True)
    r_out, r_lse = flash_forward_reference(q, k, v, True)
    assert torch.equal(out, r_out) and torch.equal(lse, r_lse)
    delta = (do * out).sum(-1)
    for a, b in zip(flash_backward(q, k, v, do, lse, delta, causal=True),
                    flash_backward_reference(q, k, v, do, lse, delta, True)):
        assert torch.equal(a, b)
    # The group sum: kv head 0 serves query rows 0..3.
    dk = flash_backward_reference(q, k, v, do, lse, delta, True)[1]
    solo = [flash_backward_reference(q[g:g + 1], k[:1], v[:1], do[g:g + 1],
                                     lse[g:g + 1], delta[g:g + 1], True)[1]
            for g in range(4)]
    np.testing.assert_allclose(dk[0].numpy(), sum(solo)[0].numpy(), atol=1e-5)


@pytest.mark.parametrize("call,exc,match", [
    (lambda q, kv: flash_attention(q, kv[:, :, :3], kv[:, :, :3]),
     ValueError, "multiple of KV heads"),
    (lambda q, kv: flash_attention(q, kv, kv, bias=torch.zeros(3, 16, 16)),
     ValueError, "bias must be"),
    (lambda q, kv: flash_attention(q, kv, kv,
                                   segment_ids=torch.zeros(1, 17, dtype=torch.int32)),
     ValueError, "segment_ids must be"),
    (lambda q, kv: flash_attention(q[..., :8], kv[..., :8], kv[..., :8]),
     ValueError, "head_dim"),
], ids=["heads", "bias", "segments", "head-dim"])
def test_validation_raises(call, exc, match):
    q = torch.zeros(1, 16, 8, 16)
    kv = torch.zeros(1, 16, 4, 16)
    with pytest.raises(exc, match=match):
        call(q, kv)


def test_model_attn_fn_signature():
    """make_flash_attention() is an AttnFn: keyword causal and optional
    segment ids, block sizes accepted for the JAX signature's sake."""
    attn = make_flash_attention(block_q=16, block_k=16)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, B=1, S=20, H=2, D=16))
    ref = flash_attention(q, k, v, causal=False)
    assert torch.equal(attn(q, k, v, causal=False), ref)


def test_bf16_delta_from_the_unrounded_output():
    """The backward takes delta = rowsum(do * o) from the forward's output
    before its rounding to bf16.  With a large key component shared by
    every position and near-uniform attention, the true dq is small
    (sum_j dS_ij = 0 cancels the shared part) and a delta off by the
    output's rounding swamps it; the flash dq then still matches plain
    attention's, while the rounded-output delta does not."""
    B, S, T, H, D = 1, 16, 256, 2, 16
    rng = np.random.RandomState(0)
    q = rng.randn(B, S, H, D).astype(np.float32) * 0.3
    k = (rng.randn(B, T, H, D) + 64 * rng.randn(1, 1, H, D)).astype(np.float32)
    v = rng.randn(B, T, H, D).astype(np.float32)
    do = torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32)).bfloat16()
    flash = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v)]
    plain = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v)]
    flash_attention(*flash, causal=False).backward(do)
    default_attention(*plain, causal=False).backward(do)

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    assert rel(flash[0].grad, plain[0].grad) < 1e-3
    qh, kh, vh, doh = (t.detach().transpose(1, 2).reshape(B * H, -1, D)
                       for t in (flash[0], flash[1], flash[2], do))
    out, lse = flash_forward(qh, kh, vh, causal=False)
    rounded = (doh.float() * out.float()).sum(-1)
    dq = flash_backward_reference(qh, kh, vh, doh, lse, rounded, False)[0]
    dq = dq.view(B, H, S, D).transpose(1, 2)
    assert rel(dq, plain[0].grad) > 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES) + list(CARD_CASES))
def test_cuda_kernels_match_plain(cuda_device, name):
    """The hand-written kernels against the plain versions on the card,
    each launch counted: forward, then both backward kernels from the
    plain forward's lse."""
    shape, causal, segs, dtype = {**CASES, **CARD_CASES}[name]
    B, S, H, D = shape["B"], shape["S"], shape["H"], shape["D"]
    T, KV = shape.get("T", S), shape.get("KV", H)
    rng = np.random.RandomState(2)
    td = TORCH_DTYPE[dtype]
    q, do = (torch.from_numpy(rng.randn(B * H, S, D).astype(np.float32))
             .to(cuda_device, td) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(B * KV, T, D).astype(np.float32))
            .to(cuda_device, td) for _ in range(2))
    seg = None
    if segs is not None:
        qs, ks = _segments(segs, B)
        seg = (torch.from_numpy(qs).to(cuda_device),
               torch.from_numpy(qs if ks is None else ks).to(cuda_device))
    bias = None
    if "Hb" in shape:
        bias = torch.from_numpy(rng.randn(shape["Hb"], S, T).astype(
            np.float32)).to(cuda_device)
    kw = dict(bias=bias, heads=H)
    before = dict(launches)
    out, lse = flash_forward(q, k, v, causal=causal, segment_ids=seg, **kw)
    r_out, r_lse = flash_forward_reference(q, k, v, causal, seg, bias, H)
    delta = (do.float() * r_out.float()).sum(-1)
    grads = flash_backward(q, k, v, do, r_lse, delta, causal=causal,
                           segment_ids=seg, **kw)
    r_grads = flash_backward_reference(q, k, v, do, r_lse, delta, causal, seg,
                                       bias, H)
    torch.cuda.synchronize()
    assert {n: launches[n] - before[n] for n in launches} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
        "flash_dbias": 0}
    live = (r_lse > -1e29).cpu()
    assert torch.all(out.cpu()[~live] == 0)
    _close(out.cpu()[live].float(), r_out.cpu()[live].float(), dtype, "out")
    # lse is float32 in both dtypes: the same scores, summed in f32.
    _close(lse.cpu()[live], r_lse.cpu()[live], "float32", "lse")
    for what, a, b in zip(("dq", "dk", "dv"), grads, r_grads):
        _close(a.cpu().float(), b.cpu().float(), dtype, what)


# The hi/lo split of dS in the bf16 dk/dv kernel.  Each row of dS sums to
# zero, so sum_j dK_j = sum_i (sum_j dS_ij) q_i = 0 exactly.  A query
# component shared by every row (in head dims that every key leaves at
# zero, so the scores do not see it) turns an error in a row's sum into
# that error times the shared component, while near-uniform attention and
# dO rows in +/- pairs keep the true dK small.  dK itself is rounded to
# bf16, which puts ||sum_j dK_j|| / ||dK|| near 2**-9 whatever came
# before; dS rounded once adds its own 2**-9 of every row sum, times the
# shared component.  (chip_smoke.py holds the kernel to the same limit.)


def _dk_sum_case(seed, BH=2, S=256, D=128, shared=64.0):
    rng = np.random.RandomState(seed)
    h = D // 2
    q = rng.randn(BH, S, D) * 0.1
    q[:, :, :h] = shared * rng.randn(BH, 1, h) + rng.randn(BH, S, h)
    k = rng.randn(BH, S, D)
    k[:, :, :h] = 0.0
    v = rng.randn(BH, S, D)
    do = rng.randn(BH, S // 2, D)
    return [torch.from_numpy(a).bfloat16().double()
            for a in (q, k, v, np.concatenate([do, -do], 1))]


def _sum_ratio(dk):
    dk = dk.double()
    return (dk.sum(1).norm() / dk.norm()).item()


def test_dk_sum_case_separates_the_split():
    """On the plain version: dK from dS split into two bf16 parts sums to
    zero as well as the exact dK rounded once to bf16 does (within 2x, the
    limit the kernel is held to on the card), while dK from dS rounded
    once misses it by more than 10x and is off by more than the 1e-2
    normwise limit of the card's bf16 checks."""
    q, k, v, do = _dk_sum_case(0)
    out, lse = flash_forward_reference(q, k, v, False)
    delta = (do * out).sum(-1)
    dk = flash_backward_reference(q, k, v, do, lse, delta, False)[1]
    s, _, _ = _dense_probs(q, k, False, None)
    dp = torch.bmm(do, v.transpose(1, 2))
    ds = torch.exp(s - lse[..., None]) * (dp - delta[..., None]) / math.sqrt(128)
    hi = ds.bfloat16().double()
    lo = (ds - hi).bfloat16().double()

    def dk_from(parts):
        return sum(torch.bmm(p.transpose(1, 2), q) for p in parts).bfloat16()

    exact = _sum_ratio(dk.bfloat16())
    assert _sum_ratio(dk) < 1e-12
    assert _sum_ratio(dk_from([hi, lo])) <= 2 * exact
    once = dk_from([hi])
    assert _sum_ratio(once) > 10 * exact
    assert ((once.double() - dk).norm() / dk.norm()).item() > 1e-2


@pytest.mark.cuda
def test_cuda_bf16_dk_sums_to_zero(cuda_device):
    """The bf16 dk/dv kernel on the case above: ||sum_j dK_j|| / ||dK||
    within 2x of the exact dK rounded once to bf16, and dK within 1e-2
    normwise of the exact one."""
    ref = _dk_sum_case(0)
    q, k, v, do = (t.to(cuda_device, torch.bfloat16) for t in ref)
    out, lse = flash_forward_reference(*ref[:3], False)
    delta = (ref[3] * out).sum(-1)
    dk = flash_backward_dkv(q, k, v, do, lse.float().to(cuda_device),
                            delta.float().to(cuda_device), causal=False)[0]
    r_dk = flash_backward_reference(*ref, lse, delta, False)[1]
    dk = dk.cpu().double()
    assert _sum_ratio(dk) <= 2 * _sum_ratio(r_dk.bfloat16())
    assert ((dk - r_dk).norm() / r_dk.norm()).item() <= 1e-2


# dq's hi/lo split of dS.  Keys sharing a large component c (k_j = c +
# n_j) shift each query's scores by q_i . c, which cancels in the softmax,
# and sum_j dS_ij = 0 cancels c from the true dq = sum_j dS_ij k_j too;
# near-uniform attention keeps that dq small.  dS rounded once to bf16
# leaves about 2**-9 of each row's sum_j |dS_ij| in that sum, times c.
# (chip_smoke.py holds the kernel to the same limit.)


def _dq_shared_case(seed, BH=2, S=256, D=128, shared=64.0):
    rng = np.random.RandomState(seed)
    q = rng.randn(BH, S, D) * 0.1
    k = shared * rng.randn(BH, 1, D) + rng.randn(BH, S, D)
    v = rng.randn(BH, S, D)
    do = rng.randn(BH, S, D)
    return [torch.from_numpy(a).bfloat16().double() for a in (q, k, v, do)]


def _off(x, exact, size=None):
    size = exact if size is None else size
    return ((x.double() - exact).norm() / size.norm()).item()


def test_dq_shared_key_case_separates_the_split():
    """On the plain version: dq from dS split into two bf16 parts is as
    close to the exact dq as that dq rounded once to bf16 (within 2x, the
    limit the kernel is held to on the card), while dq from dS rounded once
    misses by more than 10x that and by more than the 1e-2 normwise limit
    of the card's bf16 checks."""
    q, k, v, do = _dq_shared_case(0)
    out, lse = flash_forward_reference(q, k, v, False)
    delta = (do * out).sum(-1)
    dq = flash_backward_reference(q, k, v, do, lse, delta, False)[0]
    s, _, _ = _dense_probs(q, k, False, None)
    dp = torch.bmm(do, v.transpose(1, 2))
    ds = torch.exp(s - lse[..., None]) * (dp - delta[..., None]) / math.sqrt(128)
    hi = ds.bfloat16().double()
    lo = (ds - hi).bfloat16().double()

    def dq_from(parts):
        return sum(torch.bmm(p, k) for p in parts).bfloat16()

    exact = _off(dq.bfloat16(), dq)
    assert _off(dq_from([hi, lo]), dq) <= 2 * exact
    once = _off(dq_from([hi]), dq)
    assert once > 10 * exact and once > 1e-2


@pytest.mark.cuda
def test_cuda_bf16_dq_shared_key(cuda_device):
    """The bf16 dq kernel on the case above: within 2x of the exact dq
    rounded once to bf16."""
    ref = _dq_shared_case(0)
    q, k, v, do = (t.to(cuda_device, torch.bfloat16) for t in ref)
    out, lse = flash_forward_reference(*ref[:3], False)
    delta = (ref[3] * out).sum(-1)
    dq = flash_backward_dq(q, k, v, do, lse.float().to(cuda_device),
                           delta.float().to(cuda_device), causal=False)
    r_dq = flash_backward_reference(*ref, lse, delta, False)[0]
    assert _off(dq.cpu(), r_dq) <= 2 * _off(r_dq.bfloat16(), r_dq)


# The forward's normalizer.  Values sharing a large component c (v_j = c +
# n_j) give O = c + a convex combination of the n_j: O - c is all that the
# keys decide.  P V divided by the sum of the same bf16(p) it multiplied
# keeps c exact; divided by the exact sum of p it leaks (sum bf16(p) - sum
# p) / sum p times c.  Errors are taken relative to ||O - c||.
# (chip_smoke.py holds the kernel to the same limit.)


def _o_shared_case(seed, BH=2, S=256, D=128, shared=64.0):
    rng = np.random.RandomState(seed)
    q = rng.randn(BH, S, D) * 0.3
    k = rng.randn(BH, S, D)
    c = shared * rng.randn(BH, 1, D)
    v = c + rng.randn(BH, S, D)
    return ([torch.from_numpy(a).bfloat16().double() for a in (q, k, v)],
            torch.from_numpy(c))


def _rounded_p(q, k):
    s = torch.bmm(q, k.transpose(1, 2)) / math.sqrt(q.shape[-1])
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return p, p.bfloat16().double()


def test_o_shared_value_case_separates_the_normalizer():
    """On the plain version: O from P rounded once to bf16 and divided by
    the sum of those rounded values is more than 10x closer to the exact O
    than the same P V divided by the exact sum of p."""
    (q, k, v), c = _o_shared_case(0)
    out = flash_forward_reference(q, k, v, False)[0]
    p, pb = _rounded_p(q, k)
    kept = torch.bmm(pb, v) / pb.sum(-1, keepdim=True)
    broken = torch.bmm(pb, v) / p.sum(-1, keepdim=True)
    kept_off, broken_off = _off(kept, out, out - c), _off(broken, out, out - c)
    assert kept_off < 1e-2
    assert broken_off > 10 * kept_off


@pytest.mark.cuda
def test_cuda_bf16_o_shared_value(cuda_device):
    """The bf16 forward's f32 O on the case above: within 2x of the error
    of P rounded once to bf16 (relative to ||O - c||)."""
    ref, c = _o_shared_case(0)
    q, k, v = (t.to(cuda_device, torch.bfloat16) for t in ref)
    o32 = _flash_forward(q, k, v, False, None, None, None, True)[2]
    out = flash_forward_reference(*ref, False)[0]
    _, pb = _rounded_p(*ref[:2])
    kept = torch.bmm(pb, ref[2]) / pb.sum(-1, keepdim=True)
    assert _off(o32.cpu(), out, out - c) <= 2 * _off(kept, out, out - c)
