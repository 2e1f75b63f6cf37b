#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one
nvcc per source, all started together), holds each against its plain
PyTorch version on the card, then drives the serving path — deferred-init
replica bring-up straight onto the GPU, continuous batching with paged
decode — and the training path — deferred init, materialization on the
card and ``make_train_step`` with the flash attention kernels — through
the entry points a user calls, and checks what comes out.  One JSON
object per line:

1. the device: name and power limit as nvidia-smi gives them, torch,
   CUDA and nvcc versions;
2. the paged-decode kernel against ``paged_attention_reference`` on the card: the 14
   cases of ``tests/test_paged_attention.py`` (float32 within 1e-5,
   bfloat16 within 3e-2, idle rows exactly zero) and full-width decode
   shapes (float32 within 1e-5, bfloat16 within two bf16 ulps) with
   their times: kernel, plain version, a library yardstick
   (``scaled_dot_product_attention`` over pre-gathered contiguous K/V,
   which the port never calls) and the bandwidth bound;
3. token-exact float32 serving of gpt2-125m (full size) and a 2-layer
   llama3-8b (full width) against the port's unbatched no-cache oracle,
   through a pool small enough to force preemption;
4. full-depth llama3-8b bf16 serving: bring-up seconds and host RSS
   growth while the 16 GB of parameters are materialized on the card,
   both in a fresh process (cold) and in this one (warm), decode
   tokens/s, and the kernel's launch count (32 per decode step);
5. the flash kernels (forward, dq, dk/dv) against
   ``flash_forward_reference`` / ``flash_backward_reference`` on the
   card: every bias-free case of ``tests/test_ops.py`` (float32 within
   1e-5, bfloat16 within 3e-2, relative above magnitude 1; rows that see
   no key exactly zero) and the
   llama3-8b and gpt2-125m training shapes in both dtypes (float32
   within 1e-5, bfloat16 within 1e-2 normwise) with their
   times: kernel, plain version, a library yardstick
   (``scaled_dot_product_attention`` forward and its autograd backward,
   which the port never calls) and the bound; lse within 1e-5 relative
   everywhere;
6. float32 training of gpt2-125m (full size), flash attention against
   ``default_attention`` on the same weights and batches: each step-0
   gradient leaf within 1e-4 normwise, the key biases' gradient (0 in
   exact arithmetic) below 1e-5 of the key weights', every step's loss
   within 1e-3, 12 x 3 launches of each flash kernel;
7. the training main path at llama3-8b width, 2 layers, bf16 compute:
   first-step latency (deferred_init -> materialize on the card ->
   train step -> first loss on the host) in a fresh process, host RSS
   growth, 5 losses below the first, step ms, tokens/s, MFU, peak device
   memory, 2 launches of each flash kernel per step, one step against
   the same model on ``default_attention`` (loss, gradient norm and each
   gradient leaf), and one step's device time by kernel under
   ``torch.profiler``;
8. the kernels line: per kernel its launches on the main path, its error
   against the plain version and its times at the main path's shapes;
9. last: ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when CUDA is unavailable, when run
from a directory without the port, or when any phase fails.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from torchdistx_tpu_torch import deferred_init, materialize_module
from torchdistx_tpu_torch.models import (
    LLAMA3_8B,
    PRESETS,
    make_gpt2,
    make_llama,
)
from torchdistx_tpu_torch.models.layers import default_attention
from torchdistx_tpu_torch.ops import _build
from torchdistx_tpu_torch.ops import make_flash_attention
from torchdistx_tpu_torch.ops import paged_attention, paged_attention_reference
from torchdistx_tpu_torch.ops.flash_attention import (
    flash_backward,
    flash_backward_dkv,
    flash_backward_dq,
    flash_backward_reference,
    flash_forward,
    flash_forward_reference,
    launches as flash_launches,
    reset_launches as reset_flash_launches,
)
from torchdistx_tpu_torch.parallel import make_train_step
from torchdistx_tpu_torch.parallel.train import (
    H100_PEAK_FLOPS,
    train_step_flops,
)
from torchdistx_tpu_torch.serve import (
    Request,
    ServeConfig,
    oracle_generate,
    spin_up_replica,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = H100_PEAK_FLOPS  # dense, no TF32
ATOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# The flash kernels' lse is float32 in both dtypes: the kernel and the
# plain version sum the same exact products of the same inputs in another
# order (measured about 1e-6).
LSE_RTOL = 1e-5
# bfloat16 flash outputs at the training shapes, normwise: the kernel
# rounds P and dS to bf16 for the tensor cores and every output once,
# the plain version rounds the output once (each rounding is 2**-9
# relative at most); a wrong tile, mask or fragment gives errors of
# order 1.
BF16_NORM_RTOL = 1e-2
SOURCES = ("paged_decode.cu", "flash_attention.cu")
KERNEL_SOURCE = "torchdistx_tpu_torch/ops/csrc/paged_decode.cu"
KERNEL_REPLACES = "torchdistx_tpu/ops/paged_attention.py:134 (_decode_kernel)"
FLASH_SOURCE = "torchdistx_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_fwd": "torchdistx_tpu/ops/flash_attention.py:91 (_fwd_kernel)",
    "flash_bwd_dq": "torchdistx_tpu/ops/flash_attention.py:206 (_bwd_dq_kernel)",
    "flash_bwd_dkv": "torchdistx_tpu/ops/flash_attention.py:257 (_bwd_dkv_kernel)",
}
# The training main path: llama3-8b width, depth cut to 2 layers, bf16
# compute on f32 parameters, a [2, 2048] batch.
TRAIN_CFG = LLAMA3_8B.replace(n_layers=2)
TRAIN_BATCH, TRAIN_SEQ = 2, 2048


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class L2Flush:
    """Overwrites a buffer larger than the 50 MB L2 between timed
    launches, so every launch reads its operands from device memory."""

    def __init__(self, device):
        self.buf = torch.empty(64 * 2**20, dtype=torch.float32, device=device)

    def __call__(self):
        self.buf.zero_()


def time_ms(fn, flush: L2Flush, iters: int = 20) -> float:
    """Median device time of ``fn`` over ``iters`` launches (CUDA events,
    cold L2)."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------


def rand_case(seed, *, B, H, KV, D, page, n_pages, maxp, lengths, dtype,
              device):
    """Inputs as tests/test_paged_attention.py builds them: a shuffled,
    non-overlapping page assignment that never maps the null page."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, H, D).astype(np.float32))
    kp = torch.from_numpy(rng.randn(n_pages, page, KV, D).astype(np.float32))
    vp = torch.from_numpy(rng.randn(n_pages, page, KV, D).astype(np.float32))
    perm = rng.permutation(n_pages - 1) + 1
    table = perm[: B * maxp].reshape(B, maxp).astype(np.int32)
    return (q.to(device, dtype), kp.to(device, dtype), vp.to(device, dtype),
            torch.tensor(lengths, dtype=torch.int32, device=device),
            torch.from_numpy(table).to(device))


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bfloat16 numbers at |x| (8 significand bits)."""
    e = torch.floor(torch.log2(x.abs().float().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def check_kernel(args, name: str, atol: float | None = None) -> float:
    """Kernel vs plain version on the same card inputs; idle rows must be
    exactly zero in the kernel and are excluded from the error.

    With ``atol`` None (the full-width and main-path shapes) a bfloat16
    output is held to two bf16 ulps of the plain value, floor 1e-5: both
    round an f32 result once, so they differ by at most one ulp.  A
    float32 output is held to 1e-5."""
    q, kp, vp, lens, table = args
    out = paged_attention(q, kp, vp, lens, table)
    ref = paged_attention_reference(q, kp, vp, lens, table)
    torch.cuda.synchronize()
    if out.dtype != q.dtype or out.shape != q.shape:
        raise AssertionError(f"{name}: output {out.dtype} {tuple(out.shape)}")
    live = lens > 0
    if not torch.all(out[~live] == 0):
        raise AssertionError(f"{name}: idle rows are not zero")
    diff = (out[live].float() - ref[live].float()).abs()
    if atol is not None:
        limit = torch.full_like(diff, atol)
    elif q.dtype == torch.bfloat16:
        limit = (2 * bf16_ulp(ref[live])).clamp_min(1e-5)
    else:
        limit = torch.full_like(diff, 1e-5)
    over = diff - limit
    if bool((over > 0).any()):
        i = int(over.argmax())
        raise AssertionError(
            f"{name}: |kernel - plain| {diff.flatten()[i].item()} > limit "
            f"{limit.flatten()[i].item()}")
    return diff.max().item()


def kernel_cases(dev) -> dict:
    """The 14 cases of tests/test_paged_attention.py, on the card."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for H, KV in ((4, 4), (4, 2), (8, 1)):
            B, D, page, maxp = 4, 16, 8, 3
            args = rand_case(0, B=B, H=H, KV=KV, D=D, page=page, n_pages=16,
                             maxp=maxp, lengths=[1, page * maxp, 7, 13],
                             dtype=dtype, device=dev)
            name = f"ragged-{str(dtype)[6:]}-H{H}KV{KV}"
            errs[name] = check_kernel(args, name, ATOL[dtype])
    for page in (4, 16):
        maxp = 4
        args = rand_case(1, B=3, H=4, KV=2, D=8, page=page, n_pages=32,
                         maxp=maxp, lengths=[page * maxp - 1, 2, page],
                         dtype=torch.float32, device=dev)
        errs[f"page-{page}"] = check_kernel(args, f"page-{page}", 1e-5)
    args = rand_case(2, B=2, H=4, KV=2, D=8, page=8, n_pages=8, maxp=2,
                     lengths=[0, 5], dtype=torch.float32, device=dev)
    errs["idle-lane"] = check_kernel(args, "idle-lane", 1e-5)
    for dtype in (torch.float32, torch.bfloat16):
        # Contiguous single-page layout: page b holds sequence b, full.
        B, S, H, KV, D = 3, 16, 4, 2, 16
        rng = np.random.RandomState(3)
        q = torch.from_numpy(rng.randn(B, H, D).astype(np.float32))
        k = torch.from_numpy(rng.randn(B, S, KV, D).astype(np.float32))
        v = torch.from_numpy(rng.randn(B, S, KV, D).astype(np.float32))
        args = (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
                torch.full((B,), S, dtype=torch.int32, device=dev),
                torch.arange(B, dtype=torch.int32, device=dev)[:, None])
        name = f"contiguous-{str(dtype)[6:]}"
        errs[name] = check_kernel(args, name, ATOL[dtype])
    # Ragged lengths against dense causal attention at the last position.
    from torchdistx_tpu_torch.models.layers import default_attention

    B, S, H, KV, D, page, maxp = 3, 24, 4, 2, 8, 8, 3
    lengths = [5, 24, 17]
    rng = np.random.RandomState(4)
    qf = torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32)).to(dev)
    k = torch.from_numpy(rng.randn(B, S, KV, D).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.randn(B, S, KV, D).astype(np.float32)).to(dev)
    kp = torch.zeros(1 + B * maxp, page, KV, D, device=dev)
    vp = torch.zeros_like(kp)
    table = torch.zeros(B, maxp, dtype=torch.int32, device=dev)
    for b in range(B):
        for j in range(maxp):
            pid = 1 + b * maxp + j
            table[b, j] = pid
            kp[pid] = k[b, j * page:(j + 1) * page]
            vp[pid] = v[b, j * page:(j + 1) * page]
    q_last = torch.stack([qf[b, L - 1] for b, L in enumerate(lengths)])
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    errs["dense-ragged"] = check_kernel((q_last, kp, vp, lens, table),
                                        "dense-ragged", 1e-5)
    out = paged_attention(q_last, kp, vp, lens, table)
    for b, L in enumerate(lengths):
        dense = default_attention(qf[b:b + 1, :L], k[b:b + 1, :L],
                                  v[b:b + 1, :L], causal=True)[0, -1]
        err = (out[b] - dense).abs().max().item()
        if not err <= 1e-5:
            raise AssertionError(f"dense-ragged lane {b}: {err}")
    args = rand_case(5, B=2, H=4, KV=2, D=8, page=4, n_pages=8, maxp=2,
                     lengths=[6, 8], dtype=torch.float32, device=dev)
    errs["gqa-grouping"] = check_kernel(args, "gqa-grouping", 1e-5)
    # Shape validation raises before anything launches.
    z = dict(device=dev)
    kp = torch.zeros(4, 8, 2, 8, **z)
    lens = torch.zeros(2, dtype=torch.int32, **z)
    table = torch.zeros(2, 2, dtype=torch.int32, **z)
    for bad_q, bad_table, what in (
        (torch.zeros(2, 3, 8, **z), table, "multiple of KV heads"),
        (torch.zeros(2, 4, 4, **z), table, "head_dim mismatch"),
        (torch.zeros(2, 4, 8, **z), torch.zeros(3, 2, dtype=torch.int32, **z),
         "batch mismatch"),
    ):
        try:
            paged_attention(bad_q, kp, kp, lens, bad_table)
        except ValueError as e:
            if what not in str(e):
                raise AssertionError(f"validation: {e!r} lacks {what!r}")
        else:
            raise AssertionError(f"validation: no error for {what!r}")
    errs["shape-validation"] = 0.0
    return errs


def decode_shape(dev, *, H, KV, D, page, lengths, dtype, seed=0, n_pages=None):
    """Random decode inputs at a given width with ragged ``lengths``."""
    B = len(lengths)
    maxp = max(-(-L // page) for L in lengths)
    if n_pages is None:
        n_pages = 1 + B * maxp
    return rand_case(seed, B=B, H=H, KV=KV, D=D, page=page, n_pages=n_pages,
                     maxp=maxp, lengths=lengths, dtype=dtype, device=dev)


def measure(args, flush: L2Flush) -> dict:
    """Kernel, plain and library times and the bound for one input set."""
    q, kp, vp, lens, table = args
    B, H, D = q.shape
    KV = kp.shape[2]
    page = kp.shape[1]
    T = table.shape[1] * page
    err = check_kernel(args, "timed")
    kernel_ms = time_ms(lambda: paged_attention(*args), flush)
    plain_ms = time_ms(lambda: paged_attention_reference(*args), flush)
    # Library yardstick: SDPA over K/V already gathered into contiguous
    # [B, H, T, D] (GQA heads expanded), lengths as a boolean mask.
    g = H // KV
    kc = kp[table.long()].reshape(B, T, KV, D).transpose(1, 2)
    vc = vp[table.long()].reshape(B, T, KV, D).transpose(1, 2)
    kc = kc.repeat_interleave(g, dim=1).contiguous()
    vc = vc.repeat_interleave(g, dim=1).contiguous()
    mask = (torch.arange(T, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask),
        flush)
    esz = q.element_size()
    live = int(lens.sum().item())
    nbytes = (2 * q.numel() * esz + 2 * live * KV * D * esz
              + lens.numel() * 4
              + sum(-(-int(L) // page) for L in lens.tolist()) * 4)
    flops = 4 * live * H * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return {
        "B": B, "H": H, "KV": KV, "D": D, "page": page,
        "dtype": str(q.dtype)[6:], "live_tokens": live,
        "max_abs_err": err, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "limit": ("2 bf16 ulps of |plain|, floor 1e-5"
                  if q.dtype == torch.bfloat16 else "1e-5"),
        "library_ms": library_ms,
        "library": "F.scaled_dot_product_attention over pre-gathered "
                   "contiguous K/V (a yardstick the port never calls)",
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }


def build_all() -> dict:
    """Every kernel source built at once, one nvcc each: seconds and the
    ptxas lines (registers, shared memory, spills) per source."""

    def one(source):
        t0 = time.perf_counter()
        so = _build.build(source)
        log = so.with_suffix(".log").read_text().splitlines()
        return {"build_s": time.perf_counter() - t0,
                "ptxas": [ln.strip() for ln in log
                          if "ptxas info" in ln or "spill" in ln]}

    with ThreadPoolExecutor(len(SOURCES)) as ex:
        futures = {src: ex.submit(one, src) for src in SOURCES}
    return {src: f.result() for src, f in futures.items()}


def phase_kernel(dev, flush, build: dict) -> None:
    emit({"phase": "kernel_cases", "kernel": "paged_decode", **build,
          "max_abs_err": kernel_cases(dev)})
    rng = np.random.RandomState(7)
    widths = {
        "llama3-8b": dict(H=32, KV=8, D=128, page=16,
                          lengths=[1] + rng.randint(2, 4097, 6).tolist()
                          + [4096]),
        "gpt2-125m": dict(H=12, KV=12, D=64, page=16,
                          lengths=[1] + rng.randint(2, 1025, 6).tolist()
                          + [1024]),
    }
    for model, shape in widths.items():
        for dtype in (torch.bfloat16, torch.float32):
            args = decode_shape(dev, dtype=dtype, **shape)
            emit({"phase": "kernel_full_width", "kernel": "paged_decode",
                  "model": model, **measure(args, flush)})
            del args


# ---------------------------------------------------------------------------
# phase 5: the flash kernels against their plain versions
# ---------------------------------------------------------------------------


def flash_case(seed, *, B, S, H, D, dtype, dev, T=None, KV=None):
    """q, k, v, do at the kernels' raw layout ([B*H, S, D], [B*KV, T, D]),
    from a numpy seed."""
    T = S if T is None else T
    KV = H if KV is None else KV
    rng = np.random.RandomState(seed)
    shapes = ((B * H, S, D), (B * KV, T, D), (B * KV, T, D), (B * H, S, D))
    return tuple(torch.from_numpy(rng.randn(*sh).astype(np.float32))
                 .to(dev, dtype) for sh in shapes)


def check_flash(args, name: str, *, causal: bool, atol: float,
                seg=None, normwise: bool = False) -> dict:
    """The three kernels against the plain versions on the same card
    inputs; the backward kernels get the plain forward's lse and delta, so
    each kernel is held on its own (the kernel's own lse is held to the
    plain one within LSE_RTOL, so the training backward, which reads it,
    sees the same input).  A float32 kernel is held against the plain
    versions evaluated in float64, the exact answer (two float32
    evaluations of sums of up to G * S = 8192 products, the dk/dv of
    llama3-8b width, differ from each other by more than 1e-5).

    lse, float32 in both dtypes, is held to |kernel - plain| <= LSE_RTOL *
    max(1, |plain|).  With ``normwise`` (bfloat16 at the training shapes)
    each other output is held to ||kernel - plain||_2 / ||plain||_2 <=
    BF16_NORM_RTOL; otherwise to |kernel - plain| <= atol * max(1,
    |plain|), absolute up to magnitude 1 and relative above it (the
    tests/test_ops.py band).  Rows that see no key must be exactly zero
    in the kernels (output and dq) with lse <= -1e29; they are left out
    of the error.  Returns max |kernel - plain| per output, the largest
    scaled error and the normwise error per output."""
    q, k, v, do = args
    ref = [t.double() for t in args] if q.dtype == torch.float32 else args
    out, lse = flash_forward(q, k, v, causal=causal, segment_ids=seg)
    r_out, r_lse = flash_forward_reference(*ref[:3], causal, seg)
    delta = (ref[3].to(r_lse.dtype) * r_out.to(r_lse.dtype)).sum(-1)
    dq, dk, dv = flash_backward(q, k, v, do, r_lse.float(), delta.float(),
                                causal=causal, segment_ids=seg)
    r_dq, r_dk, r_dv = flash_backward_reference(*ref, r_lse, delta, causal,
                                                seg)
    torch.cuda.synchronize()
    if out.dtype != q.dtype or out.shape != q.shape or lse.shape != q.shape[:2]:
        raise AssertionError(f"{name}: output {out.dtype} {tuple(out.shape)}")
    live = r_lse > -1e29
    if not (bool(torch.all(out[~live] == 0)) and bool(torch.all(dq[~live] == 0))
            and bool(torch.all(lse[~live] <= -1e29))):
        raise AssertionError(f"{name}: rows that see no key are not zero")
    errs, scaled, norm = {}, 0.0, {}
    for what, a, b in (("out", out[live], r_out[live]),
                       ("lse", lse[live], r_lse[live]),
                       ("dq", dq[live], r_dq[live]), ("dk", dk, r_dk),
                       ("dv", dv, r_dv)):
        if not a.numel():
            errs[what] = 0.0
            continue
        diff = (a.double() - b.double()).abs()
        rel = (diff / b.double().abs().clamp_min(1.0)).max().item()
        b_norm = b.double().norm().item()
        nrm = (diff.norm().item() / b_norm if b_norm
               else (0.0 if not diff.any() else math.inf))
        if what != "lse":
            norm[what] = nrm
        if what == "lse" and not rel <= LSE_RTOL:
            raise AssertionError(
                f"{name}: |kernel - plain| of lse is {rel} x max(1, |plain|)"
                f" > {LSE_RTOL}")
        if what != "lse" and normwise and not nrm <= BF16_NORM_RTOL:
            raise AssertionError(
                f"{name}: ||kernel - plain|| / ||plain|| of {what} is {nrm} "
                f"> {BF16_NORM_RTOL}")
        if what != "lse" and not normwise and not rel <= atol:
            raise AssertionError(
                f"{name}: |kernel - plain| of {what} is {rel} x max(1, "
                f"|plain|) > {atol}")
        errs[what] = diff.max().item()
        if what != "lse":
            scaled = max(scaled, rel)
    errs["scaled"] = scaled
    errs["normwise"] = norm
    return errs


def _segments(kind: str, B: int, dev):
    """The segment layouts of tests/test_ops.py."""
    def ids(*runs):
        row = np.concatenate([np.full(n, i, np.int32) for i, n in
                              enumerate(runs)])
        return torch.from_numpy(np.tile(row, (B, 1))).to(dev)

    if kind == "three":  # 3 documents packed into 50
        seg = ids(20, 18, 12)
        return seg, seg
    if kind == "halves":
        seg = ids(16, 16)
        return seg, seg
    return ids(12, 12), ids(25, 15)  # a cross-attention pair, S=24, T=40


FLASH_CASES = (  # name, shape, causal, segments
    ("matches-xla-causal", dict(B=2, S=64, H=4, D=16), True, None),
    ("matches-xla-full", dict(B=2, S=64, H=4, D=16), False, None),
    ("gqa-grouping", dict(B=1, S=32, H=8, KV=2, D=16), True, None),
    ("mqa", dict(B=1, S=32, H=8, KV=1, D=16), True, None),
    ("ragged-50-causal", dict(B=1, S=50, H=2, D=16), True, None),
    ("ragged-50-full", dict(B=1, S=50, H=2, D=16), False, None),
    ("cross-24x64-causal", dict(B=1, S=24, T=64, H=2, D=16), True, None),
    ("cross-24x64-full", dict(B=1, S=24, T=64, H=2, D=16), False, None),
    ("cross-64x24-causal-empty-rows", dict(B=1, S=64, T=24, H=2, D=16), True,
     None),
    ("bfloat16-32", dict(B=1, S=32, H=2, D=16), True, None),
    ("grads-48-causal", dict(B=1, S=48, H=2, D=16), True, None),
    ("grads-48-full", dict(B=1, S=48, H=2, D=16), False, None),
    ("grads-gqa", dict(B=1, S=32, H=4, KV=2, D=16), True, None),
    ("segments-causal", dict(B=2, S=50, H=4, D=16), True, "three"),
    ("segments-full", dict(B=2, S=50, H=4, D=16), False, "three"),
    ("segments-gqa", dict(B=2, S=32, H=4, KV=2, D=16), True, "halves"),
    ("segments-cross-pair", dict(B=1, S=24, T=40, H=2, D=16), False, "pair"),
    ("head-dim-32", dict(B=1, S=80, H=2, KV=1, D=32), True, None),
    ("head-dim-64", dict(B=1, S=80, H=2, KV=1, D=64), True, None),
    ("head-dim-128", dict(B=1, S=80, H=2, KV=1, D=128), True, None),
)


def flash_cases(dev) -> dict:
    """Every bias-free case of tests/test_ops.py in both dtypes (plus MQA,
    causal S > T, whose first rows see no key, and the other head dims),
    a TINY llama on the flash kernels against default_attention, and the
    wrapper's validation."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, causal, segs in FLASH_CASES:
            args = flash_case(0, dtype=dtype, dev=dev, **shape)
            seg = None if segs is None else _segments(segs, shape["B"], dev)
            tag = f"{name}-{str(dtype)[6:]}"
            errs[tag] = check_flash(args, tag, causal=causal, seg=seg,
                                    atol=ATOL[dtype])
    # A whole model on the kernels by constructor argument (f32 logits
    # within the 1e-4 the port's model tests use against flax).
    cfg = PRESETS["tiny"]
    torch.manual_seed(0)
    flash_model = make_llama(cfg, attn_fn=make_flash_attention(), device=dev)
    plain_model = make_llama(cfg, device=dev)
    plain_model.load_state_dict(flash_model.state_dict())
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 40))).to(dev)
    with torch.no_grad():
        err = (flash_model(toks) - plain_model(toks)).abs().max().item()
    if not err <= 1e-4:
        raise AssertionError(f"TINY llama on the flash kernels: logits {err}")
    errs["tiny-llama-logits"] = err
    # Validation raises before anything launches.
    z = dict(device=dev)
    q, kv = torch.zeros(1, 16, 8, 16, **z), torch.zeros(1, 16, 3, 16, **z)
    attn = make_flash_attention()
    for call, exc, what in (
        (lambda: attn(q, kv, kv), ValueError, "multiple of KV heads"),
        (lambda: attn(q, q, q, segment_ids=torch.zeros(1, 17, **z)),
         ValueError, "segment_ids must be"),
        (lambda: attn(q, q, q, bias=torch.zeros(8, 16, 16, **z)),
         NotImplementedError, "A9"),
        (lambda: attn(q[..., :8], q[..., :8], q[..., :8]), ValueError,
         "head_dim"),
    ):
        try:
            call()
        except exc as e:
            if what not in str(e):
                raise AssertionError(f"validation: {e!r} lacks {what!r}")
        else:
            raise AssertionError(f"validation: no error for {what!r}")
    errs["validation"] = 0.0
    return errs


FLASH_WIDTHS = {  # the training shapes: batch, sequence, heads, head dim
    "llama3-8b": dict(B=TRAIN_BATCH, S=TRAIN_SEQ, H=32, KV=8, D=128),
    "gpt2-125m": dict(B=4, S=1024, H=12, KV=12, D=64),
}


def flash_bound(name: str, *, B, S, H, KV, D, dtype) -> dict:
    """The least time of kernel ``name`` at a causal S x S shape: its own
    matrix-product flops over the visible (query, key) pairs over the
    dtype's peak, or the bytes it must move (each input read once, each
    output written once) over 3.35 TB/s, whichever is larger."""
    pairs = S * (S + 1) // 2
    esz = torch.empty((), dtype=dtype).element_size()
    qb, kb, rb = B * H * S * D * esz, B * KV * S * D * esz, B * H * S * 4
    products = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}[name]
    flops = 2 * products * B * H * D * pairs
    nbytes = {"flash_fwd": 2 * qb + 2 * kb + rb,  # q, k, v -> o, lse
              "flash_bwd_dq": 3 * qb + 2 * kb + 2 * rb,  # +do, delta -> dq
              "flash_bwd_dkv": 2 * qb + 4 * kb + 2 * rb}[name]  # -> dk, dv
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def measure_flash(dev, flush, model: str, dtype) -> dict:
    """Kernel, plain and library times and the bound of each flash kernel
    at a training shape (causal), after holding the kernels against the
    plain versions there."""
    shape = FLASH_WIDTHS[model]
    B, S, H, KV, D = (shape[k] for k in ("B", "S", "H", "KV", "D"))
    args = flash_case(11, dtype=dtype, dev=dev, **shape)
    bf16 = dtype == torch.bfloat16
    errs = check_flash(args, f"{model}-{str(dtype)[6:]}", causal=True,
                       atol=ATOL[dtype], normwise=bf16)
    q, k, v, do = args
    out, lse = flash_forward(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    kernel_ms = {
        "flash_fwd": time_ms(lambda: flash_forward(q, k, v), flush),
        "flash_bwd_dq": time_ms(
            lambda: flash_backward_dq(q, k, v, do, lse, delta), flush),
        "flash_bwd_dkv": time_ms(
            lambda: flash_backward_dkv(q, k, v, do, lse, delta), flush),
    }
    plain_fwd = time_ms(lambda: flash_forward_reference(q, k, v), flush, 5)
    plain_bwd = time_ms(
        lambda: flash_backward_reference(q, k, v, do, lse, delta), flush, 5)
    # Library yardstick: SDPA on [B, H, S, D] views (GQA by enable_gqa),
    # forward, and its autograd backward (dq, dk and dv in one call).
    q4, do4 = q.view(B, H, S, D), do.view(B, H, S, D)
    k4, v4 = k.view(B, KV, S, D), v.view(B, KV, S, D)

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, is_causal=True,
                                              enable_gqa=True)

    lib_fwd = time_ms(lambda: sdpa(q4, k4, v4), flush, 10)
    leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]
    o4 = sdpa(*leaves)
    lib_bwd = time_ms(lambda: torch.autograd.grad(o4, leaves, do4,
                                                  retain_graph=True), flush, 10)
    err = {"flash_fwd": max(errs["out"], errs["lse"]),  # absolute
           "flash_bwd_dq": errs["dq"],
           "flash_bwd_dkv": max(errs["dk"], errs["dv"])}
    kernels = {}
    for name in FLASH_REPLACES:
        kernels[name] = {
            "max_abs_err": err[name], "kernel_ms": kernel_ms[name],
            "plain_ms": plain_fwd if name == "flash_fwd" else plain_bwd,
            "library_ms": lib_fwd if name == "flash_fwd" else lib_bwd,
            **flash_bound(name, B=B, S=S, H=H, KV=KV, D=D, dtype=dtype)}
    return {"phase": "flash_full_width", "model": model,
            "dtype": str(dtype)[6:], "shape": shape, "causal": True,
            "limit": (f"||kernel - plain|| / ||plain|| <= {BF16_NORM_RTOL}"
                      if bf16 else f"{ATOL[dtype]} x max(1, |plain|)")
            + f"; lse {LSE_RTOL} x max(1, |plain|)",
            "max_abs_err": errs,
            "plain": "flash_forward_reference / flash_backward_reference "
                     "(the backward's plain version computes dq, dk and dv "
                     "in one call; its time stands for both kernels)",
            "library": "F.scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True) forward / its autograd backward "
                       "(a yardstick the port never calls)",
            "kernels": kernels}


def phase_flash_kernel(dev, flush, build: dict) -> dict:
    emit({"phase": "flash_kernel_cases", "kernel": "flash_attention", **build,
          "max_abs_err": flash_cases(dev)})
    rows = {}
    for model in FLASH_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            row = measure_flash(dev, flush, model, dtype)
            emit(row)
            rows[(model, row["dtype"])] = row
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving path
# ---------------------------------------------------------------------------


def staggered_requests(vocab: int, seed: int):
    rng = np.random.RandomState(seed)
    return [
        Request(f"r{i}", rng.randint(0, vocab, n).tolist(), max_new_tokens=m,
                arrival_step=i)
        for i, (n, m) in enumerate(((12, 10), (9, 12), (14, 8), (5, 11)))
    ]


def phase_exact_f32(dev) -> list:
    """Token-exact float32 serving against the unbatched no-cache oracle,
    with a pool too small for all lanes at once."""
    rows = []
    runs = (
        ("gpt2-125m", "gpt2", PRESETS["gpt2-125m"].replace(dtype=torch.float32)),
        ("llama3-8b@2-layers", "llama",
         LLAMA3_8B.replace(n_layers=2, dtype=torch.float32)),
    )
    scfg = ServeConfig(max_batch=4, page_size=16, n_pages=5)
    for name, family, cfg in runs:
        eng = spin_up_replica(cfg, family=family, serve_cfg=scfg, seed=0,
                              param_dtype=torch.float32, device=dev)
        reqs = staggered_requests(cfg.vocab_size, seed=11)
        paged_attention.launches = 0
        out = eng.run(reqs)
        torch.cuda.synchronize()
        launches = paged_attention.launches
        worst = 0.0
        for r in reqs:
            want, want_logits = oracle_generate(eng.model, r.tokens,
                                                r.max_new_tokens, r.eos_id)
            if out.get(r.rid) != want:
                raise AssertionError(
                    f"{name} {r.rid}: engine {out.get(r.rid)} != oracle {want}")
            err = float(np.abs(eng.final_logits[r.rid] - want_logits).max())
            worst = max(worst, err)
            if not err <= 1e-4:
                raise AssertionError(f"{name} {r.rid}: final logits off by {err}")
        if eng.preemptions < 1:
            raise AssertionError(f"{name}: the pool forced no preemption")
        if launches != cfg.n_layers * eng.decode_steps:
            raise AssertionError(
                f"{name}: {launches} kernel launches != {cfg.n_layers} "
                f"layers x {eng.decode_steps} decode steps")
        row = {"phase": "serve_f32_exact", "model": name,
               "requests": len(reqs), "token_exact": True,
               "max_final_logit_err": worst, "preemptions": eng.preemptions,
               "prefills": eng.prefills, "decode_steps": eng.decode_steps,
               "paged_decode_launches": launches,
               "bring_up_s": eng.bring_up_seconds}
        emit(row)
        rows.append(row)
        del eng
        torch.cuda.empty_cache()
    return rows


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class RssSampler:
    """Samples this process's resident set every few milliseconds."""

    def __init__(self, period_s: float = 0.005):
        self.period_s = period_s
        self.peak = _rss_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, _rss_bytes())
            time.sleep(self.period_s)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_bytes())


def profile_decode_ticks(eng, reqs, n_ticks: int = 3) -> dict:
    """Where a decode tick's time goes: ``torch.profiler`` over a few
    decode-only ticks of the same replica (after the measured run), the
    device kernels summed by name."""
    from torch.profiler import ProfilerActivity, profile

    for r in reqs:
        eng.submit(Request(r.rid + "-p", r.tokens, max_new_tokens=n_ticks + 2))
    eng.step()  # admission + prefill, not profiled
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_ticks):
            eng.step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / n_ticks
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append((us / 1e3 / n_ticks, evt.count / n_ticks, evt.key))
    kernels.sort(reverse=True)
    eng.run()  # finish the profiling requests
    return {"phase": "decode_tick_profile", "ticks": n_ticks,
            "tick_wall_ms": wall_ms,
            "device_kernel_ms_per_tick": sum(k[0] for k in kernels),
            "kernel_launches_per_tick": sum(k[1] for k in kernels),
            "top_kernels": [{"name": k[2][:90], "ms_per_tick": k[0],
                             "launches_per_tick": k[1]} for k in kernels[:8]]}


BF16_SERVE = ServeConfig(max_batch=4, page_size=16, n_pages=64)


def bring_up_bf16(dev):
    """Full-depth llama3-8b in bf16: fakes → materialize on the card.
    Returns the engine and its bring-up seconds and host RSS figures;
    fails if the RSS grew by a quarter of the parameter bytes or more."""
    rss0 = _rss_bytes()
    with RssSampler() as rss:
        eng = spin_up_replica("llama3-8b", param_dtype=torch.bfloat16,
                              serve_cfg=BF16_SERVE, seed=0, device=dev)
    param_bytes = sum(p.numel() * p.element_size()
                      for p in eng.model.parameters())
    growth = rss.peak - rss0
    if not growth < param_bytes / 4:
        raise AssertionError(
            f"host RSS grew {growth} bytes while materializing "
            f"{param_bytes} bytes of parameters")
    return eng, {"param_bytes": param_bytes,
                 "bring_up_s": eng.bring_up_seconds,
                 "host_rss_peak_bytes": rss.peak,
                 "host_rss_growth_bytes": growth}


def cold_bring_up() -> None:
    """``bring_up_bf16`` as the first CUDA work of a fresh process; prints
    its figures as one JSON line."""
    _, stats = bring_up_bf16(torch.device("cuda", 0))
    emit(stats)


def run_cold_bring_up() -> dict:
    """``cold_bring_up`` in a child process: bring-up there pays the CUDA
    context and library loads that a new replica pays.  The kernel's
    library is already built on disk by then."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = "import chip_smoke; chip_smoke.cold_bring_up()"
    proc = subprocess.run([sys.executable, "-c", code], cwd=here,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"cold bring-up exited {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_bf16_full(dev):
    """Full-depth llama3-8b in bf16: bring-up in a fresh process (cold)
    and in this one (warm: CUDA context, cuBLAS and the kernel library
    already loaded by the earlier phases), then 4 requests of 16 new
    tokens each through the warm replica."""
    cold = run_cold_bring_up()
    eng, warm = bring_up_bf16(dev)
    scfg = BF16_SERVE
    cfg = eng.cfg
    rng = np.random.RandomState(13)
    # Prompt lengths equal to prefill buckets: the prefill then runs the
    # same shapes as the oracle's forward.
    reqs = [Request(f"b{i}", rng.randint(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=16)
            for i, n in enumerate((16, 32, 8, 16))]
    for r in reqs:
        eng.submit(r)

    def emitted():
        return (sum(len(v) for v in eng.results.values())
                + sum(len(lane.generated) for lane in eng.active.values()))

    paged_attention.launches = 0
    decode_tokens, decode_s = 0, 0.0
    while eng.waiting or eng.active:
        prefills, before = eng.prefills, emitted()
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if eng.prefills == prefills:  # a decode-only tick
            decode_tokens += emitted() - before
            decode_s += dt
    launches = paged_attention.launches
    if set(eng.results) != {r.rid for r in reqs}:
        raise AssertionError(f"incomplete: {sorted(eng.results)}")
    if any(len(eng.results[r.rid]) != r.max_new_tokens for r in reqs):
        raise AssertionError("a request stopped short of its budget")
    if launches != cfg.n_layers * eng.decode_steps:
        raise AssertionError(
            f"{launches} kernel launches != {cfg.n_layers} layers x "
            f"{eng.decode_steps} decode steps")
    # bf16: batched decode and the unbatched oracle round differently, so
    # later tokens may drift apart; the first token (prefill vs the
    # oracle's forward at the same shape) must agree.
    for r in reqs:
        want, _ = oracle_generate(eng.model, r.tokens, 1)
        if eng.results[r.rid][0] != want[0]:
            raise AssertionError(
                f"{r.rid}: first token {eng.results[r.rid][0]} != oracle "
                f"{want[0]}")
    row = {"phase": "serve_bf16_full", "model": "llama3-8b",
           "n_layers": cfg.n_layers, "param_bytes": warm["param_bytes"],
           "bring_up_s_cold": cold["bring_up_s"],
           "host_rss_peak_bytes_cold": cold["host_rss_peak_bytes"],
           "host_rss_growth_bytes_cold": cold["host_rss_growth_bytes"],
           "bring_up_s_warm": warm["bring_up_s"],
           "host_rss_peak_bytes_warm": warm["host_rss_peak_bytes"],
           "host_rss_growth_bytes_warm": warm["host_rss_growth_bytes"],
           "requests_completed": len(eng.results),
           "decode_steps": eng.decode_steps,
           "decode_tokens_per_s": decode_tokens / decode_s,
           "paged_decode_launches": launches,
           "first_token_matches_oracle": True}
    emit(row)
    emit(profile_decode_ticks(eng, reqs))
    # The kernel's inputs at this path's decode shape: the engine's batch
    # and pool, each lane at its final context length.
    lengths = [len(r.tokens) + r.max_new_tokens - 1 for r in reqs]
    main_args = decode_shape(dev, H=cfg.n_heads, KV=cfg.kv_heads,
                             D=cfg.head_size, page=scfg.page_size,
                             lengths=lengths, dtype=torch.bfloat16,
                             n_pages=scfg.n_pages)
    del eng
    torch.cuda.empty_cache()
    return row, main_args


# ---------------------------------------------------------------------------
# phases 6 and 7: the training path
# ---------------------------------------------------------------------------

# Step-0 gradients, flash against plain attention, per leaf:
# ||flash - plain|| / ||plain||.  Both are f32 (no TF32) summed in another
# order through 12 layers' backward; a wrong dq, dk or dv moves its
# attention leaves by order 1.
F32_GRAD_RTOL = 1e-4
# The key biases' true gradient is 0 (softmax ignores a shift of a row's
# scores, so each row of dS sums to 0): what is left is rounding (measured
# 7e-8 on an H100), held to this fraction of the same layer's key-weight
# gradient.
F32_ZERO_GRAD_RTOL = 1e-5
F32_LOSS_ATOL = 1e-3  # the same sums, plus two AdamW updates (loss ~10.9)


def leaf_errors(names, got, want) -> dict:
    """||got - want|| / ||want|| per named gradient leaf (0 where both
    are exactly 0)."""
    errs = {}
    for name, a, b in zip(names, got, want):
        d = (a.double() - b.double()).norm().item()
        n = b.double().norm().item()
        errs[name] = d / n if n else (0.0 if d == 0 else math.inf)
    return errs


def phase_train_f32_exact(dev) -> dict:
    """gpt2-125m at full size, f32 compute: 3 steps of ``make_train_step``
    with the flash kernels and 3 with ``default_attention``, from the same
    materialized weights and the same numpy-seeded batches."""
    cfg = PRESETS["gpt2-125m"].replace(dtype=torch.float32)
    B, S, steps = 4, cfg.max_seq_len, 3  # S = 1024, the full context
    torch.manual_seed(0)
    flash_model = materialize_module(
        deferred_init(make_gpt2, cfg, attn_fn=make_flash_attention(),
                      device=dev), device=dev)
    plain_model = make_gpt2(cfg, device=dev)
    plain_model.load_state_dict(flash_model.state_dict())
    rng = np.random.RandomState(21)
    batches = [rng.randint(0, cfg.vocab_size, (B, S)) for _ in range(steps)]
    runs = {}
    for name, model in (("flash", flash_model), ("plain", plain_model)):
        init_state, train_step, shard_batch = make_train_step(model, cfg,
                                                              device=dev)
        state = init_state(model)
        reset_flash_launches()
        losses, grads0 = [], None
        t = time.perf_counter()
        for i, b in enumerate(batches):
            state, metrics = train_step(state, shard_batch(b))
            losses.append(float(metrics["loss"]))
            if i == 0:
                grads0 = [p.grad.clone() for p in state["params"]]
        torch.cuda.synchronize()
        runs[name] = {"losses": losses, "grads0": grads0,
                      "launches": dict(flash_launches),
                      "s_per_step": (time.perf_counter() - t) / steps}
        del state
    flash, plain = runs["flash"], runs["plain"]
    names = [n for n, _ in flash_model.named_parameters()]
    key_bias = {n for n in names if n.endswith("attn.wk.bias")}
    errs = leaf_errors(names, flash["grads0"], plain["grads0"])
    checked = {n: e for n, e in errs.items() if n not in key_bias}
    worst = max(checked, key=checked.get)
    worst_attn = max((n for n in checked if ".attn." in n), key=checked.get)
    grads = {run: dict(zip(names, runs[run]["grads0"])) for run in runs}
    zero_rel = max(
        grads[run][n].norm().item()
        / grads[run][n.replace("wk.bias", "wk.weight")].norm().item()
        for run in runs for n in key_bias)
    loss_diff = max(abs(a - b) for a, b in zip(flash["losses"],
                                               plain["losses"]))
    want = {k: cfg.n_layers * steps for k in flash_launches}
    if not all(math.isfinite(x) for x in flash["losses"] + plain["losses"]):
        raise AssertionError(f"non-finite loss: {flash['losses']} "
                             f"{plain['losses']}")
    if not checked[worst] <= F32_GRAD_RTOL:
        raise AssertionError(
            f"step-0 gradient of {worst} differs by {checked[worst]} "
            f"(normwise) > {F32_GRAD_RTOL}")
    if not (len(key_bias) == cfg.n_layers and zero_rel <= F32_ZERO_GRAD_RTOL):
        raise AssertionError(
            f"key-bias gradients {zero_rel} of the key weights' "
            f"> {F32_ZERO_GRAD_RTOL} ({len(key_bias)} leaves)")
    if not loss_diff <= F32_LOSS_ATOL:
        raise AssertionError(f"losses differ by {loss_diff}")
    if flash["launches"] != want or any(plain["launches"].values()):
        raise AssertionError(f"launches flash {flash['launches']} != {want}, "
                             f"plain {plain['launches']}")
    row = {"phase": "train_f32_exact", "model": "gpt2-125m", "dtype": "float32",
           "batch": [B, S], "steps": steps,
           "losses_flash": flash["losses"], "losses_plain": plain["losses"],
           "max_loss_diff": loss_diff, "loss_limit": F32_LOSS_ATOL,
           "grad_step0_worst_leaf": [worst, checked[worst]],
           "grad_step0_worst_attention_leaf": [worst_attn,
                                               checked[worst_attn]],
           "grad_step0_by_leaf": {
               n: errs[n] for n in names
               if not n.startswith("blocks.") or n.startswith("blocks.0.")},
           "grad_limit": f"||flash - plain|| / ||plain|| <= {F32_GRAD_RTOL} "
                         f"per leaf",
           "key_bias_grad_over_key_weight_grad": zero_rel,
           "key_bias_limit": F32_ZERO_GRAD_RTOL,
           "flash_launches": flash["launches"],
           "step_s_flash": flash["s_per_step"],
           "step_s_plain": plain["s_per_step"]}
    emit(row)
    del flash_model, plain_model, runs, flash, plain
    torch.cuda.empty_cache()
    return row


def train_batch() -> np.ndarray:
    return np.random.RandomState(31).randint(
        0, TRAIN_CFG.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))


def first_step(dev):
    """The training main path from nothing: deferred_init of 2-layer
    llama3-8b width with the flash kernels, materialize on the card,
    ``make_train_step``, one step; the clock runs from before
    ``deferred_init`` to the first loss on the host, and the host RSS is
    sampled throughout."""
    batch = train_batch()
    rss0 = _rss_bytes()
    with RssSampler() as rss:
        t0 = time.perf_counter()
        model = deferred_init(make_llama, TRAIN_CFG,
                              attn_fn=make_flash_attention(), device=dev)
        torch.manual_seed(0)
        materialize_module(model, device=dev)
        init_state, train_step, shard_batch = make_train_step(
            model, TRAIN_CFG, device=dev)
        state = init_state(model)
        torch.cuda.synchronize()
        bring_up = time.perf_counter() - t0
        state, metrics = train_step(state, shard_batch(batch))
        loss = float(metrics["loss"])
        seconds = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state["params"])
    param_bytes = sum(p.numel() * p.element_size() for p in state["params"])
    growth = rss.peak - rss0
    if not growth < param_bytes / 4:
        raise AssertionError(
            f"host RSS grew {growth} bytes bringing up {param_bytes} bytes "
            f"of parameters")
    stats = {"first_step_s": seconds, "bring_up_s": bring_up,
             "first_loss": loss,
             "n_params": n_params, "param_bytes": param_bytes,
             "host_rss_peak_bytes": rss.peak, "host_rss_growth_bytes": growth}
    return state, train_step, shard_batch, stats


def cold_first_step() -> None:
    """``first_step`` as the first CUDA work of a fresh process; prints
    its figures as one JSON line."""
    *_, stats = first_step(torch.device("cuda", 0))
    emit(stats)


def run_cold_first_step() -> dict:
    """``cold_first_step`` in a child process (the kernel libraries are
    already built on disk by then)."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = "import chip_smoke; chip_smoke.cold_first_step()"
    proc = subprocess.run([sys.executable, "-c", code], cwd=here,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"cold first step exited {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def profile_train_step(state, train_step, batch) -> dict:
    """One more step under ``torch.profiler``: device time by kernel, and
    the flash kernels' share of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_step(state, batch)
        torch.cuda.synchronize()
    kernels = []
    for evt in prof.key_averages():
        # Device kernels only: a user annotation such as
        # "Optimizer.step#AdamW.step" spans kernels counted on their own.
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False) or "#" in evt.key):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append((us / 1e3, evt.count, evt.key))
    kernels.sort(reverse=True)
    total = sum(k[0] for k in kernels)
    by_kind: dict = {}
    for ms, _, name in kernels:
        kind = _kernel_kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    flash = by_kind.get("flash", 0.0)
    return {"phase": "train_step_profile", "device_ms": total,
            "kernel_launches": sum(k[1] for k in kernels),
            "flash_ms": flash, "flash_share": flash / total if total else None,
            "device_ms_by_kind": by_kind,
            "top_kernels": [{"name": k[2][:90], "ms": k[0], "launches": k[1]}
                            for k in kernels[:12]]}


def _kernel_kind(name: str) -> str:
    """A device kernel's kind, by its name."""
    low = name.lower()
    for kind, marks in (("flash", ("flash_",)),
                        ("gemm", ("nvjet", "gemm", "cutlass", "cublas")),
                        ("optimizer_and_grad_norm", ("adam", "multi_tensor_apply")),
                        ("copy_or_cast", ("copy",)),
                        ("reduction", ("reduce",)),
                        ("elementwise", ("elementwise",))):
        if any(m in low for m in marks):
            return kind
    return "other"


# The bf16 main path against the same step with default_attention (f32
# softmax, no rounding of P or dS) on the same weights and batch: the
# loss relative, the global gradient norm and each gradient leaf
# normwise.  Everything else in the step is the same bf16 math, so the
# difference is the kernels' bf16 rounding carried through 2 layers
# (measured on an H100: loss and norm 2e-5, the worst leaf 1.8e-2); a
# wrong dq, dk or dv moves its attention leaves by order 1.
BF16_LOSS_RTOL = 1e-3
BF16_GNORM_RTOL = 1e-3
BF16_GRAD_RTOL = 5e-2


def compare_plain_bf16(state, train_step, shard_batch, dev) -> dict:
    """One step of the main path (flash kernels) and one of the same
    model built with ``default_attention``, from the same weights on a
    fresh batch.  The plain model's update is SGD at rate 0: only the
    loss and the gradients are compared."""
    flash_model = state["model"]
    names = [n for n, _ in flash_model.named_parameters()]
    state["opt"].zero_grad(set_to_none=True)  # room for the plain model
    plain = make_llama(TRAIN_CFG, device=dev)
    plain.load_state_dict(flash_model.state_dict())
    p_init, p_step, _ = make_train_step(
        plain, TRAIN_CFG, device=dev,
        optimizer=lambda ps: torch.optim.SGD(ps, lr=0.0))
    batch = shard_batch(np.random.RandomState(32).randint(
        0, TRAIN_CFG.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)))
    p_state, p_metrics = p_step(p_init(plain), batch)
    p_grads = [p.grad for p in p_state["params"]]
    del p_state
    state, metrics = train_step(state, batch)
    grads = [p.grad for p in state["params"]]
    loss, p_loss = float(metrics["loss"]), float(p_metrics["loss"])
    gn, p_gn = float(metrics["grad_norm"]), float(p_metrics["grad_norm"])
    errs = leaf_errors(names, grads, p_grads)
    worst = max(errs, key=errs.get)
    worst_attn = max((n for n in errs if ".attn." in n), key=errs.get)
    del plain, p_grads, grads
    torch.cuda.empty_cache()
    loss_rel, gn_rel = abs(loss - p_loss) / abs(p_loss), abs(gn - p_gn) / p_gn
    if not loss_rel <= BF16_LOSS_RTOL:
        raise AssertionError(f"loss {loss} vs plain attention {p_loss}")
    if not gn_rel <= BF16_GNORM_RTOL:
        raise AssertionError(f"grad norm {gn} vs plain attention {p_gn}")
    if not errs[worst] <= BF16_GRAD_RTOL:
        raise AssertionError(
            f"gradient of {worst} differs from plain attention's by "
            f"{errs[worst]} (normwise) > {BF16_GRAD_RTOL}")
    return {"loss_flash": loss, "loss_plain": p_loss, "loss_rel_diff": loss_rel,
            "loss_limit": BF16_LOSS_RTOL,
            "grad_norm_flash": gn, "grad_norm_plain": p_gn,
            "grad_norm_rel_diff": gn_rel, "grad_norm_limit": BF16_GNORM_RTOL,
            "grad_worst_leaf": [worst, errs[worst]],
            "grad_worst_attention_leaf": [worst_attn, errs[worst_attn]],
            "grad_by_leaf": errs,
            "grad_limit": f"||flash - plain|| / ||plain|| <= {BF16_GRAD_RTOL} "
                          f"per leaf"}


def phase_train_bf16_full(dev) -> dict:
    """The training main path at llama3-8b width with 2 layers, bf16
    compute: the first step cold (a fresh process) and warm (this one),
    then 4 more steps on the same batch — losses finite and falling — with
    the step time, throughput, MFU, peak device memory and the flash
    kernels' launches (2 layers x 1 per step each), then one step against
    ``default_attention`` on the same weights and one profiled step."""
    torch.cuda.empty_cache()
    cold = run_cold_first_step()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_launches()
    state, train_step, shard_batch, warm = first_step(dev)
    batch = shard_batch(train_batch())
    losses, step_s = [warm["first_loss"]], []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t)
    launches = dict(flash_launches)
    peak = torch.cuda.max_memory_allocated()
    grad_norm = float(metrics["grad_norm"])
    want = {k: TRAIN_CFG.n_layers * len(losses) for k in flash_launches}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    # Falling: every later step ends below the first.  The repeated batch
    # is memorised within a few steps, after which AdamW at 3e-4 may
    # overshoot a little, so step-to-step order is not required.
    if not all(x < losses[0] for x in losses[1:]):
        raise AssertionError(f"losses do not fall: {losses}")
    if launches != want:
        raise AssertionError(f"flash launches {launches} != {want}")
    vs_plain = compare_plain_bf16(state, train_step, shard_batch, dev)
    step = float(np.median(step_s))
    flops = train_step_flops(state["model"], TRAIN_CFG, TRAIN_BATCH, TRAIN_SEQ)
    row = {"phase": "train_bf16_full", "model": "llama3-8b",
           "n_layers": TRAIN_CFG.n_layers, "dtype": "bfloat16 compute, "
           "float32 parameters", "batch": [TRAIN_BATCH, TRAIN_SEQ],
           "n_params": warm["n_params"], "param_bytes": warm["param_bytes"],
           "first_step_s_cold": cold["first_step_s"],
           "bring_up_s_cold": cold["bring_up_s"],
           "host_rss_growth_bytes_cold": cold["host_rss_growth_bytes"],
           "host_rss_peak_bytes_cold": cold["host_rss_peak_bytes"],
           "first_step_s_warm": warm["first_step_s"],
           "bring_up_s_warm": warm["bring_up_s"],
           "host_rss_growth_bytes_warm": warm["host_rss_growth_bytes"],
           "losses": losses, "last_grad_norm": grad_norm,
           "step_ms": step * 1e3, "step_ms_samples": [x * 1e3 for x in step_s],
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step,
           "flops_per_step": flops,
           "flops_formula": "6 x matmul weights x tokens + 6 x L x B x H x "
                            "S^2 x D (causal attention, fwd + bwd)",
           "mfu": flops / step / PEAK_FLOPS[torch.bfloat16],
           "max_memory_allocated_bytes": peak, "flash_launches": launches,
           "vs_default_attention": vs_plain}
    emit(row)
    emit(profile_train_step(state, train_step, batch))
    del state
    torch.cuda.empty_cache()
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    nvcc_version = subprocess.run(
        [_build.nvcc_path(), "--version"], capture_output=True, text=True,
    ).stdout.strip().splitlines()
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "nvcc": nvcc_version[-1] if nvcc_version else None})
    flush = L2Flush(dev)
    failures = []
    main_row, main_args = None, None

    def run(name, fn, *a):
        try:
            return fn(*a)
        except Exception as e:  # noqa: BLE001 — report, run the rest, exit 1
            traceback.print_exc()
            emit({"phase": name, "ok": False,
                  "error": f"{type(e).__name__}: {e}"[:500]})
            failures.append(name)
            return None

    builds = run("build", build_all) or {}
    run("kernel", phase_kernel, dev, flush, builds.get("paged_decode.cu", {}))
    flash_rows = run("flash_kernel", phase_flash_kernel, dev, flush,
                     builds.get("flash_attention.cu", {}))
    run("serve_f32_exact", phase_exact_f32, dev)
    res = run("serve_bf16_full", phase_bf16_full, dev)
    if res is not None:
        main_row, main_args = res
    run("train_f32_exact", phase_train_f32_exact, dev)
    train_row = run("train_bf16_full", phase_train_bf16_full, dev)
    if failures:
        return 1
    timing = run("kernels_line", measure, main_args, flush)
    if timing is None:
        return 1
    print(f"device: {smi}", flush=True)
    kernels = [{
        "name": "paged_decode", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": main_row["paged_decode_launches"],
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["kernel_ms"], "kernel_ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": timing["library_ms"],
        "shape": {k: timing[k] for k in ("B", "H", "KV", "D", "page", "dtype",
                                         "live_tokens")},
    }]
    # The flash kernels at the training main path's shape (llama3-8b
    # width, [2, 2048], bf16), launches from its 5-step run.
    main_flash = flash_rows[("llama3-8b", "bfloat16")]
    for name, replaces in FLASH_REPLACES.items():
        k = main_flash["kernels"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": replaces, "launches": train_row["flash_launches"][name],
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
            "kernel_ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
            "shape": {**main_flash["shape"], "dtype": main_flash["dtype"],
                      "causal": True},
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
