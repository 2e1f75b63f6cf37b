"""Times the bf16 flash forward (B1) and dk/dv (B3) kernels of one tree of
this repo, for an A/B of two trees on one card.

    python3 flash_ab.py --tree . --label change
    python3 flash_ab.py --tree <a checkout of the parent> --label parent

imports ``torchdistx_tpu_torch`` from ``--tree`` (whose kernels build from
that tree's ``ops/csrc/flash_attention.cu`` into its own ``_build/``) and
prints one JSON line: at the training main path's llama shape (B 2, S =
T = 2048, H 32, KV 8, D 128, causal) and at T5-11B's encoder shape (B 8,
S = T = 512, H 128, D 128, an f32 [H, S, T] bias, not causal), bf16,
each kernel's median device time over 20 launches with L2 flushed before
each (CUDA events), and the error of its bf16 result normwise against an
f64 evaluation of the plain version on the same inputs (O for the
forward; dK and dV for dk/dv), which shows what the rounding of P costs;
the build's ptxas register and spill lines of the two kernels.  Run the
trees alternately (change, parent, parent, change) in one call and
compare only within it.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import numpy as np
import torch

SHAPES = {
    "llama": dict(B=2, S=2048, T=2048, H=32, KV=8, D=128, causal=True,
                  bias=False),
    "t5-encoder": dict(B=8, S=512, T=512, H=128, KV=128, D=128, causal=False,
                       bias=True),
}


def time_ms(fn, flush: torch.Tensor, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b).norm() / b.norm())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=".")
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.tree)
    from torchdistx_tpu_torch.ops import _build
    from torchdistx_tpu_torch.ops.flash_attention import (
        flash_backward_dkv,
        flash_backward_reference,
        flash_forward,
        flash_forward_reference,
    )

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    out = {"label": args.label, "tree": args.tree,
           "source": str(_build.CSRC / "flash_attention.cu"),
           "card": torch.cuda.get_device_name(0), "shapes": {}}
    for name, sh in SHAPES.items():
        B, S, T, H, KV, D = (sh[k] for k in ("B", "S", "T", "H", "KV", "D"))
        rng = np.random.RandomState(11)
        q, k, v, do = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                       .to(dev, torch.bfloat16)
                       for s in ((B * H, S, D), (B * KV, T, D), (B * KV, T, D),
                                 (B * H, S, D)))
        bias = None
        if sh["bias"]:
            bias = torch.from_numpy(np.random.RandomState(19).randn(
                H, S, T).astype(np.float32)).to(dev)
        kw = dict(causal=sh["causal"], bias=bias,
                  heads=H if bias is not None else None)
        o, lse = flash_forward(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1)
        ms = {"flash_fwd": time_ms(lambda: flash_forward(q, k, v, **kw),
                                   flush),
              "flash_bwd_dkv": time_ms(lambda: flash_backward_dkv(
                  q, k, v, do, lse, delta, **kw), flush)}
        dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, **kw)
        x64 = [t.double() for t in (q, k, v, do)]
        b64 = None if bias is None else bias.double()
        o64, lse64 = flash_forward_reference(*x64[:3], sh["causal"], None,
                                             b64, kw["heads"])
        delta64 = (x64[3] * o64).sum(-1)
        dk64, dv64 = flash_backward_reference(
            *x64, lse64, delta64, sh["causal"], None, b64, kw["heads"])[1:3]
        out["shapes"][name] = {
            **sh, "dtype": "bfloat16", "ms": ms,
            "vs_f64_normwise": {"out": rel(o, o64), "dk": rel(dk, dk64),
                                "dv": rel(dv, dv64)}}
        del x64, o64, dk64, dv64
        torch.cuda.empty_cache()
    log = _build.library_path("flash_attention.cu").with_suffix(".log")
    lines, fn = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        elif fn and ("flash_fwd_bf16" in fn or "flash_dkv_bf16" in fn) and (
                "registers" in line or "spill" in line):
            lines.append(f"{fn}: {line.strip()}")
    out["ptxas"] = lines
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
