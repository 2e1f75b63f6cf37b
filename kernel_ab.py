"""Times one hand-written kernel of one tree of this repo, for an A/B of two
trees on one card.

    python3 kernel_ab.py flash --tree . --label change
    python3 kernel_ab.py keyed --tree <a checkout of the parent> --label parent
    python3 kernel_ab.py keyed --tree <tree> --label <x> --bring-up
    python3 kernel_ab.py compare <file holding the keyed runs' JSON lines>

Each run imports ``torchdistx_tpu_torch`` from ``--tree`` (whose kernels
build from that tree's ``ops/csrc/`` into its own ``_build/``) and prints
one JSON line with the card's name and power limit and the build's ptxas
report of the kernels it times (registers, stack frame, spills).  Times
are each kernel's median device time over 20 launches with L2 flushed
before each (CUDA events).  Run the trees alternately (change, parent,
parent, change) in one call and compare only within it.

``flash``: the bf16 flash forward (B1) and dk/dv (B3) at the training
main path's llama shape (B 2, S = T = 2048, H 32, KV 8, D 128, causal)
and at T5-11B's encoder shape (B 8, S = T = 512, H 128, D 128, an f32
[H, S, T] bias, not causal), each with the error of its bf16 result
normwise against an f64 evaluation of the plain version on the same
inputs (O for the forward; dK and dV for dk/dv).

``keyed``: the keyed draws (``keyed_rng_kernel``).  A SHA-256 of every
output of ``keyed_fill_`` over a set of cases — uniform and normal in
f32, bf16 and f16 over a [4, 1000, 1037] tensor, eight regions of it
(five with a global base that is not a multiple of 4, or runs starting
at other lanes), a region of a [2, 2**34] tensor past 2**32 blocks, and
Mixtral 8x7B's expert stack [8, 4096, 14336] in f32 and bf16 — and at
the expert stack each kind's time beside ``Tensor.normal_`` /
``uniform_`` (torch's CUDA generator, a yardstick) and the bound (bytes
written over 3.35 TB/s).  ``--bring-up`` instead brings up one
full-depth llama3-8b bf16 serving replica (``spin_up_replica``, seed 0)
in this fresh process, its kernel libraries built first, and prints its
``bring_up_seconds`` and the keyed draws' launches.  ``compare`` exits 1
unless every keyed case's digest is the same in every run, and prints
each label's times.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12


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


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()


def _ptxas_table():
    """This checkout's ptxas parser (``ops/ptxas.py``, which imports
    nothing of the package), loaded by path so that it reads the log of
    any ``--tree``'s build."""
    path = (Path(__file__).resolve().parent / "torchdistx_tpu_torch" / "ops"
            / "ptxas.py")
    spec = importlib.util.spec_from_file_location("kernel_ab_ptxas", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ptxas_table


def ptxas(build, source: str, pattern: str) -> dict:
    """The ptxas report of ``source``'s library (built by ``build``, the
    tree's ``ops._build``) for the entry functions whose mangled name
    matches ``pattern`` (its first group names them)."""
    log = build.library_path(source).with_suffix(".log")
    out = {}
    for fn, row in _ptxas_table()(log.read_text().splitlines()).items():
        m = re.search(pattern, fn)
        if m:
            out[m.group(1)] = row
    return out


# --- flash --------------------------------------------------------------

FLASH_SHAPES = {
    "llama": dict(B=2, S=2048, T=2048, H=32, KV=8, D=128, causal=True,
                  bias=False),
    "t5-encoder": dict(B=8, S=512, T=512, H=128, KV=128, D=128, causal=False,
                       bias=True),
}


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b).norm() / b.norm())


def flash(label: str, tree: str) -> dict:
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
    out = {"label": label, "tree": tree, "card": card(),
           "source": str(_build.CSRC / "flash_attention.cu"), "shapes": {}}
    for name, sh in FLASH_SHAPES.items():
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
    out["ptxas"] = ptxas(_build, "flash_attention.cu",
                         r"(flash_(?:fwd|dkv)_bf16_kernelI(?:Li\d+E)+)")
    return out


# --- keyed --------------------------------------------------------------

KEY = 0x5DEECE66D
PARAMS = {"uniform": (-0.95, 0.95), "normal": (0.0, 0.02)}
FULL = (4, 1000, 1037)
REGIONS = (((1, 3, 5), (2, 500, 1000)), ((0, 0, 0), FULL),
           ((2, 0, 0), (1, 1000, 1037)), ((3, 999, 1036), (1, 1, 1)),
           ((0, 7, 0), (4, 13, 1037)), ((0, 0, 1), (4, 1000, 1036)),
           ((2, 5, 0), (1, 995, 1037)), ((3, 0, 7), (1, 1, 1000)))
WIDE = ((2, 2 ** 34), (1, 2 ** 33 - 3), (1, 2 ** 20))
EXPERTS = (8, 4096, 14336)


def digest(t: torch.Tensor) -> str:
    raw = t.contiguous().view({2: torch.int16, 4: torch.int32}[
        t.element_size()]).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()


def keyed(label: str, tree: str) -> dict:
    from torchdistx_tpu_torch.ops import _build, keyed_rng

    dev = torch.device("cuda", 0)
    _build.build(keyed_rng.SOURCE)
    out = {"label": label, "tree": tree, "card": card(),
           "source": str(_build.CSRC / keyed_rng.SOURCE),
           "ptxas": ptxas(_build, keyed_rng.SOURCE,
                          r"keyed_rng_kernelI(\w+?)EEv"),
           "digests": {}, "timing": {}}
    cases = [(FULL, s, shape) for s, shape in REGIONS] + [WIDE]
    for dtype in keyed_rng.DTYPES:
        for kind, (a, b) in PARAMS.items():
            for full, start, shape in cases:
                t = keyed_rng.keyed_fill_(
                    torch.empty(shape, dtype=dtype, device=dev), kind, a, b,
                    KEY, full, start)
                out["digests"][f"{kind} {str(dtype)[6:]} {full} {start} "
                               f"{shape}"] = digest(t)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.empty(EXPERTS, dtype=dtype, device=dev)
        for kind, (a, b) in PARAMS.items():
            keyed_rng.keyed_fill_(buf, kind, a, b, KEY)
            name = f"{kind} {str(dtype)[6:]} {EXPERTS}"
            out["digests"][name] = digest(buf)
            library = getattr(buf, f"{kind}_")
            out["timing"][name] = {
                "ms": time_ms(lambda: keyed_rng.keyed_fill_(buf, kind, a, b,
                                                            KEY), flush),
                "library_ms": time_ms(lambda: library(a, b), flush),
                "bound_ms": buf.numel() * buf.element_size()
                / HBM_BYTES_PER_S * 1e3}
        del buf
        torch.cuda.empty_cache()
    return out


def bring_up(label: str, tree: str) -> dict:
    from torchdistx_tpu_torch.ops import _build, keyed_rng
    from torchdistx_tpu_torch.registry.scheduler import path_sources
    from torchdistx_tpu_torch.serve import ServeConfig, spin_up_replica

    for source in path_sources("serve"):
        _build.build(source)
    keyed_rng.launches = 0
    eng = spin_up_replica("llama3-8b", param_dtype=torch.bfloat16, seed=0,
                          serve_cfg=ServeConfig(max_batch=4, page_size=16,
                                                n_pages=64,
                                                spec_decode=False),
                          device="cuda")
    return {"label": label, "tree": tree, "card": card(),
            "bring_up_s": eng.bring_up_seconds,
            "capture_s": eng.capture_seconds,
            "keyed_rng_launches": keyed_rng.launches}


def compare(path: str) -> int:
    runs = [json.loads(ln) for ln in open(path)
            if ln.startswith("{") and '"digests"' in ln]
    if len(runs) < 2:
        print(f"kernel_ab: {len(runs)} keyed runs in {path}", file=sys.stderr)
        return 1
    differ = sorted(k for k in runs[0]["digests"]
                    if len({r["digests"].get(k) for r in runs}) != 1)
    print(json.dumps({
        "runs": [r["label"] for r in runs], "cards": [r["card"] for r in runs],
        "cases": len(runs[0]["digests"]), "cases_differing": differ,
        "ms": {k: [r["timing"][k]["ms"] for r in runs]
               for k in runs[0]["timing"]},
        "library_ms": {k: [r["timing"][k]["library_ms"] for r in runs]
                       for k in runs[0]["timing"]}}))
    return 1 if differ else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("kernel", choices=("flash", "keyed", "compare"))
    ap.add_argument("path", nargs="?", help="compare: the runs' output")
    ap.add_argument("--tree", default=".")
    ap.add_argument("--label", default="change")
    ap.add_argument("--bring-up", action="store_true")
    args = ap.parse_args()
    if args.kernel == "compare":
        return compare(args.path)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.tree)
    fn = {"flash": flash, "keyed": bring_up if args.bring_up else keyed}[
        args.kernel]
    print(json.dumps(fn(args.label, args.tree)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
