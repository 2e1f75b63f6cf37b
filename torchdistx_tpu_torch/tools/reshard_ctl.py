"""Replan a committed checkpoint onto a new mesh topology, offline (the
port's counterpart of the JAX package's ``tools/reshard_ctl.py``).

The fleet-ops companion of :mod:`torchdistx_tpu_torch.reshard`: a
checkpoint written under sharding plan A / mesh A is rewritten under
plan B / mesh B — parameters AND optimizer state — as a streaming
rechunk-copy that never holds a whole leaf on the host (chunk budget
``--chunk-mb`` / ``TDX_RESHARD_CHUNK_MB``).

Subcommands (all print one JSON summary line last on stdout;
human-readable detail goes to stderr)::

    python -m torchdistx_tpu_torch.tools.reshard_ctl plan   CKPT --mesh fsdp=2,tp=2 --plan gspmd2d
    python -m torchdistx_tpu_torch.tools.reshard_ctl apply  CKPT [DST] --mesh fsdp=2,tp=2 --plan gspmd2d
    python -m torchdistx_tpu_torch.tools.reshard_ctl verify CKPT DST

* ``plan`` — the dry run: compute and print the per-leaf transfer
  schedule (source/target specs, block and chunk counts, byte totals)
  without writing anything.  Exit 0 if the plan is computable.
* ``apply`` — execute the plan into ``DST`` (default:
  ``<CKPT>.reshard-<digest>``), bitwise-verify the destination
  leaf-by-leaf against the source, then write its manifest.  A failed
  apply removes the partial destination, leaves the source untouched,
  and exits 1 (degrade-never-corrupt).
* ``verify`` — re-run the streaming bitwise comparison between an
  existing source/destination pair.  Exit 0 iff every leaf matches.

The target mesh is named on the command line; no GPU is needed: an
offline reshard is host-side file I/O.  ``--plan`` picks the target
layout rule: ``replicated`` (every leaf whole on every device), ``fsdp``
(largest dim over the first mesh axis) or ``gspmd2d`` (two largest dims
over the first two mesh axes).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _parse_mesh(text: str) -> dict:
    """``"fsdp=2,tp=2"`` -> ``{"fsdp": 2, "tp": 2}`` (ordered)."""
    axes = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise SystemExit(
                f"--mesh expects comma-separated axis=size pairs "
                f"(e.g. fsdp=2,tp=2), got {part!r}"
            )
        name, _, size = part.partition("=")
        try:
            axes[name.strip()] = int(size)
        except ValueError:
            raise SystemExit(f"--mesh axis {name!r} has non-integer size {size!r}")
    if not axes:
        raise SystemExit("--mesh must name at least one axis")
    return axes


def _build_plan(kind: str, mesh_axes: dict, min_size: int):
    from ..parallel import sharding as shlib

    names = list(mesh_axes)
    if kind == "replicated":
        return shlib.ShardingPlan()
    if kind == "fsdp":
        return shlib.fsdp_plan(axis=names[0], min_size=min_size)
    if kind == "gspmd2d":
        if len(names) < 2:
            raise SystemExit(
                f"--plan gspmd2d needs a 2D --mesh (two axes), got {names}"
            )
        return shlib.gspmd_2d_plan(axes=(names[0], names[1]), min_size=min_size)
    raise SystemExit(f"unknown --plan {kind!r}")


def _emit(payload: dict) -> None:
    print(json.dumps(payload, sort_keys=True))


def cmd_plan(args) -> int:
    from .. import reshard

    mesh_axes = _parse_mesh(args.mesh)
    plan_b = _build_plan(args.plan, mesh_axes, args.min_size)
    try:
        pl = reshard.plan_reshard(args.ckpt, plan_b,
                                  reshard.MeshSpec(mesh_axes),
                                  chunk_mb=args.chunk_mb)
    except reshard.ReshardError as e:
        print(f"plan failed: {e}", file=sys.stderr)
        _emit({"ok": False, "error": str(e)})
        return 1
    print(pl.describe(), file=sys.stderr)
    _emit({
        "ok": True,
        "src": str(args.ckpt),
        "src_digest": pl.src_digest,
        "dst_digest": pl.dst_digest,
        "leaves": len(pl.leaves),
        "chunks": pl.total_chunks,
        "bytes_total": pl.total_bytes,
        "bytes_moved": pl.moved_bytes,
    })
    return 0


def cmd_apply(args) -> int:
    from .. import reshard

    mesh_axes = _parse_mesh(args.mesh)
    plan_b = _build_plan(args.plan, mesh_axes, args.min_size)
    t0 = time.perf_counter()
    try:
        dst = reshard.reshard_checkpoint(
            args.ckpt, plan_b, reshard.MeshSpec(mesh_axes), args.dst,
            chunk_mb=args.chunk_mb, verify=not args.no_verify,
        )
    except reshard.ReshardError as e:
        print(f"apply failed (source untouched): {e}", file=sys.stderr)
        _emit({"ok": False, "error": str(e)})
        return 1
    print(f"resharded {args.ckpt} -> {dst}", file=sys.stderr)
    _emit({
        "ok": True,
        "src": str(args.ckpt),
        "dst": str(dst),
        "peak_host_bytes": reshard.last_transfer_peak_bytes(),
        "seconds": time.perf_counter() - t0,
    })
    return 0


def cmd_verify(args) -> int:
    from .. import reshard

    ok, reason = reshard.verify_reshard(args.ckpt, args.dst,
                                        chunk_mb=args.chunk_mb)
    print(f"verify: {'ok' if ok else reason}", file=sys.stderr)
    _emit({"ok": bool(ok), "reason": reason, "src": str(args.ckpt),
           "dst": str(args.dst)})
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="reshard_ctl",
        description="offline checkpoint resharding (plan / apply / verify)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    def _common(p, mesh_required: bool) -> None:
        p.add_argument("ckpt", help="committed source checkpoint directory")
        if mesh_required:
            p.add_argument("--mesh", required=True,
                           help="target mesh axes, e.g. fsdp=2,tp=2")
            p.add_argument("--plan", default="fsdp",
                           choices=("replicated", "fsdp", "gspmd2d"),
                           help="target layout rule (default: fsdp)")
            p.add_argument("--min-size", type=int, default=0,
                           help="leaves under this element count replicate "
                                "(default 0: relayout everything)")
        p.add_argument("--chunk-mb", type=float, default=None,
                       help="host staging budget per chunk in MiB "
                            "(default: TDX_RESHARD_CHUNK_MB)")

    p = sub.add_parser("plan", help="dry run: print the transfer schedule")
    _common(p, mesh_required=True)
    p.set_defaults(fn=cmd_plan)

    p = sub.add_parser("apply", help="execute the reshard into DST")
    _common(p, mesh_required=True)
    p.add_argument("dst", nargs="?", default=None,
                   help="destination directory (default: "
                        "<ckpt>.reshard-<digest>)")
    p.add_argument("--no-verify", action="store_true",
                   help="skip the post-copy bitwise verification (not "
                        "recommended)")
    p.set_defaults(fn=cmd_apply)

    p = sub.add_parser("verify", help="bitwise-compare SRC against DST")
    _common(p, mesh_required=False)
    p.add_argument("dst", help="resharded destination directory")
    p.set_defaults(fn=cmd_verify)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
