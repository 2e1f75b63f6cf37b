"""Warm a local kernel cache, and a shared artifact registry, with the
kernel libraries a path launches (the port's counterpart of the JAX
package's ``tools/warm_cache.py``).

The port's only compiled artifacts are its nvcc-built kernel libraries
(:mod:`torchdistx_tpu_torch.ops._build`): the training path launches the
flash kernels, the serving path paged decode.  A login host (or the
first host of a fleet) builds them into ``--cache-dir`` and publishes
them to ``--registry-dir``; a replica or trainer started later with
``TDX_CACHE_DIR`` / ``TDX_REGISTRY_DIR`` then runs nvcc zero times.

**Sharded warm** (``--hosts N --host-id i --registry-dir R``): run one
invocation per host against a shared registry directory and each host
builds only its deterministic shard of the libraries
(:func:`~torchdistx_tpu_torch.registry.shard_owner`), publishes them,
and fills the rest from what the other hosts published.  A library whose
owner never publishes is stolen after ``--steal-after`` seconds.
``--spawn-shards`` runs all ``--hosts`` shards as concurrent
subprocesses of this one (a single-machine rehearsal).

Every library reports its own outcome (``published`` / ``compiled`` /
``fetched`` / ``cached`` / ``stolen`` / ``unwarmed``), one line each on
stderr, followed by a summary JSON line on stdout; the exit status is
non-zero if ANY library ended unwarmed.

Usage::

    python -m torchdistx_tpu_torch.tools.warm_cache --model llama3-8b \\
        --cache-dir /local/tdx_kernels --registry-dir /nfs/tdx_registry
    python -m torchdistx_tpu_torch.tools.warm_cache --decode --model gpt2-125m \\
        --cache-dir d --registry-dir /nfs/tdx_registry --hosts 4 --host-id 2

``--model`` names a zoo preset (its family picks nothing else: every
model of a path launches the same libraries); by default every library
is warmed (training launches the flash kernels, serving paged decode),
``--decode`` warms the serving path's alone.  The registry key
composes the build environment (torch, CUDA, nvcc, flags, the device),
so warm on the kind of card and toolchain the consumers run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default=None,
                   help="zoo preset the warmed path will run (e.g. "
                        "llama3-8b, gpt2-125m)")
    p.add_argument("--cache-dir", required=True,
                   help="local kernel-library directory to fill")
    p.add_argument("--registry-dir", default=None,
                   help="shared artifact registry directory; libraries are "
                        "fetched from and published to it")
    p.add_argument("--hosts", type=int, default=1,
                   help="total hosts participating in a sharded warm "
                        "(requires --registry-dir when > 1)")
    p.add_argument("--host-id", type=int, default=0,
                   help="this host's 0-based id in [0, hosts)")
    p.add_argument("--spawn-shards", action="store_true",
                   help="single-machine rehearsal: spawn all --hosts shard "
                        "invocations as concurrent subprocesses (each gets "
                        "its --host-id) and exit non-zero if any shard does")
    p.add_argument("--steal-after", type=float, default=120.0,
                   help="seconds to wait for another host's artifact "
                        "before building it locally (work stealing)")
    p.add_argument("--poll", type=float, default=0.5,
                   help="registry polling interval during the fill phase")
    p.add_argument("--decode", action="store_true",
                   help="warm only the SERVING path's library (paged "
                        "decode); by default every library of the port")
    return p.parse_args(argv)


def warm(path: str, cache_dir: str, *, registry_dir=None, hosts=1,
         host_id=0, steal_after_s=120.0, poll_s=0.5) -> dict:
    """Build or fetch the kernel libraries of ``path`` (``train``,
    ``serve`` or ``all``) into ``cache_dir``, exchanging them through
    the registry at ``registry_dir`` (sharded across ``hosts``); returns
    the summary with per-library reports.  Importable; ``main`` is the
    CLI shell around it."""
    from ..registry import env_fingerprint, path_sources, warm_sharded

    summary = warm_sharded(path_sources(path), cache_dir,
                           registry_dir=registry_dir, hosts=hosts,
                           host_id=host_id, steal_after_s=steal_after_s,
                           poll_s=poll_s)
    summary["path"] = path
    summary["env"] = env_fingerprint()
    return summary


def _spawn_shards(args, argv) -> None:
    """Parent mode for ``--spawn-shards``: launch every shard of the
    sharded warm as a concurrent child of THIS process."""
    if args.hosts < 1:
        raise SystemExit("--spawn-shards requires --hosts >= 1")
    if args.hosts > 1 and not args.registry_dir:
        raise SystemExit("--spawn-shards with --hosts > 1 requires "
                         "--registry-dir (the shards exchange through it)")
    # The children re-run this tool with the parent's arguments minus
    # the spawn flag and any explicit --host-id, plus their own id.
    base = []
    skip_next = False
    for tok in argv:
        if skip_next:
            skip_next = False
            continue
        if tok == "--spawn-shards":
            continue
        if tok == "--host-id":
            skip_next = True
            continue
        if tok.startswith("--host-id="):
            continue
        base.append(tok)
    procs = [subprocess.Popen([sys.executable, "-m", __spec__.name, *base,
                               "--host-id", str(i)])
             for i in range(args.hosts)]
    rcs = [p.wait() for p in procs]
    for host_id, rc in enumerate(rcs):
        print(f"warm: shard host_id={host_id} rc={rc}", file=sys.stderr)
    print(json.dumps({"hosts": args.hosts, "shard_rcs": rcs}))
    if any(rcs):
        raise SystemExit(1)


def main(argv=None) -> None:
    argv = list(argv if argv is not None else sys.argv[1:])
    args = _parse_args(argv)
    if args.spawn_shards:
        return _spawn_shards(args, argv)
    if args.model is not None:
        from ..models import PRESETS

        if args.model not in PRESETS:
            raise SystemExit(f"unknown --model {args.model!r} (choose from "
                             f"{sorted(PRESETS)})")
    path = "serve" if args.decode else "all"
    os.makedirs(args.cache_dir, exist_ok=True)
    summary = warm(path, args.cache_dir, registry_dir=args.registry_dir,
                   hosts=args.hosts, host_id=args.host_id,
                   steal_after_s=args.steal_after, poll_s=args.poll)
    summary["model"] = args.model
    for rep in summary["program_reports"]:
        line = (f"warm: program={rep['program']} outputs={rep['outputs']} "
                f"outcome={rep['outcome']}")
        if "cache" in rep:
            line += f" cache={rep['cache']}"
        if "owner" in rep and args.hosts > 1:
            line += f" owner={rep['owner']}"
        line += f" {rep['seconds']:.2f}s"
        if "error" in rep:
            line += f" error={rep['error']}"
        print(line, file=sys.stderr)
    print(json.dumps(summary))
    if summary["unwarmed"]:
        # Partial warms FAIL the invocation: a deployment script that
        # gates rollout on this tool needs "every library warmed" to be
        # the zero-exit contract.
        raise SystemExit(1)


if __name__ == "__main__":
    main()
