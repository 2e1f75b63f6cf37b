"""The port stands alone: ``torchdistx_tpu_torch`` and ``chip_smoke.py``
import no JAX, no flax and nothing of the JAX package ``torchdistx_tpu``
— checked in a fresh interpreter and by scanning their sources — and
``chip_smoke.py`` refuses to report a result without a GPU or without
the port beside it."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "torchdistx_tpu_torch"
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|torchdistx_tpu)(?![\w])",
    re.M)


def _run(args, cwd, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import torchdistx_tpu_torch, torchdistx_tpu_torch.serve, "
        "torchdistx_tpu_torch.ops, torchdistx_tpu_torch.models, "
        "torchdistx_tpu_torch.models.plans, torchdistx_tpu_torch.parallel, "
        "torchdistx_tpu_torch.cuda_bridge, torchdistx_tpu_torch.hf, "
        "torchdistx_tpu_torch.fsdp, torchdistx_tpu_torch.chaos, "
        "torchdistx_tpu_torch.observe.flightrec, "
        "torchdistx_tpu_torch.observe.reqledger, "
        "torchdistx_tpu_torch.observe.slo, "
        "torchdistx_tpu_torch.observe.health, "
        "torchdistx_tpu_torch.observe.httpd, "
        "torchdistx_tpu_torch.observe.costmodel, "
        "torchdistx_tpu_torch.serialize, torchdistx_tpu_torch._native, "
        "torchdistx_tpu_torch.utils.profiling, "
        "torchdistx_tpu_torch.ops.autotune, "
        "torchdistx_tpu_torch.registry, torchdistx_tpu_torch.tools, "
        "torchdistx_tpu_torch.tools.reshard_ctl, "
        "torchdistx_tpu_torch.tools.warm_cache, "
        "torchdistx_tpu_torch.tools.registry_ctl, chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'torchdistx_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = _run(["-c", code], cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    # The chaos package, the serve stack's observe modules, the registry
    # and the tools are scanned.
    scanned = {str(f.relative_to(PORT)) for f in files if f.is_relative_to(PORT)}
    assert {"chaos/plan.py", "chaos/inject.py", "chaos/__init__.py",
            "observe/flightrec.py", "observe/reqledger.py", "observe/slo.py",
            "observe/health.py", "registry/__init__.py", "registry/store.py",
            "registry/scheduler.py", "tools/__init__.py",
            "tools/reshard_ctl.py", "tools/warm_cache.py",
            "tools/registry_ctl.py", "serialize.py", "_native.py",
            "observe/httpd.py", "utils/profiling.py",
            "ops/autotune.py"} <= scanned
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if FORBIDDEN.search(f.read_text())]
    assert offenders == []
    # The pattern does catch what it must, and spares the port's own name.
    assert FORBIDDEN.search("from torchdistx_tpu.ops import x")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert not FORBIDDEN.search("from torchdistx_tpu_torch.ops import x")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    proc = _run(["chip_smoke.py"], cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    # Alone in a directory, without the port beside it: it fails too.
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert proc.stdout == ""
