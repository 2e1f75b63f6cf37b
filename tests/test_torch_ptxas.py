"""ptxas's ``-v`` report per kernel (``ops/ptxas.py``), which
``chip_smoke.py``'s spill checks and ``kernel_ab.py`` read from a build's
log.  A log in the layout nvcc writes for ``sm_90a``: each entry
function's properties and register line follow its "Compiling entry
function" line."""

import importlib.util
import os

import pytest

from torchdistx_tpu_torch.ops.ptxas import ptxas_table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD = "_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi128ELi8EEEvPKvS2_"
KEYED = "_ZN12_GLOBAL__N_116keyed_rng_kernelILi0ELi1ELi1EEEvPN4OutIXT_EE1TE4Planjjff"
LOG = f"""nvcc warning : something unrelated
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{FWD}' for 'sm_90a'
ptxas info    : Function properties for {FWD}
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 40960 bytes smem
ptxas info    : Compiling entry function '{KEYED}' for 'sm_90a'
ptxas info    : Function properties for {KEYED}
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 34 registers, used 0 barriers, 32 bytes cumulative stack size
""".splitlines()
WANT = {FWD: {"stack_frame": 0, "spill_stores": 8, "spill_loads": 12,
              "registers": 255},
        KEYED: {"stack_frame": 32, "spill_stores": 0, "spill_loads": 0,
                "registers": 34}}


def _kernel_ab_table():
    spec = importlib.util.spec_from_file_location(
        "kernel_ab_under_test", os.path.join(ROOT, "kernel_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._ptxas_table()


@pytest.mark.parametrize("reader", ["package", "kernel_ab"])
def test_ptxas_table_reads_each_entry_function(reader):
    """Registers, stack frame and spill bytes land under each entry
    function's mangled name, whether read through the package or
    through ``kernel_ab.py``'s load of the same file by path; lines
    before the first entry function belong to none."""
    table = ptxas_table if reader == "package" else _kernel_ab_table()
    assert table(LOG) == WANT
    assert table(LOG[:2]) == {}
