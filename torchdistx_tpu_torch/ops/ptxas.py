"""ptxas's ``-v`` report of a kernel build, per kernel.

``nvcc -Xptxas -v`` writes, for each entry function, its registers and
its stack frame and spill bytes; :mod:`._build` keeps that output beside
each library as ``.log``.  This module imports nothing of the package,
so a tool can load it by path and read the log of another tree's build.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable

__all__ = ["ptxas_table"]


def ptxas_table(lines: Iterable[str]) -> Dict[str, Dict[str, int]]:
    """ptxas's ``-v`` report of a build (the lines of its ``.log``) per
    entry function, under its mangled name: ``registers`` and, where
    ptxas gives them, ``stack_frame``, ``spill_stores`` and
    ``spill_loads`` (bytes)."""
    rows: Dict[str, Dict[str, int]] = {}
    fn = None
    for ln in lines:
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
            rows.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            rows[fn].update(stack_frame=int(m[1]), spill_stores=int(m[2]),
                            spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            rows[fn]["registers"] = int(m[1])
    return rows
