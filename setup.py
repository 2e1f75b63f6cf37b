"""Packaging for torchdistx_tpu.

Mirrors the reference's custom-build approach (its setup.py wraps CMake,
reference setup.py:43-136): the native graph engine (csrc/tdx_graph.cc)
is compiled into the package's ``_lib`` directory at build time; the
package remains fully functional without it (pure-Python fallback).
"""

import os
import shutil
import subprocess
from pathlib import Path

from setuptools import Command, find_packages, setup
from setuptools.command.build_py import build_py
from setuptools.dist import Distribution

ROOT = Path(__file__).parent


class BinaryDistribution(Distribution):
    """Mark the distribution non-pure when it bundles the native engine,
    so those wheels carry a platform tag: the .so is a native ELF, and a
    py3-none-any tag would let one x86_64 build shadow every platform
    (reference parity: its setup.py marks non-pure, setup.py:22-27
    there).  A build without the optional native lib stays pure — the
    package is fully functional in pure Python."""

    def has_ext_modules(self):
        # Consulted by bdist_wheel BEFORE build commands run: a prebuilt
        # .so or a usable compiler both mean the wheel will be binary
        # (build_py_with_native makes a failed compile fatal in the
        # latter case, so the tag always reflects the contents).
        prebuilt = list((ROOT / "torchdistx_tpu" / "_lib").glob("*.so"))
        return bool(prebuilt) or shutil.which("g++") is not None


class build_native(Command):
    description = "build the native graph engine (libtdxgraph.so)"
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        # Single source of truth for the compile flags: the Makefile.
        subprocess.check_call(["make", "-C", str(ROOT), "native"])


class build_py_with_native(build_py):
    def run(self):
        if os.environ.get("TDX_SKIP_NATIVE_BUILD") == "1":
            # The caller supplies a prebuilt engine in _lib/ (the conda
            # pipeline's install-python.sh, which reuses the one shared
            # RelWithDebInfo build so all packages ship the same binary).
            print("native build skipped (TDX_SKIP_NATIVE_BUILD=1)")
        elif shutil.which("g++") is None:
            # No compiler: a pure wheel (has_ext_modules False agrees).
            print("warning: native build skipped (no g++ on PATH)")
        else:
            # Compiler present: has_ext_modules already promised a binary
            # wheel, so a build failure must fail the build rather than
            # silently produce a platform-tagged wheel with no .so.
            self.run_command("build_native")
        super().run()


setup(
    name="torchdistx_tpu",
    # Single source of truth for the version: the VERSION file (the
    # reference keeps one consumed by scripts/set-version, VERSION:1).
    # The conda recipe's duplicated pin is checked against it by
    # packaging/conda/smoke.sh (`make packaging-smoke`).
    version=(ROOT / "VERSION").read_text().strip(),
    license="BSD-3-Clause",
    license_files=["LICENSE"],
    description=(
        "TPU-native fake tensors and deferred module initialization: "
        "record init, materialize sharded into TPU HBM via XLA"
    ),
    # torchdistx_tpu_torch is the PyTorch/CUDA port; its CUDA sources ship
    # as package data and are compiled by nvcc at first use, its native
    # graph engine's C++ sources by the host compiler.
    packages=find_packages(include=[
        "torchdistx_tpu", "torchdistx_tpu.*",
        "torchdistx_tpu_torch", "torchdistx_tpu_torch.*",
    ]),
    package_data={
        "torchdistx_tpu": ["_lib/*.so", "py.typed"],
        "torchdistx_tpu_torch": ["ops/csrc/*.cu", "csrc/*.cc",
                                 "csrc/include/*.h"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax>=0.4.30",
        "flax>=0.8",
        "optax",
        "numpy",
    ],
    extras_require={
        "torch": ["torch>=2.1", "transformers"],
        "test": ["pytest"],
    },
    cmdclass={"build_native": build_native, "build_py": build_py_with_native},
    distclass=BinaryDistribution,
)
