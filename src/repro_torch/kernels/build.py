"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` (with
``csrc/`` on the include path, for the headers the sources share) into a
shared library with a plain C interface, at first use, into
``build/<hash of the source and flags>/lib<name>.so`` at the root of the
checkout, and loaded with ``ctypes``.  Nothing is built or loaded at
import: the CPU tests import these modules on hosts without ``nvcc`` or a
GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def toolkit_program(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): on the
    PATH, else under torch's ``CUDA_HOME``."""
    found = shutil.which(name)
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", name)):
        return os.path.join(CUDA_HOME, "bin", name)
    raise RuntimeError(f"{name} not found: the CUDA toolkit is needed to build "
                       f"the port's kernels")


def _nvcc() -> str:
    return toolkit_program("nvcc")


class KernelLibrary:
    """One kernel's shared library: built from ``csrc/<name>.cu`` (or from
    ``source``, an altered copy of it) on first ``load()``; ``bind`` sets
    the C entry points' argument types."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None],
                 source: Path | None = None):
        self.name = name
        self.source = source or CSRC / f"{name}.cu"
        self.bind = bind
        self.lib = None
        self.build_seconds = None   # wall time of the build this process ran, if any
        self.build_log = ""         # nvcc's output (ptxas register and spill lines)

    def path(self) -> Path:
        """Keyed by the source, the headers in ``csrc/`` it may include and
        the flags."""
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        key = hashlib.sha256(self.source.read_bytes() + headers
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_ROOT / key / f"lib{self.name}.so"

    def build(self) -> Path:
        """Compile the kernel if this source and these flags were not built yet."""
        lib = self.path()
        if lib.exists():
            return lib
        lib.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
                                   str(self.source)],
                                  capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {self.source}:\n"
                                   f"{self.build_log}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.build_seconds = time.perf_counter() - t0
        return lib

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        if self.lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self.bind(lib)
            self.lib = lib
        return self.lib
