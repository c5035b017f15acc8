"""Build, load and launch the Hopper flash-attention forward kernel.

``csrc/flash_attention.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``build/<hash of the source and flags>/`` at the root of the checkout, and
loaded with ``ctypes``.  Nothing is built or loaded at import: the CPU
tests import this module on hosts without ``nvcc`` or a GPU.
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

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
build_seconds = None    # wall time of the build this process ran, if any
build_log = ""          # nvcc's output (ptxas register and shared-memory use)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the flash-attention kernel")


def build() -> Path:
    """Compile the kernel if this source and these flags were not built yet."""
    global build_seconds, build_log
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / key
    lib = out_dir / "libflash_attention.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {SOURCE}:\n{build_log}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    return lib


def load():
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_inputs(q, k, v, window) -> None:
    """Raise on anything the kernel does not take."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel: q, k, v must be on one "
                         "CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes f32 or bf16 for all "
                         f"of q, k, v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention kernel wants q (B, S, H, D) and "
                         f"k, v (B, S, KH, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"flash_attention kernel: k, v {tuple(k.shape)} do "
                         f"not match q {tuple(q.shape)}")
    KH = k.shape[2]
    if KH < 1 or H % KH:
        raise ValueError(f"flash_attention kernel: H={H} is not a multiple "
                         f"of KH={KH}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous q, k, v")
    if B * H > 65535 or S < 1:
        raise ValueError(f"flash_attention kernel: B*H={B * H} must be at "
                         f"most 65535 and S={S} at least 1")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")


def launch(q, k, v, *, causal: bool, window) -> torch.Tensor:
    """Run the kernel on CUDA tensors q (B, S, H, D), k, v (B, S, KH, D).

    Allocates the output, launches on the current stream and raises if
    the launch was refused.  Does not synchronise.
    """
    check_inputs(q, k, v, window)
    lib = load()
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, k.shape[2], D, DTYPES[q.dtype], int(causal),
            0 if window is None else int(window), D ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    return out
