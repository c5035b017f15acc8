"""Load and launch the Hopper flash-attention forward kernel.

``csrc/flash_attention.cu`` is built and loaded by ``kernels/build.py`` at
first use; nothing is built or loaded at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import KernelLibrary

HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("flash_attention", _bind)


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
    lib = LIBRARY.load()
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
