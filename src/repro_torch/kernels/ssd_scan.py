"""Load and launch the Hopper chunked SSD scan kernel.

``csrc/ssd_scan.cu`` is built and loaded by ``kernels/build.py`` at first
use; nothing is built or loaded at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import KernelLibrary

MAX_DIM = 128            # largest P and N the kernel takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ssd_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 10 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("ssd_scan", _bind)


def check_inputs(x, dt, A, Bm, Cm, h0) -> None:
    """Raise on anything the kernel does not take."""
    tensors = (x, dt, A, Bm, Cm) + ((h0,) if h0 is not None else ())
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("ssd_scan kernel: x, dt, A, Bm, Cm (and h0) must be "
                         "on one CUDA device")
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd_scan kernel takes x, Bm, Cm all f32 or all "
                         f"bf16, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssd_scan kernel takes f32 dt and A, got {dt.dtype}, "
                         f"{A.dtype}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan kernel wants x (B, S, H, P), got "
                         f"{tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if (dt.shape != (B, S, H) or A.shape != (H,) or Bm.shape != (B, S, N)
            or Cm.shape != (B, S, N)):
        raise ValueError(f"ssd_scan kernel wants dt (B, S, H), A (H,), Bm and "
                         f"Cm (B, S, N) for x {tuple(x.shape)}, got "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if h0 is not None and (h0.shape != (B, H, P, N) or h0.dtype != torch.float32
                           or not h0.is_contiguous()):
        raise ValueError(f"ssd_scan kernel wants h0 contiguous f32 "
                         f"{(B, H, P, N)}, got {h0.dtype} {tuple(h0.shape)}")
    if x.stride(-1) != 1 or Bm.stride(-1) != 1 or Cm.stride(-1) != 1:
        raise ValueError("ssd_scan kernel wants the last dimension of x, Bm "
                         "and Cm contiguous")
    if not A.is_contiguous():
        raise ValueError("ssd_scan kernel wants A contiguous")
    if not (1 <= P <= MAX_DIM and 1 <= N <= MAX_DIM):
        raise ValueError(f"ssd_scan kernel takes P and N in [1, {MAX_DIM}], "
                         f"got P={P}, N={N}")
    if S < 1 or B * H > 2**31 - 1:
        raise ValueError(f"ssd_scan kernel: S={S} must be at least 1 and "
                         f"B*H={B * H} below 2^31")


def launch(x, dt, A, Bm, Cm, h0=None):
    """Run the kernel on CUDA tensors in the model's layout.

    Allocates y (x's dtype) and h_final (f32), launches on the current
    stream and raises if the launch was refused.  Does not synchronise.
    """
    check_inputs(x, dt, A, Bm, Cm, h0)
    lib = LIBRARY.load()
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    hf = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), hf.data_ptr(), B, S, H, P, N,
            *x.stride()[:3], *dt.stride(), *Bm.stride()[:2], *Cm.stride()[:2],
            DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    return y, hf
