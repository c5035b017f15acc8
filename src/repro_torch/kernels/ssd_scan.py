"""Load and launch the Hopper chunked SSD scan.

``csrc/ssd_scan.cu`` holds two kernels that one call runs in turn: C Bᵀ
once per (batch, chunk) on the CUDA cores, then the scan, one block per
(batch, head, tile of P rows), its chunk products on the tensor cores in
3xTF32.  It is built and loaded by ``kernels/build.py`` at first use;
nothing is built or loaded at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import KernelLibrary

MAX_DIM = 128            # largest P and N the kernel takes
CHUNK = 64               # rows of a chunk
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ALIGN = 16               # bytes: the kernel copies tiles with 16-byte cp.async


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ssd_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 10
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    plan = lib.ssd_scan_plan
    plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    plan.restype = ctypes.c_int


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
    elem = x.element_size()
    strides = (*x.stride()[:3], *Bm.stride()[:2], *Cm.stride()[:2])
    if (any(t.data_ptr() % ALIGN for t in (x, Bm, Cm))
            or any(s * elem % ALIGN for s in strides)):
        raise ValueError(f"ssd_scan kernel copies x, Bm and Cm in 16-byte "
                         f"pieces: their data and every stride but the last "
                         f"must be 16-byte aligned, got strides {strides} of "
                         f"{elem}-byte elements")
    if S < 1 or B > 65535 or B * H * P > 2**31 - 1:
        raise ValueError(f"ssd_scan kernel: S={S} must be at least 1, "
                         f"B={B} at most 65535 and B*H*P={B * H * P} below "
                         f"2^31")


def plan(B, H, P, N, dtype, *, library=LIBRARY):
    """How a call of these sizes runs on the current card: ``tile_p``
    rows of P a block, ``stages`` of loads in shared memory,
    ``blocks_per_sm`` (0: the tile does not fit), ``blocks`` of the scan
    kernel and its ``smem`` bytes."""
    out = (ctypes.c_int * 5)()
    err = library.load().ssd_scan_plan(B, H, P, N, DTYPES[dtype], out)
    if err != 0:
        raise ValueError(f"ssd_scan plan refused: cudaError {err}")
    return dict(zip(("tile_p", "stages", "blocks_per_sm", "blocks", "smem"), out))


def launch(x, dt, A, Bm, Cm, h0=None, *, library=LIBRARY):
    """Run the kernels on CUDA tensors in the model's layout.

    Allocates y (x's dtype), h_final (f32) and the C Bᵀ scratch (f32,
    one 64 x 64 tile per batch and chunk), launches both kernels on the
    current stream and raises if a launch was refused.  Does not
    synchronise.  ``library`` is the built ``ssd_scan.cu``; tools that
    time altered copies of the source pass their own.
    """
    check_inputs(x, dt, A, Bm, Cm, h0)
    lib = library.load()
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    hf = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    cb = torch.empty((B, -(-S // CHUNK), CHUNK, CHUNK), dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None if h0 is None else h0.data_ptr(),
            cb.data_ptr(), y.data_ptr(), hf.data_ptr(), B, S, H, P, N,
            *x.stride()[:3], *dt.stride(), *Bm.stride()[:2], *Cm.stride()[:2],
            DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    return y, hf
