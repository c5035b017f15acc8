"""Load and launch the Hopper flash-attention forward kernels.

Two bodies compute the same function, chosen by dtype with no fallback
between them, both on the tensor cores: bf16 runs ``csrc/flash_attention_sm90.cu``
(``wgmma`` fed by TMA), f32 ``csrc/flash_attention.cu`` (``mma.sync`` in
3xTF32 fed by ``cp.async``).  Each is built and loaded by
``kernels/build.py`` at first use; nothing is built or loaded at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import KernelLibrary

HEAD_DIMS = (64, 128, 256)


def _bind(lib: ctypes.CDLL) -> None:
    """Both bodies export ``flash_attention_fwd`` with one signature."""
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("flash_attention", _bind)              # f32, mma.sync 3xTF32
SM90_LIBRARY = KernelLibrary("flash_attention_sm90", _bind)    # bf16, wgmma + TMA
BODIES = {torch.float32: LIBRARY, torch.bfloat16: SM90_LIBRARY}
# launches of each body, by library name: ``ops.flash_attention.launches``
# counts both together, this tells them apart
BODY_LAUNCHES = {LIBRARY.name: 0, SM90_LIBRARY.name: 0}


def check_inputs(q, k, v, window) -> None:
    """Raise on anything the kernels do not take."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel: q, k, v must be on one "
                         "CUDA device")
    if q.dtype not in BODIES or k.dtype != q.dtype or v.dtype != q.dtype:
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
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernels read q, k, v in 16-byte "
                         "copies (TMA for bf16, cp.async for f32), which need "
                         "16-byte aligned data")
    if B * H > 65535 or S < 1:
        raise ValueError(f"flash_attention kernel: B*H={B * H} must be at "
                         f"most 65535 and S={S} at least 1")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")


def launch(q, k, v, *, causal: bool, window, library=None) -> torch.Tensor:
    """Run the dtype's kernel on CUDA tensors q (B, S, H, D), k, v (B, S, KH, D).

    Allocates the output, launches on the current stream and raises if
    the launch was refused.  Does not synchronise.  ``BODY_LAUNCHES``
    counts it under the body's name.  ``library`` is the dtype's body;
    tools that time altered copies of a source pass their own.
    """
    check_inputs(q, k, v, window)
    body = library or BODIES[q.dtype]
    fn = body.load().flash_attention_fwd
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, k.shape[2], D, int(causal),
                 0 if window is None else int(window), D ** -0.5, stream)
    if err < 0:
        raise RuntimeError(f"flash_attention kernel: TMA tensor map encoding "
                           f"failed: CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"{body.name} kernel launch failed: cudaError {err}")
    BODY_LAUNCHES[body.name] += 1
    return out
