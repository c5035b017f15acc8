"""Load and launch the Hopper flash-attention kernels.

Two forward bodies compute the same function, chosen by dtype with no
fallback between them, both on the tensor cores: bf16 runs
``csrc/flash_attention_sm90.cu`` (``wgmma`` fed by TMA), f32
``csrc/flash_attention.cu`` (``mma.sync`` in 3xTF32 fed by ``cp.async``).
Training's pair is bf16 only: ``launch_lse``, the sm90 forward that also
writes the rows' log-sum-exp, and ``launch_bwd``,
``csrc/flash_attention_bwd_sm90.cu``.  Each source is built and loaded by
``kernels/build.py`` at first use; nothing is built or loaded at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import KernelLibrary

HEAD_DIMS = (64, 128, 256)
TRAIN_HEAD_DIMS = (64, 128)   # the training pair's (forward with lse, backward)
TILE = 64                     # rows of the kernels' tiles; lse is padded to it


def _bind(lib: ctypes.CDLL) -> None:
    """Both bodies export ``flash_attention_fwd`` with one signature."""
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _bind_sm90(lib: ctypes.CDLL) -> None:
    """The bf16 body also exports the training forward, which writes the
    rows' log-sum-exp."""
    _bind(lib)
    fn = lib.flash_attention_fwd_lse
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _bind_bwd(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("flash_attention", _bind)              # f32, mma.sync 3xTF32
SM90_LIBRARY = KernelLibrary("flash_attention_sm90", _bind_sm90)  # bf16, wgmma + TMA
BWD_LIBRARY = KernelLibrary("flash_attention_bwd_sm90", _bind_bwd)  # bf16 backward
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
    _check(err, body.name)
    BODY_LAUNCHES[body.name] += 1
    return out


def train_shapes(q, k, v) -> bool:
    """Whether the training pair takes q, k, v by dtype and shape: bf16
    (B, S, H, D) and (B, S, KH, D) with one head dim D in
    ``TRAIN_HEAD_DIMS`` for all three and KH dividing H."""
    if not all(t.dtype == torch.bfloat16 and t.dim() == 4 for t in (q, k, v)):
        return False
    B, S, H, D = q.shape
    return (D in TRAIN_HEAD_DIMS and k.shape == v.shape
            and tuple(k.shape[:2]) == (B, S) and k.shape[3] == D
            and H % k.shape[2] == 0)


def check_train_inputs(q, k, v, window) -> None:
    """Raise on anything the training pair does not take."""
    check_inputs(q, k, v, window)
    if not train_shapes(q, k, v):
        raise ValueError(f"flash attention training kernels take bf16 q, k, "
                         f"v with head_dim in {TRAIN_HEAD_DIMS}, got "
                         f"{q.dtype} {tuple(q.shape)}, {tuple(k.shape)}")


def padded(S: int) -> int:
    """S rounded up to the kernels' tile: the length of an lse row."""
    return -(-S // TILE) * TILE


def _check(err: int, name: str) -> None:
    if err < 0:
        raise RuntimeError(f"{name}: TMA tensor map encoding failed: "
                           f"CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def launch_lse(q, k, v, *, window):
    """The training forward on CUDA bf16 q (B, S, H, D), k, v (B, S, KH,
    D), causal: ``(out, lse)``, out as ``launch`` gives it, lse the rows'
    natural log-sum-exp of the scaled scores, f32 (B, H, padded(S)) (rows
    past S score zero queries).  ``BODY_LAUNCHES`` counts it under the bf16
    body's name."""
    check_train_inputs(q, k, v, window)
    fn = SM90_LIBRARY.load().flash_attention_fwd_lse
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, padded(S)), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), B, S, H, k.shape[2], D, 1,
                 0 if window is None else int(window), D ** -0.5, stream)
    _check(err, SM90_LIBRARY.name)
    BODY_LAUNCHES[SM90_LIBRARY.name] += 1
    return out, lse


def launch_bwd(q, k, v, out, lse, dout, *, window):
    """The training backward on CUDA: ``(dq, dk, dv)`` in q's, k's and v's
    shapes, bf16, from ``launch_lse``'s ``out`` and ``lse`` and the
    output's gradient ``dout`` (contiguous, out's shape).  Three launches
    on the current stream (D, then dK and dV, then dQ); no sync."""
    check_train_inputs(q, k, v, window)
    B, S, H, D = q.shape
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype \
            or dout.dtype != q.dtype:
        raise ValueError(f"flash attention backward: out {tuple(out.shape)} "
                         f"{out.dtype} and dout {tuple(dout.shape)} "
                         f"{dout.dtype} must be q's {tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, H, padded(S)) or lse.dtype != torch.float32:
        raise ValueError(f"flash attention backward: lse {tuple(lse.shape)} "
                         f"{lse.dtype}, want ({B}, {H}, {padded(S)}) f32")
    if not all(t.is_contiguous() and t.device == q.device and t.data_ptr() % 16 == 0
               for t in (out, lse, dout)):
        raise ValueError("flash attention backward takes contiguous, 16-byte "
                         "aligned out, lse and dout on q's device")
    fn = BWD_LIBRARY.load().flash_attention_bwd
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H,
                 k.shape[2], D, 0 if window is None else int(window),
                 D ** -0.5, stream)
    _check(err, BWD_LIBRARY.name)
    return dq, dk, dv
