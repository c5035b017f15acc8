"""Load and launch the split-KV decode attention (``csrc/decode_attention.cu``).

One call is two launches: the split pass, a block a (split, K/V head,
row) writing each split's f32 (m, l, acc) into scratch allocated here,
then the merge of the splits in order into the output.  ``plan`` picks
the splits from the shapes alone.  It is built and loaded by
``kernels/build.py`` at first use; nothing is built or loaded at import.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels.build import KernelLibrary

TILE = 32              # slots a tile: csrc/decode_attention.cu kTile
MIN_SPLIT = 4 * TILE   # slots a split at least, so that its partials stay small
# blocks a call aims at: several waves over the H100's 132 SMs, each of
# which holds three blocks at head_dim 128 with an f32 cache
TARGET_BLOCKS = 1024
MAX_HD = 256           # csrc/decode_attention.cu kMaxHd
MAX_HEADS = 1024       # csrc/decode_attention.cu kMaxHeads
DTYPES = (torch.float32, torch.bfloat16)


def _bind(lib: ctypes.CDLL) -> None:
    split = lib.decode_attention_split
    split.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                      + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3
                      + [ctypes.c_float, ctypes.c_void_p])
    split.restype = ctypes.c_int
    merge = lib.decode_attention_merge
    merge.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                      + [ctypes.c_void_p])
    merge.restype = ctypes.c_int


LIBRARY = KernelLibrary("decode_attention", _bind)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan(pairs: int, kv_valid: int) -> Tuple[int, int]:
    """``(splits, chunk)`` for ``pairs`` (rows x K/V heads) blocks of a
    split over ``kv_valid`` live slots: split i covers slots
    ``[i * chunk, min((i + 1) * chunk, kv_valid))``, none empty, ``chunk``
    whole tiles.  Enough splits to bring the grid to about
    ``TARGET_BLOCKS``, and no more than ``kv_valid / MIN_SPLIT`` rounded
    up, so that short caches are not cut into slivers."""
    want = max(1, min(_ceil(TARGET_BLOCKS, pairs), _ceil(kv_valid, MIN_SPLIT)))
    chunk = _ceil(_ceil(kv_valid, want), TILE) * TILE
    return _ceil(kv_valid, chunk), chunk


@functools.lru_cache(maxsize=None)
def _scale(hd: int, dtype) -> float:
    """hd^-0.5 rounded to ``dtype``, as the plain version scales q."""
    return torch.tensor(hd ** -0.5, dtype=dtype).item()


def takes(q) -> bool:
    """Whether the kernel is the path for ``q``: a plain tensor on a CUDA
    device (not a fake or a meta tensor, which the dry run traces)."""
    return type(q) is torch.Tensor and q.is_cuda


def check_inputs(q, ck, cv, kv_valid: int, KH: int, hd: int, kv_heads) -> None:
    """Raise on anything the kernel does not take."""
    if q.dim() != 4 or q.shape[1] != 1 or q.shape[3] != hd:
        raise ValueError(f"decode attention kernel wants q (B, 1, H, {hd}), "
                         f"got {tuple(q.shape)}")
    if hd % 8 or not 8 <= hd <= MAX_HD:
        raise ValueError(f"decode attention kernel takes a head_dim that is a "
                         f"multiple of 8 up to {MAX_HD}, got {hd}")
    B, _, H, _ = q.shape
    if H > MAX_HEADS:
        raise ValueError(f"decode attention kernel takes at most {MAX_HEADS} "
                         f"query heads, got {H}")
    if q.dtype not in DTYPES or ck.dtype not in DTYPES or cv.dtype != ck.dtype:
        raise ValueError(f"decode attention kernel takes q and a cache of f32 "
                         f"or bf16 (K and V alike), got {q.dtype}, {ck.dtype} "
                         f"and {cv.dtype}")
    if ck.dim() != 3 or ck.shape != cv.shape or ck.shape[0] != B \
            or ck.shape[2] != KH * hd:
        raise ValueError(f"decode attention kernel wants K and V (B, C, "
                         f"{KH} * {hd}) for q {tuple(q.shape)}, got "
                         f"{tuple(ck.shape)} and {tuple(cv.shape)}")
    if not all(t.device == q.device for t in (ck, cv)):
        raise ValueError("decode attention kernel: q, K and V on one device")
    elems = 16 // ck.element_size()
    if q.stride(3) != 1 or ck.stride() != cv.stride() or ck.stride(2) != 1 \
            or ck.stride(0) % elems or ck.stride(1) % elems \
            or ck.data_ptr() % 16 or cv.data_ptr() % 16:
        raise ValueError(f"decode attention kernel reads rows of 16-byte "
                         f"vectors: q's last stride 1, K and V of one layout "
                         f"with the last stride 1, the others multiples of "
                         f"{elems} and 16-byte aligned; got q {q.stride()}, "
                         f"K {ck.stride()}, V {cv.stride()}")
    if not 1 <= kv_valid <= ck.shape[1]:
        raise ValueError(f"kv_valid {kv_valid} outside [1, {ck.shape[1]}]")
    if kv_heads is None:
        if H % KH:
            raise ValueError(f"{H} query heads over {KH} K/V heads need a "
                             f"kv_heads map")
    elif kv_heads.shape != (H,) or kv_heads.device != q.device \
            or kv_heads.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"kv_heads must be ({H},) integers on {q.device}, "
                         f"got {tuple(kv_heads.shape)} {kv_heads.dtype} on "
                         f"{kv_heads.device}")


def launch(q, ck, cv, kv_valid: int, KH: int, hd: int, kv_heads=None,
           library=LIBRARY):
    """Attention of q (B, 1, H, hd) against the live slots ``[0,
    kv_valid)`` of the flat cache ck, cv (B, C, KH * hd); query head h
    reads K/V head ``kv_heads[h]``, or ``h // (H // KH)`` without a map.
    Returns a new (B, 1, H, hd) tensor in q's dtype.  Allocates the output
    and the splits' scratch, launches on the current stream and raises if a
    launch was refused.  Does not synchronise."""
    check_inputs(q, ck, cv, kv_valid, KH, hd, kv_heads)
    lib = library.load()
    B, _, H, _ = q.shape
    splits, chunk = plan(B * KH, kv_valid)
    device = q.device
    if kv_heads is not None and kv_heads.dtype != torch.int32:
        kv_heads = kv_heads.to(torch.int32)
    part_ml = torch.empty((B, H, splits, 2), dtype=torch.float32, device=device)
    part_acc = torch.empty((B, H, splits, hd), dtype=torch.float32,
                           device=device)
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=device)
    scale = _scale(hd, q.dtype)
    q_bf16 = int(q.dtype == torch.bfloat16)
    kv_map = None if kv_heads is None else kv_heads.data_ptr()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check(lib.decode_attention_split(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(), kv_map,
            part_ml.data_ptr(), part_acc.data_ptr(), B, H, KH, hd, q_bf16,
            int(ck.dtype == torch.bfloat16), q.stride(0), q.stride(2),
            ck.stride(0), ck.stride(1), kv_valid, splits, chunk, scale,
            stream), "split")
        _check(lib.decode_attention_merge(
            part_ml.data_ptr(), part_acc.data_ptr(), kv_map, out.data_ptr(),
            B, H, KH, hd, q_bf16, splits, stream), "merge")
    return out


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"decode attention {what} kernel launch failed: "
                           f"cudaError {err}")
