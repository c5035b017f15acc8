"""Public wrappers for the port's kernels.

A CPU tensor runs the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written kernel, or raises.  There is no fallback from
the one to the other.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.ref import attention_reference, ssd_chunked


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None):
    """The plain version of ``flash_attention``, on any device: GQA by
    repeating K/V heads, then ``attention_reference`` on (B*H, S, D)."""
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    out = attention_reference(
        q.transpose(1, 2).reshape(B * H, S, D),
        k.transpose(1, 2).reshape(B * H, S, D),
        v.transpose(1, 2).reshape(B * H, S, D), causal=causal, window=window)
    return out.reshape(B, H, S, D).transpose(1, 2)


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """q: (B, S, H, hd); k, v: (B, S, KH, hd) -> (B, S, H, hd).

    Counterpart of ``repro.kernels.ops.flash_attention``.  On CUDA the
    kernel reads GQA heads natively; ``flash_attention.launches`` counts
    the kernel's launches.
    """
    if q.is_cuda:
        out = _fa.launch(q, k, v, causal=causal, window=window)
        flash_attention.launches += 1
        return out
    return flash_attention_plain(q, k, v, causal=causal, window=window)


flash_attention.launches = 0


def ssd_chunk(S):
    """The JAX model's SSD chunk rule: 64 rows when S is a multiple of 64,
    else one chunk of all S."""
    return 64 if S % 64 == 0 else S


def ssd_scan_plain(x, dt, A, Bm, Cm, *, h0=None):
    """The plain version of ``ssd_scan``, on any device: ``ssd_chunked``
    with the chunk rule of ``ssd_chunk``."""
    return ssd_chunked(x, dt, A, Bm, Cm, h0=h0, chunk=ssd_chunk(x.shape[1]))


def ssd_scan(x, dt, A, Bm, Cm, *, h0=None):
    """Model-layout SSD: x (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm
    (B, S, N), h0 (B, H, P, N) f32 or None.

    Returns (y (B, S, H, P) in x's dtype, h_final (B, H, P, N) f32).
    Counterpart of ``repro.kernels.ops.ssd_scan``, with an initial state.
    On CUDA the kernel reads x, Bm and Cm in place through their strides;
    ``ssd_scan.launches`` counts the calls that launched it, each of which
    launches two kernels (C Bᵀ, then the scan).
    """
    if x.is_cuda:
        out = _ssd.launch(x, dt, A, Bm, Cm, h0)
        ssd_scan.launches += 1
        return out
    return ssd_scan_plain(x, dt, A, Bm, Cm, h0=h0)


ssd_scan.launches = 0
