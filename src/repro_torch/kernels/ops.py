"""Public wrappers for the port's kernels.

A CPU tensor runs the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written kernel, or raises.  There is no fallback from
the one to the other.  ``adamw_update`` also gives fake and meta leaves,
which no kernel here takes, to its plain version, and DTensor leaves to
the kernel or the plain version as their local shards would go.
"""
from __future__ import annotations

import torch

from repro_torch import spans
from repro_torch.kernels import adamw as _adamw
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


def adamw_update_plain(grads, params, m, v, step, *, lr, b1, b2, eps,
                       weight_decay, grad_clip, divisor=1):
    """The plain version of ``adamw_update``, on any device and on any
    kind of tensor (DTensor, fake, meta): the gradients divided by
    ``divisor`` in their dtype, then PyTorch's elementwise operations a
    leaf."""
    if divisor != 1:
        grads = [g / divisor for g in grads]
    if grad_clip is not None:
        with spans.span("adamw.clip"):
            gnorm = sum(g.float().square().sum() for g in grads).sqrt()
            scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
            grads = [g.float() * scale for g in grads]
    with spans.span("adamw.step"):
        step = step + 1
        t = step.float()
        b1t = 1.0 - torch.full_like(t, b1) ** t
        b2t = 1.0 - torch.full_like(t, b2) ** t
        new_p, new_m, new_v = [], [], []
        for p, g, mu, nu in zip(params, grads, m, v):
            g = g.float()
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * g.square()
            delta = (mu / b1t) / ((nu / b2t).sqrt() + eps)
            if p.ndim >= 2:  # decoupled decay on matrices only
                delta = delta + weight_decay * p.float()
            new_p.append((p.float() - lr * delta).to(p.dtype))
            new_m.append(mu)
            new_v.append(nu)
    return new_p, new_m, new_v, step


def adamw_update(grads, params, m, v, step, *, lr, b1, b2, eps, weight_decay,
                 grad_clip, divisor=1):
    """One tree's AdamW step over lists of leaves in one order: the
    gradients' mean (their sum over ``divisor``), clipped to a global norm
    of ``grad_clip`` over the tree (None: no clip), then the step with f32
    moments, bias correction at ``step + 1`` and decay on leaves with
    ``ndim >= 2``.  Returns new ``(params, m, v, step)``; nothing is
    written in place.

    Plain CUDA tensors take the fused kernel (``csrc/adamw.cu``), two
    launches a tree; ``adamw_update.launches`` counts the trees it updated.
    DTensor leaves whose local shards are plain CUDA tensors (the sharded
    steps on the card) take it on their shards, with the clip norm summed
    over the mesh.  Everything else takes the plain version: CPU tensors
    and CPU DTensors, and fake and meta leaves, by type, whose ops are
    traced and counted (the dry run).
    """
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                 grad_clip=grad_clip, divisor=divisor)
    if params and _adamw.takes(params[0]):
        out = _adamw.launch(grads, params, m, v, step, **hyper)
        adamw_update.launches += 1
        return out
    return adamw_update_plain(grads, params, m, v, step, **hyper)


adamw_update.launches = 0
