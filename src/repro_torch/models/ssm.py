"""Mamba2 / SSD (state-space duality) block — arXiv:2405.21060.

Port of ``repro.models.ssm``.  ``ssd_chunked`` is the chunked SSD scan in
plain tensor code: the intra-chunk quadratic term plus the chunk-to-chunk
state carry, f32 inside.  It is the plain version of the hand-written
kernel (``kernels/csrc/ssd_scan.cu``) and lives beside the kernels' other
plain versions in ``kernels/ref.py``.  ``apply_mamba``'s multi-token
branch (prefill, and every step without a cache) goes through
``kernels.ops.ssd_scan``, which launches the kernel on CUDA and runs
``ssd_chunked`` on the CPU; with ``use_kernel=False`` (the training
stages, which differentiate it) through ``ssd_chunked`` on every device.
Single-token decode updates the
(conv_state, ssm_state) cache in O(1) with ``ssd_decode_step``, plain
PyTorch in both packages.

Dtypes follow JAX's promotion: the serving cache is f32, so with bf16
params the causal conv, the scan and ``y`` run in f32 on the prefill path;
``torch.cat`` and mixed-dtype elementwise ops promote as
``jnp.concatenate`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init


# ---------------------------------------------------------------------------
# SSD decode step (the chunked scan is kernels.ref.ssd_chunked)
# ---------------------------------------------------------------------------

def ssd_decode_step(h, xt, dtt, A, Bt, Ct):
    """One-token SSD update. h: (b,H,P,N); xt: (b,H,P); dtt: (b,H)."""
    a = torch.exp(dtt * A)
    h = (a[..., None, None] * h
         + (dtt[..., None] * xt)[..., None] * Bt[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h, Ct)
    return h, y


# ---------------------------------------------------------------------------
# Mamba2 block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

def init_mamba(generator, cfg: ModelConfig, dtype, device):
    """Random weights at the JAX package's scales, drawn from ``generator``."""
    D, di = cfg.d_model, cfg.d_inner
    N, H = cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * N
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((cfg.ssm_conv, conv_dim), generator=generator, **f32)
    return {
        "in_proj": dense_init(generator, (D, 2 * di + 2 * N + H), dtype, device),
        "conv_w": (conv_w * cfg.ssm_conv ** -0.5).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm_scale": torch.ones((di,), **f32),
        "out_proj": dense_init(generator, (di, D), dtype, device),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B,S,C); w: (K,C). Returns (y, new_state).

    A sum of K shifted products, as in JAX: ``F.conv1d`` would take f32
    through cuDNN in TF32 on the GPU.
    """
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)                  # (B, S+K-1, C), promoted
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K)) + b
    new_state = xp[:, -(K - 1):, :] if K > 1 else None
    return y, new_state


def apply_mamba(p, x, cfg: ModelConfig, *, cache=None, use_kernel: bool = True):
    """x: (B, S, D). cache: dict(conv=(B,K-1,conv_dim), ssm=(B,H,P,N)) or None.

    Unlike JAX, the cache is updated in place (it is a view into the
    model's stacked cache) and returned.  Returns (out, cache).
    ``use_kernel=False`` (the training stages) scans with the plain
    version, which autograd differentiates: the kernel has no backward.
    """
    B_, S, _ = x.shape
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    P = di // H

    z, xs, Bc, Cc, dt = torch.split(x @ p["in_proj"], [di, di, N, N, H], dim=-1)

    conv_in = torch.cat([xs, Bc, Cc], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], p["conv_b"], conv_state)
    conv_out = F.silu(conv_out)
    xs, Bc, Cc = torch.split(conv_out, [di, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                     # (B,S,H)
    A = -torch.exp(p["A_log"])                                      # (H,)
    xh = xs.reshape(B_, S, H, P)                    # a strided view of conv_out

    if cache is not None and S == 1:
        h, y = ssd_decode_step(cache["ssm"], xh[:, 0].float(), dt[:, 0], A,
                               Bc[:, 0].float(), Cc[:, 0].float())
        y = y[:, None].to(x.dtype)                                  # (B,1,H,P)
    else:
        h0 = cache["ssm"] if cache is not None else None
        scan = kops.ssd_scan if use_kernel else kops.ssd_scan_plain
        y, h = scan(xh, dt, A, Bc, Cc, h0=h0)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(h)

    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(B_, S, di)
    # gated RMSNorm (mamba2 style)
    g = y * F.silu(z.float())
    ms = g.square().mean(dim=-1, keepdim=True)
    g = g * torch.rsqrt(ms + 1e-6) * p["norm_scale"]
    return g.to(x.dtype) @ p["out_proj"], cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                     device):
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    P = di // H
    conv_dim = di + 2 * N
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
    }
