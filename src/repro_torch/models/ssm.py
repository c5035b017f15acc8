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
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import chunk_products, ssd_chunked
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init
from repro_torch.parallel.sharding import (merge_last, on_shards, project,
                                           shard, split_last, tp_range)


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


def _scan_on_shards(xh, dt, A, Bc, Cc, h0):
    """``ssd_scan_plain`` of DTensors, on each device's heads (sharded over
    the tp axes, unevenly where they do not divide H, as GSPMD pads).  C Bᵀ,
    shared by all heads, is computed once: each device its rows of each
    chunk, then gathered; the scan's other products are per head."""
    b, S, H, P = xh.shape
    chunk = kops.ssd_chunk(S)
    rows = tp_range(chunk)
    CB = on_shards(lambda B, C: chunk_products(B, C, chunk, rows),
                   [(Bc, None, True), (Cc, None, True)],
                   [((b, S // chunk, chunk, chunk), 2)])
    CB = shard(CB, "batch", None, None, None)
    return on_shards(
        lambda x, dt, A, CB, B, C, h0: ssd_chunked(x, dt, A, B, C, h0=h0,
                                                   chunk=chunk, CB=CB),
        [(xh, 2, True), (dt, 2, True), (A, 0, False), (CB, None, True),
         (Bc, None, True), (Cc, None, True), (h0, 1, True)],
        [(xh.shape, 2), ((b, H, P, Bc.shape[-1]), 1)])


def _decode_on_shards(h, xt, dtt, A, Bt, Ct):
    """``ssd_decode_step`` on each device's heads; returns ``(h, y[:,
    None])``."""
    def step(h, xt, dtt, A, Bt, Ct):
        h, y = ssd_decode_step(h, xt, dtt, A, Bt, Ct)
        return h, y[:, None]
    b, H, P, _ = h.shape
    return on_shards(step, [(h, 1, True), (xt, 1, True), (dtt, 1, True),
                            (A, 0, False), (Bt, None, True), (Ct, None, True)],
                     [(h.shape, 1), ((b, 1, H, P), 2)])


def apply_mamba(p, x, cfg: ModelConfig, *, cache=None, use_kernel: bool = True):
    """x: (B, S, D). cache: dict(conv=(B,K-1,conv_dim), ssm=(B,H,P,N)) or None.

    Unlike JAX, the cache is updated in place (it is a view into the
    model's stacked cache) and returned.  Returns (out, cache).
    ``use_kernel=False`` (the training stages) scans with the plain
    version, which autograd differentiates: the kernel has no backward.

    On DTensors (the sharded steps): ``in_proj``'s output, sharded over the
    tp axes by columns that do not fall on the [z, x, B, C, dt] split, is
    gathered there; the causal conv runs on each device's channels; the
    SSD scan and the decode update on each device's heads, B and C
    (shared by the heads) replicated; the gated norm on the heads' shards.
    """
    B_, S, _ = x.shape
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    P = di // H

    zxbcdt = shard(project(x, p["in_proj"]), "batch", None, None)
    z, xs, Bc, Cc, dt = torch.split(zxbcdt, [di, di, N, N, H], dim=-1)

    conv_in = torch.cat([xs, Bc, Cc], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    K = p["conv_w"].shape[0]
    conv_out, new_conv = on_shards(
        _causal_conv, [(conv_in, 2, True), (p["conv_w"], 1, False),
                       (p["conv_b"], 0, False), (conv_state, 2, True)],
        [(conv_in.shape, 2), ((B_, K - 1, conv_in.shape[2]), 2)])
    conv_out = shard(F.silu(conv_out), "batch", None, None)
    xs, Bc, Cc = torch.split(conv_out, [di, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                     # (B,S,H)
    A = -torch.exp(p["A_log"])                                      # (H,)
    xh = split_last(xs, H)                          # a strided view of conv_out

    if cache is not None and S == 1:
        h, y = _decode_on_shards(cache["ssm"], xh[:, 0].float(), dt[:, 0], A,
                                 Bc[:, 0].float(), Cc[:, 0].float())
        y = y.to(x.dtype)                                           # (B,1,H,P)
    else:
        h0 = cache["ssm"] if cache is not None else None
        scan = (_scan_on_shards if isinstance(xh, DTensor) else
                kops.ssd_scan if use_kernel else kops.ssd_scan_plain)
        y, h = scan(xh, dt, A, Bc, Cc, h0=h0)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(h)

    y = y + p["D"][None, None, :, None] * xh.float()
    y = merge_last(y)                                               # (B,S,di)
    # gated RMSNorm (mamba2 style)
    g = y * F.silu(z.float())
    ms = g.square().mean(dim=-1, keepdim=True)
    g = g * torch.rsqrt(ms + 1e-6) * p["norm_scale"]
    return project(g.to(x.dtype), p["out_proj"]), cache


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
