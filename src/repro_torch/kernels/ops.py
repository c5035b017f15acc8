"""Public wrappers for the port's kernels.

A CPU tensor runs the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written kernel, or raises.  There is no fallback from
the one to the other.  ``adamw_update`` also gives fake and meta leaves,
which no kernel here takes, to its plain version, and DTensor leaves to
the kernel or the plain version as their local shards would go;
``decode_attention`` gives fake and meta tensors to its plain version.
``flash_attention_train`` is differentiable: an autograd function over
``flash_attention_lse`` and ``flash_attention_bwd``, each of which takes
its kernel on CUDA and its plain version elsewhere; the training stages
call it only where ``flash_attention_train_route`` admits the tensors.
"""
from __future__ import annotations

import torch

from repro_torch import spans
from repro_torch.kernels import adamw as _adamw
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.ref import NEG_INF, attention_reference, ssd_chunked
from repro_torch.parallel.sharding import split_last


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


def _train_mask(S: int, window, device):
    """(S, S) bool: query row q keeps key k where k <= q (and k > q -
    window)."""
    pos = torch.arange(S, device=device)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    return mask


def _repeat_heads(t, rep: int):
    return t.repeat_interleave(rep, dim=2) if rep > 1 else t


def flash_attention_lse_plain(q, k, v, *, window=None):
    """The plain version of ``flash_attention_lse``, on any device: causal
    attention as ``layers._online_attention`` computes it (f32 scores, the
    softmax rounded to v's dtype before P V), and the rows' natural
    log-sum-exp of the scaled, masked scores, f32 (B, H, S)."""
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     _repeat_heads(k, rep).float()) * D ** -0.5
    s = s.masked_fill(~_train_mask(S, window, q.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                       _repeat_heads(v, rep).float()).to(q.dtype)
    return out, torch.logsumexp(s, dim=-1)


def flash_attention_lse(q, k, v, *, window=None):
    """Causal self-attention that keeps what its backward needs: ``(out,
    lse)``, out (B, S, H, hd) as ``flash_attention`` computes it and lse
    the rows' natural log-sum-exp of the scaled, masked scores, f32 (B, H,
    S'), S' >= S, its first S columns the rows'.

    On CUDA the sm90 forward writes both (``flash_attention.launches``
    counts it; S' is S rounded up to 64); elsewhere
    ``flash_attention_lse_plain`` (S' = S)."""
    if q.is_cuda:
        out = _fa.launch_lse(q, k, v, window=window)
        flash_attention.launches += 1
        return out
    return flash_attention_lse_plain(q, k, v, window=window)


def split3(x):
    """f32 x as three bf16 terms, hi + mid + lo, whose f32 sum is x
    exactly (8 significant bits each; each remainder is exact in f32)."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, window=None):
    """The plain version of ``flash_attention_bwd``, on any device, in the
    kernel's arithmetic: P = exp(S scale - lse) recomputed, dV = P^T dO
    with P in bf16, D = rowsum(dO * O), dS = P (dP - D) in f32, then dQ
    and dK from dS's three bf16 terms, each product in f32; the K/V
    gradients summed over each GQA group."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    rep = H // KH
    scale = D ** -0.5
    kf, vf = _repeat_heads(k, rep).float(), _repeat_heads(v, rep).float()
    qf, gf = q.float(), dout.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    p = torch.exp(s * scale - lse[..., :S, None])
    p = p.masked_fill(~_train_mask(S, window, q.device), 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = (gf * out.float()).sum(-1).transpose(1, 2)      # (B, H, S)
    ds = p * (dp - delta[..., None])
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    for term in split3(ds):
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", term.float(), kf)
        dk = dk + torch.einsum("bhqk,bqhd->bkhd", term.float(), qf)

    def group(g):                                           # (B, S, H, D) -> KH
        return g.reshape(B, S, KH, rep, D).sum(3)
    return ((dq * scale).to(q.dtype), group(dk * scale).to(k.dtype),
            group(dv).to(v.dtype))


def flash_attention_bwd(q, k, v, out, lse, dout, *, window=None):
    """The gradients ``(dq, dk, dv)`` of causal self-attention from
    ``flash_attention_lse``'s ``out`` and ``lse`` and the output's gradient
    ``dout``, each in its input's dtype.

    On CUDA the hand-written backward (``csrc/flash_attention_bwd_sm90.cu``,
    three launches, no atomics: two runs are bit-equal);
    ``flash_attention_bwd.launches`` counts its calls.  Elsewhere
    ``flash_attention_bwd_plain``."""
    if q.is_cuda:
        grads = _fa.launch_bwd(q, k, v, out, lse, dout, window=window)
        flash_attention_bwd.launches += 1
        return grads
    return flash_attention_bwd_plain(q, k, v, out, lse, dout, window=window)


flash_attention_bwd.launches = 0


class FlashAttentionTrain(torch.autograd.Function):
    """Causal self-attention that autograd differentiates through
    ``flash_attention_lse`` and ``flash_attention_bwd``: on CUDA the
    kernel pair, elsewhere their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        out, lse = flash_attention_lse(q, k, v, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         window=ctx.window)
        return dq, dk, dv, None


def flash_attention_train(q, k, v, *, window=None):
    """Causal self-attention with a backward: q (B, S, H, hd), k, v (B, S,
    KH, hd) -> (B, S, H, hd).  The training stages take it where
    ``flash_attention_train_route`` admits their tensors."""
    return FlashAttentionTrain.apply(q.contiguous(), k.contiguous(),
                                     v.contiguous(), window)


def flash_attention_train_route(q, k, v) -> bool:
    """Whether causal self-attention over q, k, v takes the kernel pair:
    plain CUDA tensors (not DTensors, fake or meta tensors), bf16, one
    head dim of 64 or 128 for all three (``_fa.train_shapes``)."""
    return (all(type(t) is torch.Tensor and t.is_cuda for t in (q, k, v))
            and _fa.train_shapes(q, k, v))


def decode_attention_plain(q, ck, cv, kv_valid: int, KH: int, hd: int,
                           block: int = 2048, kv_heads=None):
    """Single-token attention against the KV cache, online softmax over
    chunks of ``min(block, C)`` slots: the plain version of
    ``decode_attention``, on any device.

    q: (B, 1, H, hd); ck/cv: (B, C, KH*hd) flattened cache, of the
    cache's dtype (f32 in serving, where q is bf16 at full width: JAX
    promotes the products to f32, and so does this function).  GQA by
    head repeat, or ``kv_heads`` as in ``_online_attention``.
    """
    B, _, H, _ = q.shape
    C = ck.shape[1]
    block = min(block, C)
    if C % block:
        raise ValueError(f"cache length {C} not divisible by block {block}")
    rep = H // KH if kv_heads is None else 1
    # JAX rounds the weak-typed scale to q's dtype before multiplying
    scale = torch.tensor(hd ** -0.5, dtype=q.dtype).item()
    qf = (q[:, 0] * scale).float()                          # (B, H, hd)

    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, hd), dtype=torch.float32, device=q.device)
    for start in range(0, C, block):
        kc = split_last(ck[:, start:start + block], KH)
        vc = split_last(cv[:, start:start + block], KH)
        if kv_heads is not None:
            kc, vc = kc.index_select(2, kv_heads), vc.index_select(2, kv_heads)
        elif rep > 1:
            kc = kc.repeat_interleave(rep, dim=2)
            vc = vc.repeat_interleave(rep, dim=2)
        sc = torch.einsum("bhd,bkhd->bhk", qf, kc.float())  # (B, H, block)
        pos = torch.arange(start, start + block, device=q.device)
        sc = sc.masked_fill(~(pos < kv_valid)[None, None, :], NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        pch = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + pch.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhk,bkhd->bhd", pch.to(vc.dtype).float(), vc.float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out[:, None].to(q.dtype)                         # (B, 1, H, hd)


def decode_attention(q, ck, cv, kv_valid: int, KH: int, hd: int, *,
                     block: int = 2048, kv_heads=None):
    """Attention of one query token a row against the live slots ``[0,
    kv_valid)`` of the KV cache.  q: (B, 1, H, hd); ck/cv: (B, C, KH*hd),
    the flattened cache; query head h reads K/V head ``kv_heads[h]``, or
    ``h // (H // KH)`` without a map.  Returns (B, 1, H, hd) in q's dtype.

    Plain CUDA tensors take the split-KV kernel
    (``csrc/decode_attention.cu``), two launches a call, which reads the
    cache in place, each K/V tile once for all the query heads that read
    it, and takes any cache length (``block`` is the plain version's);
    ``decode_attention.launches`` counts the calls that launched it.
    Everything else takes ``decode_attention_plain``: CPU tensors, and
    fake and meta tensors, whose ops the dry run traces and counts.
    """
    if _dec.takes(q):
        out = _dec.launch(q, ck, cv, kv_valid, KH, hd, kv_heads=kv_heads)
        decode_attention.launches += 1
        return out
    return decode_attention_plain(q, ck, cv, kv_valid, KH, hd, block=block,
                                  kv_heads=kv_heads)


decode_attention.launches = 0


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
