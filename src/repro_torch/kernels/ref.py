"""Plain PyTorch oracles of the port's kernels.

``attention_reference`` is the flash kernel's plain version: the tests
hold the kernel against it, and a CPU tensor runs it in place of the
kernel.  ``ssd_chunked``, the port of ``repro.models.ssm.ssd_chunked``
(re-exported by ``models/ssm.py``), is the SSD kernel's plain version;
``ssd_reference``, the sequential recurrence, is only the tests' oracle.
The CUDA path never calls these.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_reference(q, k, v, *, causal: bool = True, window=None):
    """q, k, v: (BH, S, D) — plain softmax attention, f32 math.

    Counterpart of ``repro.kernels.ref.attention_reference``; returns the
    input dtype.
    """
    BH, S, D = q.shape
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (D ** -0.5)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def ssd_chunked(x, dt, A, B, C, h0=None, chunk: int = 64, CB=None):
    """Chunked SSD: O(S*Q) intra-chunk products + O(S/Q) sequential carry.

    x (b, S, H, P); dt (b, S, H); A (H,); B, C (b, S, N); h0 (b, H, P, N)
    or None.  Returns y (b, S, H, P) in x's dtype and h_final
    (b, H, P, N) f32, as ``repro.models.ssm.ssd_chunked``.  ``CB``, the
    chunks' C Bᵀ (b, S / chunk, chunk, chunk) f32, computed once for all
    heads (``chunk_products``), takes the place of each chunk's product.
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    assert S % chunk == 0, f"S={S} % chunk={chunk}"
    nc = S // chunk
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)

    xf = x.float().reshape(b, nc, chunk, H, P)
    dtf = dt.float().reshape(b, nc, chunk, H)
    Bf = B.float().reshape(b, nc, chunk, N)
    Cf = C.float().reshape(b, nc, chunk, N)

    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]   # s <= t

    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        L = torch.cumsum(dtc * A, dim=1)           # inclusive log decay (b,Q,H)
        # intra-chunk: M[t,s] = exp(L[t]-L[s]) * dt[s] * (C[t].B[s]), s<=t
        CB_c = (torch.einsum("btn,bsn->bts", Cc, Bc) if CB is None
                else CB[:, c])
        delta = L[:, :, None, :] - L[:, None, :, :]                # (b,t,s,H)
        # mask the exponent *before* exp: the s>t half would overflow
        delta = torch.where(causal, delta, 0.0)
        M = CB_c[..., None] * torch.exp(delta) * dtc[:, None, :, :]
        M = torch.where(causal, M, 0.0)
        y_intra = torch.einsum("btsh,bshp->bthp", M, xc)
        # contribution of the incoming state: y += exp(L[t]) * C[t] . h
        y_state = torch.einsum("bhpn,btn->bthp", h, Cc) * torch.exp(L)[..., None]
        # new state: h' = exp(L[Q-1]) h + sum_s exp(L[Q-1]-L[s]) dt_s x_s (x) B_s
        last = L[:, -1:, :]
        w = torch.exp(last - L) * dtc
        h = (torch.exp(last[:, 0])[:, :, None, None] * h
             + torch.einsum("bqh,bqhp,bqn->bhpn", w, xc, Bc))
        ys.append(y_intra + y_state)
    y = torch.stack(ys, dim=1).reshape(b, S, H, P)
    return y.to(x.dtype), h


def chunk_products(B, C, chunk: int, rows=None):
    """C Bᵀ within each chunk of ``chunk`` positions, f32: B, C (b, S, N)
    -> (b, S / chunk, chunk, chunk), ``ssd_chunked``'s per-chunk product.
    ``rows`` (offset, count): only those rows t of each chunk."""
    b, S, N = B.shape
    Bf = B.float().reshape(b, S // chunk, chunk, N)
    Cf = C.float().reshape(b, S // chunk, chunk, N)
    if rows is not None:
        Cf = Cf[:, :, rows[0]:rows[0] + rows[1]]
    return torch.einsum("bctn,bcsn->bcts", Cf, Bf)


def ssd_reference(x, dt, A, B, C, h0=None):
    """Sequential SSD recurrence, f32, one step per position.

    Counterpart of ``repro.models.ssm.ssd_reference``: x (b, S, H, P), dt
    (b, S, H), A (H,), B and C (b, S, N);
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t, y_t = h_t . C_t.
    Returns y (b, S, H, P) f32 and h_final (b, H, P, N) f32.
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    xf, dtf, Af, Bf, Cf = x.float(), dt.float(), A.float(), B.float(), C.float()
    ys = []
    for t in range(S):
        a = torch.exp(dtf[:, t] * Af)                               # (b, H)
        h = (a[..., None, None] * h
             + (dtf[:, t, :, None] * xf[:, t])[..., None] * Bf[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    return torch.stack(ys, dim=1), h


def ssd_scan_reference(x, dt, A, Bm, Cm):
    """Kernel-layout wrapper around ``ssd_reference``, as
    ``repro.kernels.ref.ssd_scan_reference``: x (B, H, S, P), dt (B, H, S),
    A (H,), Bm/Cm (B, S, N) -> (y (B, H, S, P) in x's dtype, h_final)."""
    y, hf = ssd_reference(x.transpose(1, 2), dt.transpose(1, 2), A, Bm, Cm)
    return y.transpose(1, 2).to(x.dtype), hf
