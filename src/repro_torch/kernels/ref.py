"""Plain PyTorch versions of the port's kernels.

The tests hold each kernel against these, and a CPU tensor runs them in
place of the kernel.  The CUDA path never calls them.
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
