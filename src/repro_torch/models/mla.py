"""Multi-head latent attention (MLA, DeepSeek-V2/V3), as Moonlight runs it:
no query compression, one latent for K and V.

With H heads, ``dn = qk_nope_head_dim``, ``dr = qk_rope_head_dim``,
``dv = v_head_dim`` and ``r = kv_lora_rank``:

* q = x W_q, H heads of (dn + dr), the last dr of each rotated;
* [c, k_r] = x W_kva: the latent c (r) and one rotated key k_r (dr) that
  every head shares;
* [k_nope, v] = RMSNorm(c) W_kvb, H heads of (dn + dv);
* softmax(q k^T / sqrt(dn + dr)), causal, over v, with k = [k_nope, k_r];
  then W_o (H dv -> D).  No biases.

RoPE is the port's split-half convention (``layers.apply_rope``) over the
dr rotated dims; DeepSeek's checkpoints pair interleaved dims, a
permutation of W_q's and W_kva's rotary columns that changes no work.
The core goes through ``layers._online_attention``, which takes a value
width other than the query's (its scale comes from q's).  Training only:
serving would need the latent cache (C x (r + dr) a layer, W_kvb absorbed
into q), which the port does not have (``config.refuse_mla``).
"""
from __future__ import annotations

import torch

from repro_torch import spans
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import merge_last, project, split_last


def init_mla(generator, cfg: ModelConfig, dtype, device):
    """Random weights at the port's scales (fan-in^-0.5), the latent's
    norm scale at 1."""
    D, H = cfg.d_model, cfg.num_heads
    dn, dr, dv, r = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim, cfg.kv_lora_rank)
    return {
        "wq": L.dense_init(generator, (D, H * (dn + dr)), dtype, device),
        "wkv_a": L.dense_init(generator, (D, r + dr), dtype, device),
        "kv_norm": {"scale": torch.ones((r,), dtype=torch.float32,
                                        device=device)},
        "wkv_b": L.dense_init(generator, (r, H * (dn + dv)), dtype, device),
        "wo": L.dense_init(generator, (H * dv, D), dtype, device),
    }


def apply_mla(p, x, cfg: ModelConfig, *, positions):
    """Causal self-attention of x (B, S, D) at ``positions`` -> (B, S, D)."""
    B, S, _ = x.shape
    H, dn, dr, r = (cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                    cfg.kv_lora_rank)
    q = split_last(project(x, p["wq"]), H)                  # (B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    kva = project(x, p["wkv_a"])
    c, k_rope = kva[..., :r], kva[..., r:]
    c = L.apply_norm(p["kv_norm"], c, cfg)
    kv = split_last(project(c, p["wkv_b"]), H)              # (B, S, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = L.apply_rope(k_rope[:, :, None], positions, cfg.rope_theta)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    with spans.span("attention.core"):
        out = L._online_attention(q, k, v, 0, causal=True, window=None)
    return project(merge_last(out), p["wo"])
