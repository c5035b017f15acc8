"""Mixture-of-Experts layer (granite-moe, qwen2-moe style).

Port of ``repro.models.moe``, as plain functions on dicts of tensors.
Three implementations of the expert MLP compute the same function:

* ``dense`` — every expert computes every token, as a loop over the
  experts; the router's combine weights fold in before each expert's
  down projection, so the output accumulates straight into (T, D) and no
  (T, E, F) tensor is formed.  The JAX package's serving and training
  stages run this one.
* ``ragged`` — (token, expert) pairs sorted by expert, one product per
  expert's group of rows.  JAX runs ``jax.lax.ragged_dot``, an XLA op, not
  a Pallas kernel; here each group is a ``torch.matmul`` on its rows.
* ``capacity`` — Switch-style dispatch into (E, C, D) buffers of at most
  C tokens an expert.

The router runs in f32: softmax, top-k, the top-k weights renormalised,
and the Switch auxiliary loss ``E * sum_e frac_tokens_e * mean_prob_e``.
``jax.nn.gelu`` is the tanh form.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init
from repro_torch.parallel.sharding import project, reshape, shard


def init_moe(generator, cfg: ModelConfig, dtype, device):
    """Random weights at the JAX package's scales.  ``dense_init``'s fan-in
    is the first axis, so the (E, D, F) expert weights draw at E^-0.5, as
    in JAX."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": dense_init(generator, (D, E), torch.float32, device,
                             scale=0.02),
        "w_gate": dense_init(generator, (E, D, Fd), dtype, device),
        "w_up": dense_init(generator, (E, D, Fd), dtype, device),
        "w_down": dense_init(generator, (E, Fd, D), dtype, device),
    }
    if cfg.num_shared_experts:
        Fs = Fd * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init(generator, (D, Fs), dtype, device),
            "w_up": dense_init(generator, (D, Fs), dtype, device),
            "w_down": dense_init(generator, (Fs, D), dtype, device),
        }
    return p


def _act(g, cfg: ModelConfig):
    return F.silu(g) if cfg.mlp_type == "swiglu" else F.gelu(g, approximate="tanh")


def _route(p, x, cfg: ModelConfig):
    """x: (T, D) -> (combine (T, E), topi (T, k), topv (T, k), aux).

    ``jax.lax.top_k`` breaks ties toward the lower index and
    ``torch.topk`` promises no order among ties; router probabilities
    from continuous inputs do not tie."""
    logits = project(x.float(), p["router"])                # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    topv = topv / topv.sum(dim=-1, keepdim=True)            # renormalise
    combine = torch.zeros_like(probs).scatter(1, topi, topv)
    frac = (combine > 0).float().mean(dim=0)
    aux = cfg.num_experts * (frac * probs.mean(dim=0)).sum()
    return combine, topi, topv, aux


def _expert_mlp_dense(p, x, combine, cfg: ModelConfig):
    """Every expert on every token, experts in order as JAX's scan.
    x: (T, D); combine: (T, E)."""
    cw = combine.T.to(x.dtype)                              # (E, T)
    out = torch.zeros_like(x)
    for e in range(cfg.num_experts):
        g = shard(project(x, p["w_gate"][e]), "batch", "tp")
        h = _act(g, cfg) * project(x, p["w_up"][e])              # (T, F)
        h = h * cw[e][:, None].to(h.dtype)
        out = out + project(h, p["w_down"][e])
    return out


def _sorted_pairs(topi, topv, T: int):
    """(token, expert) pairs sorted by expert, stably as ``jnp.argsort``:
    (experts, tokens, weights) in that order."""
    k = topi.shape[1]
    flat_t = torch.arange(T, device=topi.device).repeat_interleave(k)
    order = torch.argsort(topi.reshape(-1), stable=True)
    return topi.reshape(-1)[order], flat_t[order], topv.reshape(-1)[order]


def _grouped(xs, w, sizes):
    """``jax.lax.ragged_dot``: rows of ``xs`` in consecutive groups of
    ``sizes``, group e times ``w[e]``."""
    out = xs.new_empty((xs.shape[0], w.shape[-1]))
    start = 0
    for e, n in enumerate(sizes):
        if n:
            out[start:start + n] = xs[start:start + n] @ w[e]
        start += n
    return out


def _expert_mlp_ragged(p, x, topi, topv, cfg: ModelConfig):
    """Active pairs only: FLOPs ~ T * topk * D * F instead of T * E * D * F."""
    se, st, sw = _sorted_pairs(topi, topv, x.shape[0])
    xs = x[st]                                              # (T*k, D)
    sizes = torch.bincount(se, minlength=cfg.num_experts).tolist()
    g = _grouped(xs, p["w_gate"], sizes)
    u = _grouped(xs, p["w_up"], sizes)
    y = _grouped((_act(g, cfg) * u).to(xs.dtype), p["w_down"], sizes)
    y = y * sw[:, None].to(y.dtype)
    return torch.zeros_like(x).index_add(0, st, y)          # .at[st].add


def _expert_mlp_capacity(p, x, topi, topv, cfg: ModelConfig,
                         capacity_factor: float = 2.0):
    """Each expert takes at most C = capacity_factor * T * topk / E of its
    pairs (at least 8), in sorted order; the rest are dropped.

    Only the pairs kept are written into the (E, C, D) buffer.  JAX writes
    every pair, a dropped one as zeros into its expert's slot 0, where a
    kept pair also lies: with duplicate indices ``.at[].set`` leaves the
    winner unspecified, so JAX may zero that kept pair.  The two agree
    whenever no expert overflows."""
    T, D = x.shape
    E = cfg.num_experts
    C = max(8, int(capacity_factor * T * cfg.num_experts_per_tok / E))
    se, st, sw = _sorted_pairs(topi, topv, T)
    counts = torch.bincount(se, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(se.shape[0], device=x.device) - starts[se]
    keep = pos < C
    buf = x.new_zeros((E, C, D))
    buf[se[keep], pos[keep]] = x[st[keep]]
    g = shard(torch.einsum("ecd,edf->ecf", buf, p["w_gate"]), None, None, "tp")
    h = _act(g, cfg) * torch.einsum("ecd,edf->ecf", buf, p["w_up"])
    y = torch.einsum("ecf,efd->ecd", h, p["w_down"])        # (E, C, D)
    wk = sw[keep][:, None].to(y.dtype)
    return torch.zeros_like(x).index_add(0, st[keep], y[se[keep], pos[keep]] * wk)


def apply_moe(p, x, cfg: ModelConfig, impl: str = "dense"):
    """x: (B, S, D) -> (out (B, S, D), aux loss).  ``p`` is read by key:
    a dict, or the model's ``ParamTree``.

    The MoE block runs with the sequence dim *gathered* (no seq sharding):
    merging a batch-sharded dim with a seq-sharded dim would force
    pathological resharding of the (T, E, F) expert tensors.  The
    surrounding block re-applies the sequence-parallel constraint."""
    x = shard(x, "batch", None, None)
    B, S, D = x.shape
    xt = reshape(x, B * S, D)
    combine, topi, topv, aux = _route(p, xt, cfg)
    if impl == "ragged":
        out = _expert_mlp_ragged(p, xt, topi, topv, cfg)
    elif impl == "capacity":
        out = _expert_mlp_capacity(p, xt, topi, topv, cfg)
    elif impl == "dense":
        out = _expert_mlp_dense(p, xt, combine, cfg)
    else:
        raise ValueError(f"moe impl {impl!r}: dense, ragged or capacity")
    if cfg.num_shared_experts:
        sp = p["shared"]
        out = out + project(_act(project(xt, sp["w_gate"]), cfg)
                            * project(xt, sp["w_up"]), sp["w_down"])
    return reshape(out, B, S, D), aux
