"""Mixture-of-Experts layer (granite-moe, qwen2-moe, DeepSeek-V3 style).

Port of ``repro.models.moe``, as plain functions on dicts of tensors.
Three implementations of the expert MLP compute the same function:

* ``dense`` — every expert computes every token, as a loop over the
  experts; the router's combine weights fold in before each expert's
  down projection, so the output accumulates straight into (T, D) and no
  (T, E, F) tensor is formed.  The JAX package's serving and training
  stages run this one; the port serves with it.
* ``ragged`` — token-routed: (token, expert) pairs sorted by expert on
  the device, each product one grouped GEMM over the experts' groups of
  rows, the weighted results put back in (token, choice) order and summed
  over the choices.  The port's training stages run this one: the work of
  k experts a token, not E.  On the card a bf16 product is
  ``torch._grouped_mm`` with the group ends on the device, so nothing
  waits on the host; elsewhere it is a loop over the experts.  JAX runs
  ``jax.lax.ragged_dot``, an XLA op, not a Pallas kernel.
* ``capacity`` — Switch-style dispatch into (E, C, D) buffers of at most
  C tokens an expert.

The router runs in f32.  ``router_score="softmax"``: softmax, top-k, the
top-k weights renormalised, and the Switch auxiliary loss ``E * sum_e
frac_tokens_e * mean_prob_e``.  ``"sigmoid"`` (DeepSeek-V3's noaux_tc with
one group): s = sigmoid(x W_r), the top k of s + b chosen, ``b`` a
per-expert bias that only the choice reads (zero at init; no balance rule
moves it, only AdamW's decay of a stacked stage leaf), the chosen s
renormalised where ``norm_topk_prob``; the auxiliary loss then reads the
per-token normalised scores.  The weights are times
``routed_scaling_factor``.
``jax.nn.gelu`` is the tanh form.

While tracing is on (``repro_torch.spans``), a layer given a ``layer``
(its position in the stage) adds its routed pairs per expert to a counter
on the device, keyed by that position and the open span's ``stage`` id;
``drain_expert_load_max`` reads them once.  With tracing off nothing is
counted or read.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import spans
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
    if cfg.router_score == "sigmoid":
        p["bias"] = torch.zeros((E,), dtype=torch.float32, device=device)
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
    k = cfg.num_experts_per_tok
    if cfg.router_score == "sigmoid":
        scores = torch.sigmoid(logits)
        topi = torch.topk(scores + p["bias"], k, dim=-1).indices
        topv = scores.gather(1, topi)
        probs = scores / scores.sum(dim=-1, keepdim=True)
    else:
        probs = torch.softmax(logits, dim=-1)
        topv, topi = torch.topk(probs, k, dim=-1)
    if cfg.norm_topk_prob:
        topv = topv / topv.sum(dim=-1, keepdim=True)        # renormalise
    if cfg.routed_scaling_factor != 1.0:
        topv = topv * cfg.routed_scaling_factor
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


def _grouped(xs, w, ends):
    """``jax.lax.ragged_dot``: rows of ``xs`` in consecutive groups, group
    e ending at row ``ends[e]``, times ``w[e]``.  A bf16 product on the
    card is one grouped GEMM, ``torch._grouped_mm`` (sm90; its backward is
    two grouped GEMMs of the same groups), the group ends read on the
    device; otherwise a loop over the groups, which reads the ends on the
    host."""
    if xs.is_cuda and xs.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
        return torch._grouped_mm(xs, w, offs=ends.to(torch.int32))
    out = xs.new_empty((xs.shape[0], w.shape[-1]))
    start = 0
    for we, end in zip(w.unbind(0), ends.tolist()):
        if end > start:
            out[start:end] = xs[start:end] @ we
        start = end
    return out


def _expert_mlp_ragged(p, x, topi, topv, cfg: ModelConfig):
    """Active pairs only: FLOPs ~ T * topk * D * F instead of T * E * D * F.
    The pairs sorted by expert, each group's end found by a search of the
    sorted experts; each pair's result put back in its (token, choice)
    slot, weighted, and the choices summed: no atomics, no host sync on
    the card."""
    T, k = topi.shape
    flat = topi.reshape(-1)
    order = torch.argsort(flat, stable=True)
    ends = torch.searchsorted(flat[order], torch.arange(
        cfg.num_experts, device=x.device), right=True)
    xs = x[order // k]                                      # (T*k, D)
    g = _grouped(xs, p["w_gate"], ends)
    u = _grouped(xs, p["w_up"], ends)
    y = _grouped((_act(g, cfg) * u).to(xs.dtype), p["w_down"], ends)
    y = torch.empty_like(y).index_copy(0, order, y).view(T, k, -1)
    return (y * topv.to(y.dtype)[..., None]).sum(dim=1)


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


_loads: Dict[tuple, torch.Tensor] = {}


def _record_load(layer: Optional[int], topi, E: int) -> None:
    """Add the routed pairs per expert to the counter of the open span's
    stage and the stage's ``layer``-th block, on the device, while tracing
    is on."""
    if layer is None or not spans.enabled():
        return
    key = (spans.ids().get("stage"), layer)
    counts = torch.zeros(E, dtype=torch.int64, device=topi.device).index_add_(
        0, topi.reshape(-1), torch.ones_like(topi.reshape(-1)))
    _loads[key] = counts if key not in _loads else _loads[key] + counts


def drain_expert_load_max() -> Optional[float]:
    """The worst layer's most-loaded expert over its mean load, over what
    the counters gathered since the last drain (one read of the device);
    None where nothing was counted.  The counters are cleared."""
    if not _loads:
        return None
    loads = torch.stack(list(_loads.values())).float()
    _loads.clear()
    return float((loads.amax(dim=1) / loads.mean(dim=1)).max())


def apply_moe(p, x, cfg: ModelConfig, impl: str = "dense",
              layer: Optional[int] = None):
    """x: (B, S, D) -> (out (B, S, D), aux loss).  ``p`` is read by key:
    a dict, or the model's ``ParamTree``.  ``layer``, the layer's position
    in its stage, keys its load counter.

    The MoE block runs with the sequence dim *gathered* (no seq sharding):
    merging a batch-sharded dim with a seq-sharded dim would force
    pathological resharding of the (T, E, F) expert tensors.  The
    surrounding block re-applies the sequence-parallel constraint."""
    x = shard(x, "batch", None, None)
    B, S, D = x.shape
    xt = reshape(x, B * S, D)
    with spans.span("moe.route"):
        combine, topi, topv, aux = _route(p, xt, cfg)
        _record_load(layer, topi, cfg.num_experts)
    with spans.span("moe.experts"):
        if impl == "ragged":
            out = _expert_mlp_ragged(p, xt, topi, topv, cfg)
        elif impl == "capacity":
            out = _expert_mlp_capacity(p, xt, topi, topv, cfg)
        elif impl == "dense":
            out = _expert_mlp_dense(p, xt, combine, cfg)
        else:
            raise ValueError(f"moe impl {impl!r}: dense, ragged or capacity")
    if cfg.num_shared_experts:
        with spans.span("moe.shared"):
            sp = p["shared"]
            out = out + project(_act(project(xt, sp["w_gate"]), cfg)
                                * project(xt, sp["w_up"]), sp["w_down"])
    return reshape(out, B, S, D), aux
