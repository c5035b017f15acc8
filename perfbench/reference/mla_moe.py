"""A DeepSeek-V3 decoder (Moonlight-16B-A3B) in plain PyTorch, f32: the
published layer equations, and a GWTF stage trainer over them.

One layer: ``x + attn(norm1(x))``, then ``+ ffn(norm2(.))``, RMSNorm with
the configuration's ``norm_eps``.  With H heads, dn = ``qk_nope_head_dim``,
dr = ``qk_rope_head_dim``, dv = ``v_head_dim``, r = ``kv_lora_rank``:

* attention (MLA, no query compression): q = x W_q, H heads of dn + dr;
  [c, k_r] = x W_kva; [k_nope, v] = RMSNorm(c) W_kvb, H heads of dn + dv;
  rotary positions at ``rope_theta`` on the last dr of each query head and
  on k_r, one key all heads share; softmax(q k^T / sqrt(dn + dr)) with a
  causal mask over v, k = [k_nope, k_r]; then W_o.  No biases;
* the first ``first_dense_layers`` layers: a SwiGLU MLP of width
  ``dense_d_ff``;
* the others (DeepSeekMoE): s = sigmoid(x W_r); the ``num_experts_per_tok``
  experts of the largest s + b, ``b`` a per-expert bias that only the
  choice reads; their weights the chosen s over their sum
  (``norm_topk_prob``), times ``routed_scaling_factor``; each chosen
  expert a SwiGLU of width ``d_ff`` on its own tokens, the weighted outputs
  summed; plus the shared experts, one SwiGLU of width ``d_ff`` times
  ``num_shared_experts`` on every token.

A final RMSNorm, then the untied LM head.  Departures from the published
model, each the configuration as the port runs it: the rotary dims are
paired split-half (GPT-NeoX), where DeepSeek's checkpoints pair interleaved
dims, a permutation of W_q's and W_kva's rotary columns; ``b`` is given, as
the run started from it, and no balance rule moves it (DeepSeek-V3's
moves it every step); no auxiliary balance loss joins the loss.  The weights' sum has no 1e-20
added to its denominator (sigmoid scores are positive).

Every product goes through a ``dense.Precision``: ``F32`` is the reference
(TF32 off, ``dense.tf32_off``); ``FP8`` the control, the router's product
too: ``dense.FP8``'s rounding (e4m3 operands, e5m2 gradients, per-tensor
scales), which here keeps a product's operands and rounds them again in
the backward, where ``dense.FP8`` keeps f32 copies of the rounded ones (a
copy of every weight, which a stage of 2.4 B parameters has no room for).  ``Trainer`` is ``reference/gwtf.py``'s iteration over these layers:
a stage's tree keys each leaf by its kind, ``dense/...`` or ``moe/...``,
stacked along the kind's layers.

``choose``, None here, is a hook for a tool alone: a function of a MoE
call's biased scores (T, E) that returns the chosen experts (T, k) in
place of their top k, so that the reference can replay another run's
choices (``tools/moe_choice_flips.py``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import dense, gwtf

F32 = dense.F32
choose = None


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return dense._q8(a) @ dense._q8(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        qa, qb, qg = dense._q8(a), dense._q8(b), dense._q8(g, torch.float8_e5m2)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class _Fp8(dense.Precision):
    def bmm(self, a, b):
        return _Fp8Matmul.apply(a, b)


FP8 = _Fp8(True)


def stage_kinds(cfg: dict, layers: range) -> List[Tuple[str, range]]:
    """The stage's layers as runs of one kind, dense then moe, those present."""
    cut = min(max(cfg["first_dense_layers"], layers.start), layers.stop)
    runs = [("dense", range(layers.start, cut)), ("moe", range(cut, layers.stop))]
    return [(kind, r) for kind, r in runs if len(r)]


def layer_shapes(cfg: dict, kind: str) -> Dict[str, Tuple[tuple, str]]:
    """One layer's leaves of ``kind``: path -> (shape, dtype name).  Norms,
    the router and its bias f32, the rest in ``param_dtype``."""
    D, H, dt = cfg["d_model"], cfg["num_heads"], cfg["param_dtype"]
    dn, dr, dv, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                     cfg["kv_lora_rank"])
    out = {"ln1/scale": ((D,), "float32"), "ln2/scale": ((D,), "float32"),
           "attn/wq": ((D, H * (dn + dr)), dt), "attn/wkv_a": ((D, r + dr), dt),
           "attn/kv_norm/scale": ((r,), "float32"), "attn/wkv_b": ((r, H * (dn + dv)), dt),
           "attn/wo": ((H * dv, D), dt)}
    if kind == "dense":
        Fd = cfg["dense_d_ff"]
        out.update({"mlp/w_gate": ((D, Fd), dt), "mlp/w_up": ((D, Fd), dt),
                    "mlp/w_down": ((Fd, D), dt)})
        return out
    E, Fe = cfg["num_experts"], cfg["d_ff"]
    Fs = Fe * cfg["num_shared_experts"]
    out.update({"moe/router": ((D, E), "float32"), "moe/bias": ((E,), "float32"),
                "moe/w_gate": ((E, D, Fe), dt), "moe/w_up": ((E, D, Fe), dt),
                "moe/w_down": ((E, Fe, D), dt),
                "moe/shared/w_gate": ((D, Fs), dt), "moe/shared/w_up": ((D, Fs), dt),
                "moe/shared/w_down": ((Fs, D), dt)})
    return out


def attention(p: dict, x, cfg: dict, pr: dense.Precision):
    B, S, _ = x.shape
    H, dn, dr, dv, r = (cfg["num_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                        cfg["v_head_dim"], cfg["kv_lora_rank"])
    q = pr.linear(x, p["wq"]).view(B, S, H, dn + dr)
    kva = pr.linear(x, p["wkv_a"])
    c, k_rope = kva[..., :r], kva[..., r:]
    kv = pr.linear(dense.norm(p["kv_norm"], c, cfg), p["wkv_b"]).view(B, S, H, dn + dv)
    q = torch.cat([q[..., :dn], dense.rope(q[..., dn:], cfg["rope_theta"])], dim=-1)
    k_rope = dense.rope(k_rope.view(B, S, 1, dr), cfg["rope_theta"]).expand(B, S, H, dr)
    k = torch.cat([kv[..., :dn], k_rope], dim=-1)
    v = kv[..., dn:]
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    scores = pr.bmm(q, k.transpose(-1, -2)) / math.sqrt(dn + dr)
    i = torch.arange(S, device=x.device)
    scores = scores.masked_fill(i[None, :] > i[:, None], float("-inf"))
    out = pr.bmm(torch.softmax(scores, dim=-1), v)
    return pr.linear(out.transpose(1, 2).reshape(B, S, H * dv), p["wo"])


def swiglu(x, w_gate, w_up, w_down, pr: dense.Precision):
    return pr.linear(F.silu(pr.linear(x, w_gate)) * pr.linear(x, w_up), w_down)


def moe(p: dict, x, cfg: dict, pr: dense.Precision):
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    scores = torch.sigmoid(pr.linear(xt, p["router"]))
    biased = scores + p["bias"]
    chosen = (torch.topk(biased, cfg["num_experts_per_tok"], dim=-1).indices
              if choose is None else choose(biased))
    weight = scores.gather(1, chosen)
    if cfg["norm_topk_prob"]:
        weight = weight / weight.sum(-1, keepdim=True)
    weight = weight * cfg["routed_scaling_factor"]
    out = torch.zeros_like(xt)
    experts = zip(p["w_gate"].unbind(0), p["w_up"].unbind(0), p["w_down"].unbind(0))
    for e, (w_gate, w_up, w_down) in enumerate(experts):
        token, slot = (chosen == e).nonzero(as_tuple=True)
        if len(token):
            y = swiglu(xt[token], w_gate, w_up, w_down, pr)
            out = out.index_add(0, token, y * weight[token, slot, None])
    s = p["shared"]
    out = out + swiglu(xt, s["w_gate"], s["w_up"], s["w_down"], pr)
    return out.view(B, S, D)


def layer(p: dict, x, cfg: dict, pr: dense.Precision, kind: str):
    x = x + attention(p["attn"], dense.norm(p["ln1"], x, cfg), cfg, pr)
    h = dense.norm(p["ln2"], x, cfg)
    if kind == "dense":
        m = p["mlp"]
        return x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"], pr)
    return x + moe(p["moe"], h, cfg, pr)


def loss(layers: List[Tuple[str, dict]], head: dict, tokens, labels, cfg: dict,
         pr: dense.Precision):
    """Mean cross-entropy of the next tokens ``labels``; ``layers`` a list of
    (kind, parameters)."""
    x = head["embed"]["table"][tokens]
    for kind, p in layers:
        x = layer(p, x, cfg, pr, kind)
    z = dense.logits(head, dense.norm(head["final_norm"], x, cfg), cfg, pr)
    return F.cross_entropy(z.reshape(-1, z.shape[-1]), labels.reshape(-1))


def _unstack(tree: dict, n: int) -> List[dict]:
    """The per-layer trees of a tree stacked along its leading axis (one
    ``unbind`` a leaf, whose backward stacks the layers' gradients once)."""
    parts = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


class Trainer(gwtf.Trainer):
    """``gwtf.Trainer``'s iteration over these layers: the same means,
    clip and AdamW (``gwtf._adamw``), a leaf that no loss reads (the
    choice's bias) taking a zero gradient."""

    def _layers(self) -> List[Tuple[str, dict]]:
        out = []
        for s, layers in enumerate(self.stages):
            nested = dense.nest(self.trees[f"stage{s}"])
            for kind, run in stage_kinds(self.cfg, layers):
                out += [(kind, p) for p in _unstack(nested[kind], len(run))]
        return out

    def iteration(self, completed):
        if not completed:
            return float("nan"), {}
        layers = self._layers()
        per_dn: Dict[int, int] = {}
        for dn, _, _ in completed:
            per_dn[dn] = per_dn.get(dn, 0) + 1
        total = 0.0
        for dn, tokens, labels in completed:
            head = dense.nest(self.trees[f"head{dn}"])
            rows = tokens.shape[0]
            for lo in range(0, rows, gwtf.ROWS):
                part = slice(lo, min(lo + gwtf.ROWS, rows))
                part_loss = loss(layers, head, tokens[part], labels[part], self.cfg, self.pr)
                part_loss = part_loss * (tokens[part].shape[0] / rows)
                total += float(part_loss.detach())
                part_loss.backward()
        grads = {}
        for name, tree in self.trees.items():
            n = len(completed) if name.startswith("stage") else per_dn.get(int(name[4:]), 0)
            if n == 0:
                for t in tree.values():
                    t.grad = None
                continue
            g = {k: torch.zeros_like(t) if t.grad is None else t.grad / n
                 for k, t in tree.items()}
            for t in tree.values():
                t.grad = None
            gnorm = torch.sqrt(sum(x.square().sum() for x in g.values()))
            scale = torch.clamp(self.opt["grad_clip"] / (gnorm + 1e-9), max=1.0)
            g = {k: x * scale for k, x in g.items()}
            self.steps[name] += 1
            with torch.no_grad():
                for k, t in tree.items():
                    gwtf._adamw(t, g[k], self.m[name][k], self.v[name][k], self.steps[name],
                                self.opt)
            grads[name] = g
        return total / len(completed), grads
