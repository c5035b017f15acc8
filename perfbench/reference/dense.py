"""A dense decoder in plain PyTorch, f32: the published layer equations.

One layer: ``x + attn(LN1(x))``, then ``+ mlp(LN2(.))``.  Attention: Q, K,
V projections (with biases where ``qkv_bias``), rotary embedding of the
split-half (GPT-NeoX) convention at ``rope_theta`` on Q and K, GQA by
repeating each K/V head over its query heads, softmax(Q K^T / sqrt(hd))
with a causal mask (and the sliding window, where the configuration has
one), then the output projection.  MLP: GELU (tanh form) of ``x W_up``,
times ``W_down``; or SiLU/GELU-gated.  LayerNorm or RMSNorm with the
configuration's ``norm_eps``, population variance.  A final norm, then the
LM head: the embedding table transposed when tied.

Departures from the published models, each the configuration as the port
runs it: StarCoder2's output-projection and MLP biases are not there, its
norm epsilon is the port's 1e-6, not 1e-5, and its rotary base the port's
1e5, not the released 1e6; the GPT-like model takes rotary positions, as
the port gives every attention model.

Every product goes through a ``Precision``: ``F32`` is the reference (TF32
off, ``tf32_off``); ``FP8`` rounds both operands of every product to
float8 (e4m3, per-tensor scale; e5m2 for gradients), the control that a
lower precision has to fail.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

NORM_F32 = ("scale", "bias")


@contextlib.contextmanager
def tf32_off():
    """f32 products in f32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _q8(t: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    top = torch.finfo(dtype).max
    scale = top / t.detach().abs().amax().clamp_min(1e-30)
    return (t * scale).to(dtype).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q8(a), _q8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _q8(g, torch.float8_e5m2)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class Precision:
    """How the reference multiplies: ``linear`` (x (..., K) by w (K, N))
    and ``bmm`` (batched, equal leading dims)."""

    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def bmm(self, a, b):
        return _Fp8Matmul.apply(a, b) if self.fp8 else a @ b

    def linear(self, x, w):
        if not self.fp8:
            return x @ w
        return self.bmm(x.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], w.shape[-1])


F32, FP8 = Precision(False), Precision(True)


def layer_shapes(cfg: dict) -> Dict[str, Tuple[tuple, str]]:
    """One layer's leaves: path -> (shape, dtype name).  Norms are f32, the
    rest in the configuration's ``param_dtype``."""
    D, hd, Fd = cfg["d_model"], cfg["head_dim"], cfg["d_ff"]
    q, kv, dt = cfg["num_heads"] * hd, cfg["num_kv_heads"] * hd, cfg["param_dtype"]
    out = {"ln1/scale": ((D,), "float32"), "ln2/scale": ((D,), "float32"),
           "attn/wq": ((D, q), dt), "attn/wk": ((D, kv), dt),
           "attn/wv": ((D, kv), dt), "attn/wo": ((q, D), dt),
           "mlp/w_up": ((D, Fd), dt), "mlp/w_down": ((Fd, D), dt)}
    if cfg["norm_type"] == "layernorm":
        out["ln1/bias"] = out["ln2/bias"] = ((D,), "float32")
    if cfg.get("qkv_bias"):
        out.update({"attn/bq": ((q,), dt), "attn/bk": ((kv,), dt), "attn/bv": ((kv,), dt)})
    if cfg["mlp_type"] in ("swiglu", "geglu"):
        out["mlp/w_gate"] = ((D, Fd), dt)
    return out


def head_shapes(cfg: dict) -> Dict[str, Tuple[tuple, str]]:
    """The embedding, the final norm and (untied) the LM head."""
    D, V = cfg["d_model"], cfg["vocab_size"]
    out = {"embed/table": ((V, D), cfg["param_dtype"]), "final_norm/scale": ((D,), "float32")}
    if cfg["norm_type"] == "layernorm":
        out["final_norm/bias"] = ((D,), "float32")
    if not cfg.get("tie_embeddings"):
        out["embed/lm_head"] = ((D, V), cfg["param_dtype"])
    return out


def norm(p: dict, x, cfg: dict):
    eps = cfg["norm_eps"]
    if cfg["norm_type"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * p["scale"]


def rope(x, theta: float):
    """x (B, S, H, hd) at positions 0..S-1, split-half rotation."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p: dict, x, cfg: dict, pr: Precision):
    B, S, _ = x.shape
    H, KH, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q, k, v = (pr.linear(x, p[w]) for w in ("wq", "wk", "wv"))
    if cfg.get("qkv_bias"):
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.view(B, S, H, hd), cfg["rope_theta"]).transpose(1, 2)
    k = rope(k.view(B, S, KH, hd), cfg["rope_theta"]).transpose(1, 2)
    v = v.view(B, S, KH, hd).transpose(1, 2)
    k, v = k.repeat_interleave(H // KH, dim=1), v.repeat_interleave(H // KH, dim=1)
    scores = pr.bmm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    i = torch.arange(S, device=x.device)
    keep = i[None, :] <= i[:, None]
    if cfg.get("sliding_window"):
        keep &= i[None, :] > i[:, None] - cfg["sliding_window"]
    scores = scores.masked_fill(~keep, float("-inf"))
    out = pr.bmm(torch.softmax(scores, dim=-1), v)
    return pr.linear(out.transpose(1, 2).reshape(B, S, H * hd), p["wo"])


def mlp(p: dict, x, cfg: dict, pr: Precision):
    up = pr.linear(x, p["w_up"])
    if cfg["mlp_type"] == "gelu":
        return pr.linear(F.gelu(up, approximate="tanh"), p["w_down"])
    gate = pr.linear(x, p["w_gate"])
    act = F.silu(gate) if cfg["mlp_type"] == "swiglu" else F.gelu(gate, approximate="tanh")
    return pr.linear(act * up, p["w_down"])


def layer(p: dict, x, cfg: dict, pr: Precision):
    x = x + attention(p["attn"], norm(p["ln1"], x, cfg), cfg, pr)
    return x + mlp(p["mlp"], norm(p["ln2"], x, cfg), cfg, pr)


def hidden(layers: List[dict], head: dict, tokens, cfg: dict, pr: Precision):
    """The final-normed hidden states (B, S, D) of ``tokens`` (B, S)."""
    x = head["embed"]["table"][tokens]
    for p in layers:
        x = layer(p, x, cfg, pr)
    return norm(head["final_norm"], x, cfg)


def logits(head: dict, h, cfg: dict, pr: Precision):
    w = head["embed"]["table"].T if cfg.get("tie_embeddings") else head["embed"]["lm_head"]
    return pr.linear(h, w)


def loss(layers: List[dict], head: dict, tokens, labels, cfg: dict, pr: Precision):
    """Mean cross-entropy of the next tokens ``labels`` over all positions."""
    z = logits(head, hidden(layers, head, tokens, cfg, pr), cfg, pr)
    return F.cross_entropy(z.reshape(-1, z.shape[-1]), labels.reshape(-1))


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """``{"a/b": t}`` -> ``{"a": {"b": t}}``."""
    out: dict = {}
    for key, t in flat.items():
        node = out
        *path, leaf = key.split("/")
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = t
    return out
