"""Core neural layers of the dense decoder: norms, RoPE, MLP, attention,
embeddings.

Port of ``repro.models.layers`` (dense parts).  Parameters are dicts of
tensors (``nn.ParameterDict`` inside the model); the apply functions take
them and plain tensors.  Causal self-attention goes through
``kernels.ops.flash_attention``: the hand-written kernel on CUDA, its
plain version on the CPU; the training stages pass ``use_kernel=False``
and take ``_online_attention``, which autograd differentiates.
Single-token decode against the KV cache has no kernel and stays plain
PyTorch.  ``chunked_xent_loss`` is the training loss head.

Where JAX computes a product of low-precision operands with
``preferred_element_type=f32`` or promotes mixed dtypes, the port casts
both operands to f32 first: ``torch.matmul`` neither promotes mixed
dtypes nor returns f32 for bf16 inputs.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    fan_in = shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device):
    d = cfg.d_model
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(p, x, cfg: ModelConfig, eps: float = 1e-6):
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)   # jnp.var: population
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split-half convention, f32, absolute positions)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) or (S,)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    angles = positions[..., None].float() * freqs           # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (dense)
# ---------------------------------------------------------------------------

def init_mlp(generator, cfg: ModelConfig, dtype, device):
    D, Fd = cfg.d_model, cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(generator, (D, Fd), dtype, device),
            "w_up": dense_init(generator, (D, Fd), dtype, device),
            "w_down": dense_init(generator, (Fd, D), dtype, device),
        }
    return {
        "w_up": dense_init(generator, (D, Fd), dtype, device),
        "w_down": dense_init(generator, (Fd, D), dtype, device),
    }


def apply_mlp(p, x, cfg: ModelConfig):
    # jax.nn.gelu defaults to the tanh approximation
    if cfg.mlp_type in ("swiglu", "geglu"):
        g = x @ p["w_gate"]
        act = F.silu(g) if cfg.mlp_type == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(generator, cfg: ModelConfig, dtype, device):
    D = cfg.d_model
    p = {
        "wq": dense_init(generator, (D, cfg.q_dim), dtype, device),
        "wk": dense_init(generator, (D, cfg.kv_dim), dtype, device),
        "wv": dense_init(generator, (D, cfg.kv_dim), dtype, device),
        "wo": dense_init(generator, (cfg.q_dim, D), dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.q_dim,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((cfg.kv_dim,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((cfg.kv_dim,), dtype=dtype, device=device)
    return p


def _online_attention(q, k, v, q_offset: int, causal: bool,
                      window: Optional[int], kv_len_valid=None,
                      q_block: int = 512):
    """Plain attention over query blocks, full K/V per block.

    The plain twin of the kernel for any query offset and KV length;
    ``apply_attention`` takes it for non-causal attention, as the JAX
    package does.  q: (B, Sq, H, hd); k/v: (B, Sk, KH, hd).  GQA via head
    repeat.  Memory per block: B*H*q_block*Sk — bounded, never S^2.
    """
    B, Sq, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    rep = H // KH
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = hd ** -0.5
    kv_pos = torch.arange(Sk, device=q.device)

    def block_attn(q_blk, q_pos):
        s = torch.einsum("bqhd,bkhd->bhqk", q_blk.float(), k.float()) * scale
        mask = torch.ones((q_pos.shape[0], Sk), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kv_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        if kv_len_valid is not None:
            mask &= kv_pos[None, :] < kv_len_valid
        s = s.masked_fill(~mask[None, None], NEG_INF)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                            v.float()).to(q.dtype)

    q_idx = torch.arange(Sq, device=q.device) + q_offset
    if Sq <= q_block:
        return block_attn(q, q_idx)
    if Sq % q_block:
        raise ValueError(f"Sq={Sq} not divisible by q_block={q_block}")
    return torch.cat([block_attn(q[:, i:i + q_block], q_idx[i:i + q_block])
                      for i in range(0, Sq, q_block)], dim=1)


def _decode_attention(q, ck, cv, kv_valid: int, KH: int, hd: int,
                      block: int = 2048):
    """Single-token attention against the KV cache, online softmax over
    chunks of ``min(block, C)`` slots.

    q: (B, 1, H, hd); ck/cv: (B, C, KH*hd) flattened cache, of the
    cache's dtype (f32 in serving, where q is bf16 at full width: JAX
    promotes the products to f32, and so does this function).
    """
    B, _, H, _ = q.shape
    C = ck.shape[1]
    block = min(block, C)
    if C % block:
        raise ValueError(f"cache length {C} not divisible by block {block}")
    rep = H // KH
    # JAX rounds the weak-typed scale to q's dtype before multiplying
    scale = torch.tensor(hd ** -0.5, dtype=q.dtype).item()
    qf = (q[:, 0] * scale).float()                          # (B, H, hd)

    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, hd), dtype=torch.float32, device=q.device)
    for start in range(0, C, block):
        kc = ck[:, start:start + block].reshape(B, block, KH, hd)
        vc = cv[:, start:start + block].reshape(B, block, KH, hd)
        if rep > 1:
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


def apply_attention(p, x, cfg: ModelConfig, *, positions, causal=True,
                    window=None, cache=None, write_index=None, kv_valid=None,
                    use_kernel: bool = True):
    """Self-attention with optional KV cache.

    x: (B, S, D).  cache: dict(k=(B, C, kv_dim), v=(B, C, kv_dim)), kv
    dims flattened as in the JAX package.  Unlike JAX, the cache is
    updated in place (it is a view into the model's stacked cache) and
    returned, so decoding never copies it.

    Decode semantics: K/V of this step are written at slot
    ``write_index`` (``index % window`` for a ring buffer, else
    ``index``); ``kv_valid`` is the number of live slots; a single-token
    query attends to all live slots.  A multi-token step (prefill) writes
    the cache and attends causally over its own pre-write K/V through the
    flash kernel.

    ``use_kernel`` routes causal attention without a cache: through the
    flash kernel (serving), or, when False, through ``_online_attention``,
    the path autograd can differentiate (the training stages, as in the
    JAX package; the kernel has no backward).

    Returns (out, cache).
    """
    B, S, D = x.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, KH, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, KH, hd)

    if cache is not None:
        C = cache["k"].shape[1]
        if write_index + S > C:
            raise ValueError(f"{S} tokens at slot {write_index} overflow a "
                             f"cache of {C} slots")
        # copy_ casts K/V to the cache dtype, as JAX's update does
        cache["k"][:, write_index:write_index + S] = k.reshape(B, S, cfg.kv_dim)
        cache["v"][:, write_index:write_index + S] = v.reshape(B, S, cfg.kv_dim)
        if S == 1:
            out = _decode_attention(q, cache["k"], cache["v"], kv_valid, KH, hd)
        else:
            # the cache was empty: attend over this step's own K/V
            out = kops.flash_attention(q, k, v, causal=True)
    elif causal and use_kernel:
        out = kops.flash_attention(q, k, v, causal=True, window=window)
    else:
        out = _online_attention(q, k, v, 0, causal=causal, window=window)

    return out.reshape(B, S, cfg.q_dim) @ p["wo"], cache


# ---------------------------------------------------------------------------
# Embedding + LM head
# ---------------------------------------------------------------------------

def init_embed(generator, cfg: ModelConfig, dtype, device):
    p = {"table": dense_init(generator, (cfg.vocab_size, cfg.d_model), dtype,
                             device, scale=0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                  dtype, device)
    return p


def embed_tokens(p, tokens):
    return p["table"][tokens]


def lm_logits(p, x, cfg: ModelConfig):
    w = p["table"].T if cfg.tie_embeddings else p["lm_head"]
    return x @ w


def chunked_xent_loss(embed_p, x, labels, cfg: ModelConfig, chunk: int = 512):
    """Mean cross-entropy over sequence chunks of ``chunk`` rows (one
    chunk of all S when S is not a multiple), so logits exist only per
    chunk.  x: (B, S, D), labels: (B, S) -> f32 scalar.

    Autograd keeps each chunk's f32 logits for the backward, where the
    JAX package recomputes them (``jax.checkpoint``); the values are the
    same."""
    B, S, D = x.shape
    w = embed_p["table"].T if cfg.tie_embeddings else embed_p["lm_head"]
    n = S // chunk if S % chunk == 0 else 1
    if n == 1:
        chunk = S
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        xc, lc = x[:, i * chunk:(i + 1) * chunk], labels[:, i * chunk:(i + 1) * chunk]
        logits = (xc @ w).float()                            # (B, chunk, V)
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lc[..., None].long())[..., 0]
        total = total + (logz - gold).sum()
    return total / (B * S)
