"""Core neural layers of the decoder: norms, RoPE, MLP, attention,
embeddings.

Port of ``repro.models.layers``.  Parameters are dicts of tensors
(``transformer.ParamTree`` inside the model); the apply functions take
them and plain tensors.  Causal self-attention goes through
``kernels.ops.flash_attention``: the hand-written kernel on CUDA, its
plain version on the CPU.  Training passes ``use_kernel=False``: its
causal self-attention takes ``kernels.ops.flash_attention_train``, the
forward kernel with its log-sum-exp and a hand-written backward, on plain
CUDA bf16 tensors of head dim 64 or 128, and ``_online_attention``, which
autograd differentiates, everywhere else.  Cross-attention
(``kv_x``, the VLM's image layers) is non-causal over memory rows of
another length and takes ``_online_attention`` too, as in the JAX
package.  Single-token decode against the KV cache goes through
``kernels.ops.decode_attention``: the split-KV kernel on CUDA, its plain
version on the CPU.  ``chunked_xent_loss`` is the training loss head.

Where JAX computes a product of low-precision operands with
``preferred_element_type=f32`` or promotes mixed dtypes, the port casts
both operands to f32 first: ``torch.matmul`` neither promotes mixed
dtypes nor returns f32 for bf16 inputs.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch import spans
from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import (dim_shards, embed, gather_last,
                                           locally, logsumexp_last,
                                           merge_last, on_shards, project,
                                           seq_blocks, shard, split_last,
                                           tp_range, tp_size)

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


def apply_norm(p, x, cfg: ModelConfig):
    eps = cfg.norm_eps
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
        g = shard(project(x, p["w_gate"]), "batch", None, "tp")
        act = F.silu(g) if cfg.mlp_type == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * project(x, p["w_up"])
    else:
        h = shard(F.gelu(project(x, p["w_up"]), approximate="tanh"),
                  "batch", None, "tp")
    return project(h, p["w_down"])


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(generator, cfg: ModelConfig, dtype, device,
                   kv_in_dim: Optional[int] = None):
    """kv_in_dim overrides the K/V input width (cross-attention)."""
    D = cfg.d_model
    kv_in = kv_in_dim or D
    p = {
        "wq": dense_init(generator, (D, cfg.q_dim), dtype, device),
        "wk": dense_init(generator, (kv_in, cfg.kv_dim), dtype, device),
        "wv": dense_init(generator, (kv_in, cfg.kv_dim), dtype, device),
        "wo": dense_init(generator, (cfg.q_dim, D), dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.q_dim,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((cfg.kv_dim,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((cfg.kv_dim,), dtype=dtype, device=device)
    return p


def _online_attention(q, k, v, q_offset: int, causal: bool,
                      window: Optional[int], kv_len_valid=None,
                      q_block: int = 512, kv_heads=None):
    """Plain attention over query blocks, full K/V per block.

    The plain twin of the kernel for any query offset and KV length;
    ``apply_attention`` takes it for non-causal attention, as the JAX
    package does.  q: (B, Sq, H, hd); k/v: (B, Sk, KH, hd).  GQA via head
    repeat, or ``kv_heads``, the K/V head of each query head (``_attend``).
    Memory per block: B*H*q_block*Sk — bounded, never S^2.
    """
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    if kv_heads is not None:
        k, v = k.index_select(2, kv_heads), v.index_select(2, kv_heads)
    elif H > k.shape[2]:
        rep = H // k.shape[2]
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
                      block: int = 2048, kv_heads=None):
    """Single-token attention against the KV cache: ``kops.decode_attention``,
    the split-KV kernel on CUDA, its plain version (online softmax over
    chunks of ``min(block, C)`` slots) elsewhere.

    q: (B, 1, H, hd); ck/cv: (B, C, KH*hd) flattened cache, of the
    cache's dtype (f32 in serving, where q is bf16 at full width: JAX
    promotes the products to f32, and so does this function).  GQA by
    head repeat, or ``kv_heads`` as in ``_online_attention``.
    """
    return kops.decode_attention(q, ck, cv, kv_valid, KH, hd, block=block,
                                 kv_heads=kv_heads)


def _pad_heads(x, n: int):
    """(B, S, h, hd) -> (B, S, n, hd), zero heads after x's."""
    B, S, h, hd = x.shape
    zeros = torch.zeros((B, S, n - h, hd), dtype=x.dtype, device=x.device)
    return torch.cat([x, zeros], dim=2)


def _attend(core, q, k, v):
    """``core(q, k, v, kv_heads)`` on each device's query heads (a plain
    ``core(q, k, v, None)`` off a mesh).  q: (B, Sq, H, hd); k, v: (B, Sk,
    KH, hd) or a flat cache (B, C, KH * hd).  The layout of train and
    prefill attention and of decode, as the JAX package constrains it
    (``_constrain_attention_operands`` there):

    * Q sharded by heads over the tp axes, evenly where they divide H; else
      unevenly (e.g. 36, 25, 20 heads on a 16-way axis: each device takes
      ceil(H / tp) heads, as GSPMD pads them), which repeats the padded
      heads' share but needs no partial-sum all-reduce of the scores.
      JAX pads only where K/V are small GQA heads and leaves near-MHA
      K/V (musicgen 24/24, qwen1.5 20/20) to GSPMD's propagation; the
      port pads those the same way;
    * K/V sharded the same way where each device's query heads read only
      its own K/V heads (the tp axes divide KH, or MHA's K/V heads
      chunked as Q's), else replicated over the tp axes (GQA's small K/V,
      e.g. starcoder2 36/4, hymba 25/5), each device picking the K/V head
      of each of its query heads (``kv_heads``).

    Each device attends only its own heads (and batch rows: a batch the
    batch axes do not shard, such as long_500k's 1, repeats there, as in
    GSPMD); the output is sharded as Q."""
    if not isinstance(q, DTensor):
        return core(q, k, v, None)
    H, hd = q.shape[2], q.shape[3]
    KH = k.shape[2] if k.ndim == 4 else k.shape[2] // hd
    rep, tp = H // KH, tp_size()
    own = KH % tp == 0 or (rep == 1 and k.ndim == 4)
    q0, nq = tp_range(H)
    k0 = tp_range(KH)[0] if own else 0

    def local(q, k, v):
        kv_heads = torch.arange(q0, q0 + nq, device=q.device) // rep - k0
        return core(q, k, v, kv_heads)

    kv_dim = 2 if own else None
    return on_shards(local, [(q, 2, True), (k, kv_dim, True),
                             (v, kv_dim, True)], [(q.shape, 2)])


def apply_attention(p, x, cfg: ModelConfig, *, positions, causal=True,
                    window=None, kv_x=None, cache=None, write_index=None,
                    kv_valid=None, use_kernel: bool = True):
    """Self- or cross-attention with optional KV cache.

    x: (B, S, D).  kv_x: cross-attention memory (B, M, Dv) or None; with
    it K and V come from ``kv_x``, no RoPE applies and every query attends
    to all M rows (no cache; ``positions`` is unused).
    cache: dict(k=(B, C, kv_dim), v=(B, C, kv_dim)), kv
    dims flattened as in the JAX package.  Unlike JAX, the cache is
    updated in place (it is a view into the model's stacked cache) and
    returned, so decoding never copies it.  A cache wider than kv_dim
    (``init_cache``'s ``kv_heads_override``) holds zero-padded K/V heads,
    and Q is padded by whole head groups to match, so that each device of
    the model axis owns whole heads; the padded heads' outputs are dropped
    before ``wo``.

    Decode semantics: K/V of this step are written at slot
    ``write_index`` (``index % window`` for a ring buffer, else
    ``index``); ``kv_valid`` is the number of live slots; a single-token
    query attends to all live slots.  A multi-token step (prefill) writes
    the cache and attends causally over its own pre-write K/V through the
    flash kernel.

    ``use_kernel`` routes causal self-attention over more than one token:
    through the flash kernel (serving), or, when False, through a path
    autograd can differentiate (the training stages): the flash pair
    ``kops.flash_attention_train`` (forward and hand-written backward)
    where ``kops.flash_attention_train_route`` admits q, k and v (plain
    CUDA bf16 tensors of head dim 64 or 128), else ``_online_attention``,
    as in the JAX package: on the CPU, for f32, other head dims, and the
    sharded steps' DTensors, on each device's heads (``_attend``).

    Returns (out, cache).
    """
    B, S, D = x.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    src = x if kv_x is None else kv_x
    q = shard(project(x, p["wq"]), "batch", None, "tp")
    k = shard(project(src, p["wk"]), "batch", None, "tp")
    v = shard(project(src, p["wv"]), "batch", None, "tp")
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = split_last(q, H), split_last(k, KH), split_last(v, KH)
    if kv_x is None:
        q = locally(lambda t: apply_rope(t, positions, cfg.rope_theta), q)
        k = locally(lambda t: apply_rope(t, positions, cfg.rope_theta), k)
    elif cache is not None:
        raise ValueError("cross-attention takes no KV cache")

    if cache is not None:
        C, cache_kvd = cache["k"].shape[1:]
        if write_index + S > C:
            raise ValueError(f"{S} tokens at slot {write_index} overflow a "
                             f"cache of {C} slots")
        KH_eff, H_eff = KH, H
        if cache_kvd > cfg.kv_dim:          # head-padded cache
            KH_eff = cache_kvd // hd
            H_eff = KH_eff * (H // KH)
            k, v = _pad_heads(k, KH_eff), _pad_heads(v, KH_eff)
            q = _pad_heads(q, H_eff)
        # copy_ casts K/V to the cache dtype, as JAX's update does
        cache["k"][:, write_index:write_index + S] = merge_last(k)
        cache["v"][:, write_index:write_index + S] = merge_last(v)
        with spans.span("attention.core"):
            if S == 1:
                out = _attend(lambda q, ck, cv, kv_heads: _decode_attention(
                    q, ck, cv, kv_valid, ck.shape[-1] // hd, hd,
                    kv_heads=kv_heads), q, cache["k"], cache["v"])
            elif use_kernel:
                # the cache was empty: attend over this step's own K/V
                out = kops.flash_attention(q, k, v, causal=True)
            else:
                out = _attend(lambda q, k, v, kv_heads: _online_attention(
                    q, k, v, 0, causal=True, window=None, kv_heads=kv_heads),
                    q, k, v)
        if H_eff > H:
            out = out[:, :, :H]
    elif causal and use_kernel and kv_x is None:
        with spans.span("attention.core"):
            out = kops.flash_attention(q, k, v, causal=True, window=window)
    elif causal and kv_x is None and kops.flash_attention_train_route(q, k, v):
        with spans.span("attention.core"):
            out = kops.flash_attention_train(q, k, v, window=window)
    else:
        with spans.span("attention.core"):
            out = _attend(lambda q, k, v, kv_heads: _online_attention(
                q, k, v, 0, causal=causal and kv_x is None, window=window,
                kv_heads=kv_heads), q, k, v)

    return project(merge_last(out), p["wo"]), cache


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
    return embed(p["table"], tokens)


def lm_logits(p, x, cfg: ModelConfig):
    w = p["table"].T if cfg.tie_embeddings else p["lm_head"]
    return project(x, w)


def chunked_xent_loss(embed_p, x, labels, cfg: ModelConfig, chunk: int = 512):
    """Mean cross-entropy over sequence chunks of ``chunk`` rows (one
    chunk of all S when S is not a multiple), so logits exist only per
    chunk.  x: (B, S, D), labels: (B, S) -> f32 scalar.

    Autograd keeps each chunk's f32 logits for the backward, where the
    JAX package recomputes them (``jax.checkpoint``); the values are the
    same.  On DTensors the loss is vocab-parallel where the model axis
    shards the vocab (each chunk's rows gathered, the logits sharded by
    vocab); where it does not divide the vocab, the head is replicated
    there and the chunks are taken from each device's own sequence rows
    (``seq_blocks``), so that no device multiplies another's rows."""
    B, S, D = x.shape
    w = embed_p["table"].T if cfg.tie_embeddings else embed_p["lm_head"]
    if isinstance(x, DTensor) and dim_shards(w, 1) == 1:
        k = dim_shards(x, 1)
        x, labels = seq_blocks(x, k), seq_blocks(labels, k)
    rows = x.shape[-2]
    n = rows // chunk if rows % chunk == 0 else 1
    if n == 1:
        chunk = rows
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        xc = x[..., i * chunk:(i + 1) * chunk, :]
        lc = labels[..., i * chunk:(i + 1) * chunk]
        logits = project(xc, w).float()                # (B, [k,] chunk, V)
        logz = logsumexp_last(logits)
        gold = gather_last(logits, lc)
        total = total + (logz - gold).sum()
    return total / (B * S)
