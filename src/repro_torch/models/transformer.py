"""Decoder transformer: init, decode caches, prefill and decode.

Port of the dense, ssm and hybrid branches of ``repro.models.transformer``:

* dense  — GQA attention + MLP      [gwtf-llama/gpt-300m, tinyllama]
* ssm    — attention-free Mamba2/SSD blocks              [mamba2-130m]
* hybrid — attention and SSD heads in parallel per layer  [hymba]

Where the JAX package stacks its blocks along a leading axis and scans
over them, the port holds one ``Block`` module per layer in an
``nn.ModuleList`` and loops.  The caches keep the JAX layout, (L, B, C,
kv_dim) for each of K and V and (L, B, K-1, conv_dim), (L, B, H, P, N)
for the SSM's conv and state, and are updated in place.

Decode semantics: ONE new token against the caches.  Without a window
the KV cache is full-length; with one it is a ring buffer of ``window``
slots, slot = index % window, RoPE at absolute positions, and softmax is
slot-order independent.  The SSM cache is one conv window and one state
per layer whatever the window.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCH_TYPES = ("dense", "ssm", "hybrid")


class Block(nn.Module):
    """One decoder layer's parameters: ln1, attn, ln2, mlp (dense); ln1,
    mamba (ssm); ln1, attn, mamba, ln2, mlp (hybrid)."""

    def __init__(self, params: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        for name, sub in params.items():
            self.add_module(name, nn.ParameterDict(sub))


class Transformer(nn.Module):
    """The model's parameters; the functions below apply them."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        super().__init__()
        if cfg.arch_type not in ARCH_TYPES:
            raise NotImplementedError(
                f"repro_torch runs {', '.join(ARCH_TYPES)} models only, not "
                f"{cfg.arch_type} ({cfg.name}): see ROADMAP.md, Queue 1 "
                f"item 12, model breadth")
        if len(params["blocks"]) != cfg.num_layers:
            raise ValueError(f"{len(params['blocks'])} blocks for "
                             f"{cfg.num_layers} layers")
        self.cfg = cfg
        self.embed = nn.ParameterDict(params["embed"])
        self.final_norm = nn.ParameterDict(params["final_norm"])
        self.blocks = nn.ModuleList(Block(bp) for bp in params["blocks"])


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(generator, cfg: ModelConfig, dtype, device):
    p = {"ln1": L.init_norm(cfg, device)}
    if cfg.arch_type == "ssm":
        p["mamba"] = SSM.init_mamba(generator, cfg, dtype, device)
        return p
    p["attn"] = L.init_attention(generator, cfg, dtype, device)
    if cfg.arch_type == "hybrid":
        p["mamba"] = SSM.init_mamba(generator, cfg, dtype, device)
    p["ln2"] = L.init_norm(cfg, device)
    p["mlp"] = L.init_mlp(generator, cfg, dtype, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Transformer:
    """Random weights at the JAX package's scales, drawn from ``generator``
    (which must live on ``device``)."""
    dev = resolve_device(device)
    dtype = DTYPES[cfg.param_dtype]
    params = {"embed": L.init_embed(generator, cfg, dtype, dev),
              "final_norm": L.init_norm(cfg, dev),
              "blocks": [_init_block(generator, cfg, dtype, dev)
                         for _ in range(cfg.num_layers)]}
    return Transformer(cfg, params)


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, *, device="cuda") -> Dict[str, Any]:
    """Allocate the decode cache.  ``cache_len`` = min(seq_len, window).

    An ssm model's cache holds no attention slots; its SSM state is f32
    whatever ``dtype`` (which the conv state takes)."""
    dev = resolve_device(device)
    c: Dict[str, Any] = {}
    if cfg.has_attention:
        shape = (cfg.num_layers, batch, cache_len, cfg.kv_dim)
        c["attn"] = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                     "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if cfg.has_ssm:
        base = SSM.init_mamba_cache(cfg, batch, dtype, device=dev)
        c["ssm"] = {k: torch.zeros((cfg.num_layers,) + tuple(v.shape),
                                   dtype=v.dtype, device=dev)
                    for k, v in base.items()}
    return c


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_block(bp: Block, x, cfg: ModelConfig, *, positions, window, cache,
                 write_index, kv_valid, use_kernel: bool = True):
    """One decoder layer.  ``cache`` is this layer's slice
    (``{"attn": ..., "ssm": ...}`` as the model has them), written in place.
    ``bp`` is anything with the layer's parameter dicts as attributes (a
    ``Block``, or one layer's view of a stacked stage tree); ``use_kernel``
    goes to ``apply_attention`` and ``apply_mamba``."""
    h = L.apply_norm(bp.ln1, x, cfg)
    if cfg.arch_type == "ssm":
        out, _ = SSM.apply_mamba(bp.mamba, h, cfg,
                                 cache=cache["ssm"] if cache else None,
                                 use_kernel=use_kernel)
        return x + out

    a_out, _ = L.apply_attention(bp.attn, h, cfg, positions=positions,
                                 window=window,
                                 cache=cache["attn"] if cache else None,
                                 write_index=write_index, kv_valid=kv_valid,
                                 use_kernel=use_kernel)
    if cfg.arch_type == "hybrid":
        s_out, _ = SSM.apply_mamba(bp.mamba, h, cfg,
                                   cache=cache["ssm"] if cache else None,
                                   use_kernel=use_kernel)
        x = x + 0.5 * (a_out + s_out)
    else:
        x = x + a_out
    h2 = L.apply_norm(bp.ln2, x, cfg)
    return x + L.apply_mlp(bp.mlp, h2, cfg)


def forward_hidden(model: Transformer, cfg: ModelConfig, *, tokens,
                   window=None, cache=None, abs_index=None, write_index=None):
    """Run the decoder stack.  Returns (hidden, cache).

    abs_index:   absolute position of the first input token (decode).
    write_index: cache slot to write K/V at (ring slot for SWA decode).
    """
    x = L.embed_tokens(model.embed, tokens)
    S = x.shape[1]
    if abs_index is not None:
        positions = abs_index + torch.arange(S, device=x.device)
        kv_valid = None
        if cache is not None and "attn" in cache:
            kv_valid = min(abs_index + S, cache["attn"]["k"].shape[-2])
        if write_index is None:
            write_index = abs_index
    else:
        positions = torch.arange(S, device=x.device)
        kv_valid = None

    for i, bp in enumerate(model.blocks):
        lc = None
        if cache is not None:
            lc = {kind: {name: t[i] for name, t in sub.items()}
                  for kind, sub in cache.items()}
        x = _apply_block(bp, x, cfg, positions=positions, window=window,
                         cache=lc, write_index=write_index, kv_valid=kv_valid)
    return L.apply_norm(model.final_norm, x, cfg), cache


# ---------------------------------------------------------------------------
# Entry points: prefill / decode
# ---------------------------------------------------------------------------

@torch.inference_mode()
def prefill(model: Transformer, cfg: ModelConfig, *, tokens, cache):
    """Fill the cache with a full prompt; returns (last_logits, cache).

    Assumes prompt length <= cache length (no ring wrap during prefill)."""
    hidden, cache = forward_hidden(model, cfg, tokens=tokens, cache=cache,
                                   abs_index=0, write_index=0)
    return L.lm_logits(model.embed, hidden[:, -1:], cfg)[:, 0], cache


@torch.inference_mode()
def decode_step(model: Transformer, cfg: ModelConfig, *, tokens, cache,
                index: int, window=None):
    """One decode step at absolute position ``index``."""
    if "attn" in cache:
        cache_len = cache["attn"]["k"].shape[-2]
        write_index = index % cache_len if window is not None else index
    else:
        write_index = index
    hidden, cache = forward_hidden(model, cfg, tokens=tokens, cache=cache,
                                   abs_index=index, write_index=write_index)
    return L.lm_logits(model.embed, hidden[:, -1:], cfg)[:, 0], cache
