"""Dense decoder transformer: init, KV cache, prefill and decode.

Port of the dense branch of ``repro.models.transformer``.  Where the JAX
package stacks its blocks along a leading axis and scans over them, the
port holds one ``Block`` module per layer in an ``nn.ModuleList`` and
loops.  The KV cache keeps the JAX layout, (L, B, C, kv_dim) for each of
K and V, and is updated in place.

Decode semantics: ONE new token against the KV cache.  Without a window
the cache is full-length; with one it is a ring buffer of ``window``
slots, slot = index % window, RoPE at absolute positions, and softmax is
slot-order independent.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Block(nn.Module):
    """One decoder layer's parameters: ln1, attn, ln2, mlp."""

    def __init__(self, params: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        for name, sub in params.items():
            self.add_module(name, nn.ParameterDict(sub))


class Transformer(nn.Module):
    """The model's parameters; the functions below apply them."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        super().__init__()
        if cfg.arch_type != "dense":
            raise NotImplementedError(
                f"repro_torch runs dense models only, not {cfg.arch_type} "
                f"({cfg.name}): see ROADMAP.md, Queue 1, model breadth")
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
    return {"ln1": L.init_norm(cfg, device),
            "attn": L.init_attention(generator, cfg, dtype, device),
            "ln2": L.init_norm(cfg, device),
            "mlp": L.init_mlp(generator, cfg, dtype, device)}


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
    """Allocate the decode cache.  ``cache_len`` = min(seq_len, window)."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, cache_len, cfg.kv_dim)
    return {"attn": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                     "v": torch.zeros(shape, dtype=dtype, device=dev)}}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_block(bp: Block, x, cfg: ModelConfig, *, positions, window, cache,
                 write_index, kv_valid):
    """One decoder layer.  ``cache`` is this layer's slice, written in place."""
    h = L.apply_norm(bp.ln1, x, cfg)
    a_out, _ = L.apply_attention(bp.attn, h, cfg, positions=positions,
                                 window=window, cache=cache,
                                 write_index=write_index, kv_valid=kv_valid)
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
        if cache is not None:
            kv_valid = min(abs_index + S, cache["attn"]["k"].shape[-2])
        if write_index is None:
            write_index = abs_index
    else:
        positions = torch.arange(S, device=x.device)
        kv_valid = None

    for i, bp in enumerate(model.blocks):
        lc = None
        if cache is not None:
            lc = {"k": cache["attn"]["k"][i], "v": cache["attn"]["v"][i]}
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
    cache_len = cache["attn"]["k"].shape[-2]
    write_index = index % cache_len if window is not None else index
    hidden, cache = forward_hidden(model, cfg, tokens=tokens, cache=cache,
                                   abs_index=index, write_index=write_index)
    return L.lm_logits(model.embed, hidden[:, -1:], cfg)[:, 0], cache
