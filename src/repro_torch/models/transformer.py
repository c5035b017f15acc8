"""Decoder transformer: init, decode caches, prefill and decode.

Port of the dense, ssm, hybrid and moe branches of
``repro.models.transformer``:

* dense  — GQA attention + MLP   [gwtf-llama/gpt-300m, gwtf-llama-7b,
           tinyllama, qwen1.5, starcoder2, gemma]
* ssm    — attention-free Mamba2/SSD blocks              [mamba2-130m]
* hybrid — attention and SSD heads in parallel per layer  [hymba]
* moe    — attention + routed experts (+ shared)  [granite-moe, qwen2-moe]

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
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCH_TYPES = ("dense", "ssm", "hybrid", "moe")


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: tensors are parameters, a dict
    is a sub-tree (``moe``'s ``shared``), each under its JAX name; the
    layers read it with ``p[name]`` as they read the dict."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            else:
                self.register_parameter(name, nn.Parameter(v))

    def __getitem__(self, name: str):
        return getattr(self, name)


class Block(nn.Module):
    """One decoder layer's parameters: ln1, attn, ln2, mlp (dense); ln1,
    mamba (ssm); ln1, attn, mamba, ln2, mlp (hybrid); ln1, attn, ln2, moe
    (moe)."""

    def __init__(self, params: Dict[str, Dict[str, Any]]):
        super().__init__()
        for name, sub in params.items():
            self.add_module(name, ParamTree(sub))


class Transformer(nn.Module):
    """The model's parameters; the functions below apply them."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        super().__init__()
        if cfg.arch_type not in ARCH_TYPES:
            raise NotImplementedError(
                f"repro_torch runs {', '.join(ARCH_TYPES)} models only, not "
                f"{cfg.arch_type} ({cfg.name}): see ROADMAP.md, Queue 1 "
                f"item 12.3, model breadth")
        if len(params["blocks"]) != cfg.num_layers:
            raise ValueError(f"{len(params['blocks'])} blocks for "
                             f"{cfg.num_layers} layers")
        self.cfg = cfg
        self.embed = ParamTree(params["embed"])
        self.final_norm = ParamTree(params["final_norm"])
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
    if cfg.is_moe:
        p["moe"] = MOE.init_moe(generator, cfg, dtype, device)
    else:
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
                 write_index, kv_valid, use_kernel: bool = True,
                 moe_impl: str = "dense"):
    """One decoder layer.  ``cache`` is this layer's slice
    (``{"attn": ..., "ssm": ...}`` as the model has them), written in place.
    ``bp`` is anything with the layer's parameter dicts as attributes (a
    ``Block``, or one layer's view of a stacked stage tree); ``use_kernel``
    goes to ``apply_attention`` and ``apply_mamba``, ``moe_impl`` to
    ``apply_moe``, whose auxiliary loss is dropped, as JAX's serving and
    training stages drop it."""
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
    if cfg.is_moe:
        return x + MOE.apply_moe(bp.moe, h2, cfg, impl=moe_impl)[0]
    return x + L.apply_mlp(bp.mlp, h2, cfg)


def forward_hidden(model: Transformer, cfg: ModelConfig, *, tokens,
                   window=None, cache=None, abs_index=None, write_index=None,
                   moe_impl: str = "dense"):
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
                         cache=lc, write_index=write_index, kv_valid=kv_valid,
                         moe_impl=moe_impl)
    return L.apply_norm(model.final_norm, x, cfg), cache


# ---------------------------------------------------------------------------
# Entry points: prefill / decode
# ---------------------------------------------------------------------------

@torch.inference_mode()
def prefill(model: Transformer, cfg: ModelConfig, *, tokens, cache,
            moe_impl: str = "dense"):
    """Fill the cache with a full prompt; returns (last_logits, cache).

    Assumes prompt length <= cache length (no ring wrap during prefill)."""
    hidden, cache = forward_hidden(model, cfg, tokens=tokens, cache=cache,
                                   abs_index=0, write_index=0,
                                   moe_impl=moe_impl)
    return L.lm_logits(model.embed, hidden[:, -1:], cfg)[:, 0], cache


@torch.inference_mode()
def decode_step(model: Transformer, cfg: ModelConfig, *, tokens, cache,
                index: int, window=None, moe_impl: str = "dense"):
    """One decode step at absolute position ``index``."""
    if "attn" in cache:
        cache_len = cache["attn"]["k"].shape[-2]
        write_index = index % cache_len if window is not None else index
    else:
        write_index = index
    hidden, cache = forward_hidden(model, cfg, tokens=tokens, cache=cache,
                                   abs_index=index, write_index=write_index,
                                   moe_impl=moe_impl)
    return L.lm_logits(model.embed, hidden[:, -1:], cfg)[:, 0], cache
