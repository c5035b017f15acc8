"""Decoder transformer: init, decode caches, train loss, prefill and decode.

Port of ``repro.models.transformer``, all six arch families:

* dense  — GQA attention + MLP   [gwtf-llama/gpt-300m, gwtf-llama-7b,
           tinyllama, qwen1.5, starcoder2, gemma]
* ssm    — attention-free Mamba2/SSD blocks              [mamba2-130m]
* hybrid — attention and SSD heads in parallel per layer  [hymba]
* moe    — attention + routed experts (+ shared)  [granite-moe, qwen2-moe;
           moonlight: latent attention (``mla.py``), a sigmoid router, and
           ``first_dense_layers`` leading layers with a dense MLP]
* vlm    — self-attention blocks with interleaved gated cross-attention
           to stub patch embeddings               [llama-3.2-vision]
* audio  — the dense decoder over stub codec-frame embeddings [musicgen]

Where the JAX package stacks its blocks along a leading axis and scans
over them, the port holds one ``Block`` module per layer in an
``nn.ModuleList`` and loops.  A VLM runs superblocks of one cross layer
and ``cross_attn_every - 1`` self layers, ``num_layers //
cross_attn_every`` of them (a remainder of layers is dropped, as in JAX):
``self_blocks`` is a list of rows, ``cross_blocks`` one block a row.  The
caches keep the JAX layout, (L, B, C, kv_dim) for each of K and V, (nb,
k-1, B, C, kv_dim) for a VLM, and (L, B, K-1, conv_dim), (L, B, H, P, N)
for the SSM's conv and state, and are updated in place.

``train_loss`` and the training entry points read the model through its
attributes only, so they take a ``Transformer`` or ``model_view`` of a
tree in the JAX package's stacked layout (``stack_params`` gives one).

Decode semantics: ONE new token against the caches.  Without a window
the KV cache is full-length; with one it is a ring buffer of ``window``
slots, slot = index % window, RoPE at absolute positions, and softmax is
slot-order independent.  The SSM cache is one conv window and one state
per layer whatever the window.  A VLM recomputes the vision projection
and each cross layer's K/V at every step, as JAX does.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, spans
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import (ModelConfig, dense_layer_config,
                                       refuse_mla)
from repro_torch.parallel.sharding import project, shard
from repro_torch.tree import flatten, tree_map, unflatten

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCH_TYPES = ("dense", "ssm", "hybrid", "moe", "vlm", "audio")


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

    def tree(self) -> Dict[str, Any]:
        """The parameters as the nested dict they were built from."""
        return {**dict(self._parameters),
                **{k: m.tree() for k, m in self._modules.items()}}


class Block(ParamTree):
    """One decoder layer's parameters: ln1, attn, ln2, mlp (dense, vlm,
    audio); ln1, mamba (ssm); ln1, attn, mamba, ln2, mlp (hybrid); ln1,
    attn, ln2, moe (moe; a leading dense layer's mlp in place of moe); a
    VLM cross layer's ln1, xattn, gate_attn, ln2, mlp, gate_mlp (the gates
    f32 scalars)."""


def layer_config(cfg: ModelConfig, layer: int) -> ModelConfig:
    """The config layer ``layer`` runs: ``dense_layer_config`` for the
    first ``first_dense_layers``, else ``cfg``."""
    return dense_layer_config(cfg) if layer < cfg.first_dense_layers else cfg


def is_vlm(cfg: ModelConfig) -> bool:
    """Whether the model runs cross-attention superblocks."""
    return cfg.arch_type == "vlm" and bool(cfg.cross_attn_every)


def superblocks(cfg: ModelConfig) -> Tuple[int, int]:
    """``(nb, k)``: a VLM's superblocks, each one cross and k-1 self layers."""
    k = cfg.cross_attn_every
    return cfg.num_layers // k, k


class Transformer(nn.Module):
    """The model's parameters; the functions below apply them."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        super().__init__()
        if cfg.arch_type not in ARCH_TYPES:
            raise ValueError(f"unknown arch_type {cfg.arch_type!r} "
                             f"({cfg.name}): one of {', '.join(ARCH_TYPES)}")
        self.cfg = cfg
        self.embed = ParamTree(params["embed"])
        self.final_norm = ParamTree(params["final_norm"])
        if is_vlm(cfg):
            nb, k = superblocks(cfg)
            rows = [len(row) for row in params["self_blocks"]]
            if rows != [k - 1] * nb or len(params["cross_blocks"]) != nb:
                raise ValueError(f"self-block rows {rows} and "
                                 f"{len(params['cross_blocks'])} cross blocks "
                                 f"for {nb} superblocks of {k} layers")
            self.self_blocks = nn.ModuleList(
                nn.ModuleList(Block(bp) for bp in row)
                for row in params["self_blocks"])
            self.cross_blocks = nn.ModuleList(
                Block(cp) for cp in params["cross_blocks"])
            self.vision_proj = ParamTree(params["vision_proj"])
        else:
            if len(params["blocks"]) != cfg.num_layers:
                raise ValueError(f"{len(params['blocks'])} blocks for "
                                 f"{cfg.num_layers} layers")
            self.blocks = nn.ModuleList(Block(bp) for bp in params["blocks"])


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(generator, cfg: ModelConfig, dtype, device):
    p = {"ln1": L.init_norm(cfg, device)}
    if cfg.arch_type == "ssm":
        p["mamba"] = SSM.init_mamba(generator, cfg, dtype, device)
        return p
    p["attn"] = (MLA.init_mla(generator, cfg, dtype, device) if cfg.has_mla
                 else L.init_attention(generator, cfg, dtype, device))
    if cfg.arch_type == "hybrid":
        p["mamba"] = SSM.init_mamba(generator, cfg, dtype, device)
    p["ln2"] = L.init_norm(cfg, device)
    if cfg.is_moe:
        p["moe"] = MOE.init_moe(generator, cfg, dtype, device)
    else:
        p["mlp"] = L.init_mlp(generator, cfg, dtype, device)
    return p


def _init_cross_block(generator, cfg: ModelConfig, dtype, device):
    return {
        "ln1": L.init_norm(cfg, device),
        "xattn": L.init_attention(generator, cfg, dtype, device),
        "gate_attn": torch.zeros((), dtype=torch.float32, device=device),
        "ln2": L.init_norm(cfg, device),
        "mlp": L.init_mlp(generator, cfg, dtype, device),
        "gate_mlp": torch.zeros((), dtype=torch.float32, device=device),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Transformer:
    """Random weights at the JAX package's scales, drawn from ``generator``
    (which must live on ``device``; a CPU generator draws shapes only on
    the ``meta`` device)."""
    dev = resolve_device(device)
    dtype = DTYPES[cfg.param_dtype]
    params = {"embed": L.init_embed(generator, cfg, dtype, dev),
              "final_norm": L.init_norm(cfg, dev)}
    if is_vlm(cfg):
        nb, k = superblocks(cfg)
        params["self_blocks"] = [[_init_block(generator, cfg, dtype, dev)
                                  for _ in range(k - 1)] for _ in range(nb)]
        params["cross_blocks"] = [_init_cross_block(generator, cfg, dtype, dev)
                                  for _ in range(nb)]
        params["vision_proj"] = {"w_proj": L.dense_init(
            generator, (cfg.vision_dim, cfg.d_model), dtype, dev)}
    else:
        params["blocks"] = [_init_block(generator, layer_config(cfg, i), dtype, dev)
                            for i in range(cfg.num_layers)]
    return Transformer(cfg, params)


# ---------------------------------------------------------------------------
# The JAX package's stacked layout
# ---------------------------------------------------------------------------

def _stack(trees: List[Any]):
    return tree_map(lambda *ts: torch.stack(ts), *trees)


def stack_params(cfg: ModelConfig, model: Transformer) -> Dict[str, Any]:
    """The model's parameters as a tree in the JAX package's layout and
    names: blocks stacked along a leading layer axis (``self_blocks`` along
    two), detached copies."""
    copy = lambda m: tree_map(lambda t: t.detach().clone(), m.tree())  # noqa: E731
    with torch.no_grad():
        tree = {"embed": copy(model.embed), "final_norm": copy(model.final_norm)}
        if is_vlm(cfg):
            tree["self_blocks"] = _stack([_stack([bp.tree() for bp in row])
                                          for row in model.self_blocks])
            tree["cross_blocks"] = _stack([cp.tree()
                                           for cp in model.cross_blocks])
            tree["vision_proj"] = copy(model.vision_proj)
        else:
            tree["blocks"] = _stack([bp.tree() for bp in model.blocks])
    return tree


def unstack_blocks(tree, depth: int = 1) -> List[Any]:
    """Per-layer views of a stacked block tree (``depth`` leading axes),
    each a namespace with the layer's parameter dicts as attributes, as
    ``_apply_block`` reads them.  ``unbind`` keeps the views
    differentiable: every layer's gradient lands in the stacked leaf."""
    flat, spec = flatten(tree)
    per_leaf = [torch.unbind(t, 0) for t in flat]
    n = len(per_leaf[0]) if per_leaf else 0
    rows = [unflatten(spec, [u[i] for u in per_leaf]) for i in range(n)]
    if depth > 1:
        return [unstack_blocks(r, depth - 1) for r in rows]
    return [SimpleNamespace(**r) for r in rows]


def model_view(cfg: ModelConfig, tree: Dict[str, Any]) -> SimpleNamespace:
    """A stacked tree (``stack_params``'s layout) read as a model."""
    view = SimpleNamespace(embed=tree["embed"], final_norm=tree["final_norm"])
    if is_vlm(cfg):
        view.self_blocks = unstack_blocks(tree["self_blocks"], 2)
        view.cross_blocks = unstack_blocks(tree["cross_blocks"])
        view.vision_proj = tree["vision_proj"]
    else:
        view.blocks = unstack_blocks(tree["blocks"])
    return view


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, *, device="cuda",
               kv_heads_override: Optional[int] = None) -> Dict[str, Any]:
    """Allocate the decode cache.  ``cache_len`` = min(seq_len, window).

    An ssm model's cache holds no attention slots; its SSM state is f32
    whatever ``dtype`` (which the conv state takes).  A VLM's self layers
    hold (nb, k-1, B, C, kv_dim); its cross layers hold nothing.
    kv_heads_override > num_kv_heads pads the cache's head dim so it
    shards evenly over the model axis (launch/specs.pad_kv_heads).  An MLA
    model is refused: it needs the latent cache, which is not here."""
    refuse_mla(cfg, "init_cache")
    dev = resolve_device(device)
    if is_vlm(cfg):
        nb, k = superblocks(cfg)
        lead = (nb, k - 1)
    else:
        lead = (cfg.num_layers,)
    c: Dict[str, Any] = {}
    if cfg.has_attention:
        kvd = (kv_heads_override or cfg.num_kv_heads) * cfg.head_dim
        shape = lead + (batch, cache_len, kvd)
        c["attn"] = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                     "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if cfg.has_ssm:
        base = SSM.init_mamba_cache(cfg, batch, dtype, device=dev)
        c["ssm"] = {k: torch.zeros(lead + tuple(v.shape), dtype=v.dtype,
                                   device=dev)
                    for k, v in base.items()}
    return c


def _layer_cache(cache, idx):
    """Layer ``idx``'s slice (views) of the stacked cache, or None."""
    if cache is None:
        return None
    return {kind: {name: t[idx] for name, t in sub.items()}
            for kind, sub in cache.items()}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _apply_block(bp: Block, x, cfg: ModelConfig, *, positions, window, cache,
                 write_index, kv_valid, use_kernel: bool = True,
                 moe_impl: str = "dense", layer: Optional[int] = None):
    """One decoder layer; returns ``(x, aux)``, ``aux`` the MoE router's
    auxiliary loss (0.0 in other layers).  ``cache`` is this layer's slice
    (``{"attn": ..., "ssm": ...}`` as the model has them), written in place.
    ``bp`` is anything with the layer's parameter dicts as attributes (a
    ``Block``, or one layer's view of a stacked tree); ``use_kernel`` goes
    to ``apply_attention`` and ``apply_mamba``, ``moe_impl`` and ``layer``
    (the layer's position in its stage) to ``apply_moe``.  ``cfg`` is the
    layer's own (``layer_config``).  Latent attention (``cfg.has_mla``)
    takes no cache."""
    with spans.span("norm"):
        h = L.apply_norm(bp.ln1, x, cfg)
    if cfg.arch_type == "ssm":
        out, _ = SSM.apply_mamba(bp.mamba, h, cfg,
                                 cache=cache["ssm"] if cache else None,
                                 use_kernel=use_kernel)
        return x + out, 0.0

    with spans.span("attention"):
        if cfg.has_mla:
            a_out = MLA.apply_mla(bp.attn, h, cfg, positions=positions)
        else:
            a_out, _ = L.apply_attention(bp.attn, h, cfg, positions=positions,
                                         window=window,
                                         cache=cache["attn"] if cache else None,
                                         write_index=write_index,
                                         kv_valid=kv_valid, use_kernel=use_kernel)
    if cfg.arch_type == "hybrid":
        s_out, _ = SSM.apply_mamba(bp.mamba, h, cfg,
                                   cache=cache["ssm"] if cache else None,
                                   use_kernel=use_kernel)
        x = x + 0.5 * (a_out + s_out)
    else:
        x = x + a_out
    with spans.span("norm"):
        h2 = L.apply_norm(bp.ln2, x, cfg)
    if cfg.is_moe:
        with spans.span("moe"):
            m_out, aux = MOE.apply_moe(bp.moe, h2, cfg, impl=moe_impl,
                                       layer=layer)
    else:
        with spans.span("mlp"):
            m_out, aux = L.apply_mlp(bp.mlp, h2, cfg), 0.0
    # Megatron-style sequence parallelism: the residual stream between
    # blocks is sharded along S over the 'model' axis (rules.seq)
    return shard(x + m_out, "batch", "seq", None), aux


def _apply_cross_block(bp, x, vision, cfg: ModelConfig):
    """Gated cross-attention layer (llama-3.2-vision style): the gates'
    tanh in f32, cast to x's dtype, then the product, as in JAX."""
    h = L.apply_norm(bp.ln1, x, cfg)
    out, _ = L.apply_attention(bp.xattn, h, cfg, positions=None,
                               causal=False, kv_x=vision)
    x = x + torch.tanh(bp.gate_attn).to(x.dtype) * out
    h2 = L.apply_norm(bp.ln2, x, cfg)
    return x + torch.tanh(bp.gate_mlp).to(x.dtype) * L.apply_mlp(bp.mlp, h2, cfg)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward_hidden(model, cfg: ModelConfig, *, tokens=None, embeds=None,
                   vision=None, window=None, cache=None, abs_index=None,
                   write_index=None, moe_impl: str = "dense",
                   use_kernel: bool = True, remat: Optional[bool] = None):
    """Run the decoder stack.  Returns (hidden, aux_loss, cache).

    embeds:      (B, S, D) inputs in place of ``tokens`` (the audio stub).
    vision:      (B, M, vision_dim) patch embeddings; a VLM skips its cross
                 layers without them.
    abs_index:   absolute position of the first input token (decode).
    write_index: cache slot to write K/V at (ring slot for SWA decode).
    remat:       recompute each layer (a VLM's superblock) in the backward
                 (``torch.utils.checkpoint``) in place of keeping its
                 activations, as ``jax.checkpoint``; the values are the
                 same.  None takes ``cfg.remat``; only under autograd.
    ``aux_loss`` sums the MoE layers' router losses (0.0 without them).
    """
    if embeds is not None:
        x = embeds.to(DTYPES[cfg.param_dtype])
    else:
        x = L.embed_tokens(model.embed, tokens)
    x = shard(x, "batch", "seq", None)
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

    do_remat = (cfg.remat if remat is None else remat) and torch.is_grad_enabled()

    def block(bp, x, idx):
        lcfg = layer_config(cfg, idx) if isinstance(idx, int) else cfg
        return _apply_block(bp, x, lcfg, positions=positions, window=window,
                            cache=_layer_cache(cache, idx),
                            write_index=write_index, kv_valid=kv_valid,
                            use_kernel=use_kernel, moe_impl=moe_impl)

    def run(fn, *args):
        if do_remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    aux = 0.0
    if is_vlm(cfg):
        vis = (project(vision.to(x.dtype), model.vision_proj["w_proj"])
               if vision is not None else None)

        def superblock(x, i):
            if vis is not None:
                x = _apply_cross_block(model.cross_blocks[i], x, vis, cfg)
            a_sum = 0.0
            for j, bp in enumerate(model.self_blocks[i]):
                x, a = block(bp, x, (i, j))
                a_sum = a_sum + a
            return x, a_sum

        for i in range(len(model.cross_blocks)):
            x, a = run(superblock, x, i)
            aux = aux + a
    else:
        for i, bp in enumerate(model.blocks):
            x, a = run(block, bp, x, i)
            aux = aux + a
    return L.apply_norm(model.final_norm, x, cfg), aux, cache


# ---------------------------------------------------------------------------
# Entry points: train loss / prefill / decode
# ---------------------------------------------------------------------------

def train_loss(model, batch, cfg: ModelConfig, moe_impl: str = "dense",
               use_kernel: bool = False):
    """batch: dict(tokens (B, S) | embeds (B, S, D), labels (B, S),
    [vision]).  The mean cross-entropy plus ``cfg.router_aux_coef`` times
    the MoE layers' auxiliary loss.  ``use_kernel`` stays False under
    autograd: causal self-attention then takes the differentiable flash
    pair where ``kops.flash_attention_train_route`` admits its tensors
    (plain CUDA bf16, head dim 64 or 128), else ``_online_attention``."""
    hidden, aux, _ = forward_hidden(
        model, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
        vision=batch.get("vision"), moe_impl=moe_impl, use_kernel=use_kernel)
    loss = L.chunked_xent_loss(model.embed, hidden, batch["labels"], cfg)
    return loss + cfg.router_aux_coef * aux


@torch.inference_mode()
def prefill(model, cfg: ModelConfig, *, tokens=None, embeds=None,
            vision=None, cache, moe_impl: str = "dense",
            use_kernel: bool = True):
    """Fill the cache with a full prompt; returns (last_logits, cache).

    Assumes prompt length <= cache length (no ring wrap during prefill).
    ``use_kernel=False`` attends through ``_online_attention`` and scans
    with ``ssd_chunked`` (the sharded steps: a kernel takes no DTensor)."""
    hidden, _, cache = forward_hidden(
        model, cfg, tokens=tokens, embeds=embeds, vision=vision, cache=cache,
        abs_index=0, write_index=0, moe_impl=moe_impl, use_kernel=use_kernel,
        remat=False)
    return L.lm_logits(model.embed, hidden[:, -1:], cfg)[:, 0], cache


@torch.inference_mode()
def decode_step(model, cfg: ModelConfig, *, tokens=None, embeds=None,
                vision=None, cache, index: int, window=None,
                moe_impl: str = "dense"):
    """One decode step at absolute position ``index``."""
    if "attn" in cache:
        cache_len = cache["attn"]["k"].shape[-2]
        write_index = index % cache_len if window is not None else index
    else:
        write_index = index
    hidden, _, cache = forward_hidden(
        model, cfg, tokens=tokens, embeds=embeds, vision=vision, cache=cache,
        abs_index=index, write_index=write_index, moe_impl=moe_impl,
        remat=False)
    return L.lm_logits(model.embed, hidden[:, -1:], cfg)[:, 0], cache
