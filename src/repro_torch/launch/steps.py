"""Train, prefill and decode steps, and their sharding specs.

Port of ``repro.launch.steps``.  A train step is functional, as JAX's:
``train_step(params, opt_state, batch) -> (params, opt_state, loss)``
over a parameter tree in the JAX package's stacked layout and names
(``transformer.stack_params``), so that AdamW sees JAX's leaves (its
weight decay takes the leaves of two or more axes, the stacked norm
scales among them) and a checkpoint holds JAX's tree.  The loss and its
gradient come from one autograd pass through ``transformer.model_view``
of the tree.  The prefill and decode steps take a ``Transformer`` or
such a view, and attend and scan through the plain paths
(``use_kernel=False``), as JAX's steps do.

Given a ``mesh`` and ``rules``, each step runs under ``use_rules`` with
DTensor's implicit replication (a plain tensor, such as RoPE's positions,
meets a DTensor as a replicated one): its inputs are DTensors laid out by
the specs below (``sharding.distribute``), and the model's ``shard``
annotations redistribute as JAX's sharding constraints do.  The specs are
JAX's: ``batch_shardings``, ``train_shardings`` and ``serve_shardings``
give trees of ``PartitionSpec``s (JAX gives ``NamedSharding``s of them)
for the step's inputs and outputs.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.core.runtime.stages import with_zeros
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models.config import ModelConfig, refuse_mla
from repro_torch.models.transformer import (decode_step, init_cache,
                                            model_view, prefill, train_loss)
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.parallel.sharding import (NameRefusals, P, ShardingRules,
                                           distribute, param_spec_tree,
                                           replicated, use_rules)
from repro_torch.tree import flatten, tree_map_with_path, unflatten


@contextlib.contextmanager
def _on_mesh(mesh, rules: Optional[ShardingRules]):
    """The rules active, plain tensors replicated where they meet a
    DTensor, and an op DTensor refuses raised with its placements
    (``NameRefusals``); nothing without a mesh."""
    if mesh is None:
        yield
        return
    with use_rules(rules, mesh), implicit_replication(), NameRefusals():
        yield


def loss_and_grads(params, batch, cfg: ModelConfig, moe_impl: str = "dense"):
    """``(loss, grads)`` of ``train_loss`` at ``params`` (a stacked tree),
    the gradient a tree of the same layout, zeros where the loss reads
    nothing (a VLM's cross layers without ``vision``), as ``jax.grad``
    gives."""
    flat, spec = flatten(params)
    leaves_g = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss = train_loss(model_view(cfg, unflatten(spec, leaves_g)), batch,
                          cfg, moe_impl=moe_impl)
        grads = torch.autograd.grad(loss, leaves_g, allow_unused=True)
    return loss.detach(), unflatten(spec, with_zeros(flat, grads))


def make_train_step(cfg: ModelConfig, opt: Optional[AdamW] = None,
                    mesh=None, rules: Optional[ShardingRules] = None,
                    moe_impl: str = "dense", grad_accum: int = 1):
    """grad_accum > 1: batch leaves carry a leading (grad_accum,) dim; the
    microbatches' gradients are summed in f32 and averaged, as JAX's scan
    does, so only one microbatch's activations are live at a time."""
    refuse_mla(cfg, "the sharded train step")
    opt = opt or AdamW()

    def train_step(params, opt_state, batch):
        with _on_mesh(mesh, rules):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        if grad_accum > 1:
            gsum, lsum = None, 0.0
            for i in range(grad_accum):
                loss, g = loss_and_grads(params, {k: v[i] for k, v in
                                                  batch.items()}, cfg, moe_impl)
                g, spec = flatten(g)
                g = [x.float() for x in g]
                gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
                lsum = lsum + loss
            grads = unflatten(spec, [g / grad_accum for g in gsum])
            loss = lsum / grad_accum
        else:
            loss, grads = loss_and_grads(params, batch, cfg, moe_impl)
        new_params, new_state = opt.update(grads, opt_state, params)
        # JAX's scalar output sharding
        return new_params, new_state, replicated(loss)

    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int, mesh=None,
                      rules: Optional[ShardingRules] = None,
                      moe_impl: str = "dense"):
    """``prefill_step(model, batch) -> (logits, cache)``; the cache is
    allocated in ``init_cache``'s default dtype (bf16), as in JAX, and on a
    mesh laid out as ``serve_shardings`` lays out a prefill's cache."""

    def prefill_step(model, batch):
        first = next(iter(batch.values()))
        if mesh is None:
            cache = init_cache(cfg, first.shape[0], cache_len,
                               device=first.device)
        else:
            cache = init_cache(cfg, first.shape[0], cache_len, device="meta")
            specs = batch_shardings({"cache": cache}, rules, mesh)["cache"]
            cache = distribute(cache, specs, mesh)
        with _on_mesh(mesh, rules):
            return prefill(model, cfg, tokens=batch.get("tokens"),
                           embeds=batch.get("embeds"),
                           vision=batch.get("vision"), cache=cache,
                           moe_impl=moe_impl, use_kernel=False)

    return prefill_step


def make_decode_step(cfg: ModelConfig, window=None, mesh=None,
                     rules: Optional[ShardingRules] = None,
                     moe_impl: str = "dense"):
    """``serve_step(model, batch) -> (logits, cache)``; ``batch`` holds the
    cache and the absolute ``index`` (an int or a scalar tensor) beside the
    inputs."""

    def serve_step(model, batch):
        with _on_mesh(mesh, rules):
            return decode_step(model, cfg, tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"),
                               vision=batch.get("vision"),
                               cache=batch["cache"], index=int(batch["index"]),
                               window=window, moe_impl=moe_impl)

    return serve_step


# ---------------------------------------------------------------------------
# Sharding specs for step inputs/outputs
# ---------------------------------------------------------------------------

def _axes(rules: ShardingRules, mesh, logical):
    sizes = mesh_axis_sizes(mesh)
    r = rules.resolve(logical)
    if r is None:
        return None
    axes = tuple(ax for ax in (r if isinstance(r, tuple) else (r,))
                 if ax in sizes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def batch_shardings(batch_abstract, rules: ShardingRules, mesh,
                    grad_accum: int = 1):
    """Batch dim -> ('pod','data') when divisible, else replicated.

    With grad_accum > 1 batch leaves carry a leading (grad_accum,) dim
    that stays unsharded; the batch dim is index 1."""
    sizes = mesh_axis_sizes(mesh)
    baxes = _axes(rules, mesh, "batch")
    bsize = 1
    if baxes is not None:
        for ax in (baxes if isinstance(baxes, tuple) else (baxes,)):
            bsize *= sizes[ax]
    b_idx = 1 if grad_accum > 1 else 0

    def spec_for(names, leaf):
        if "index" in names or leaf.ndim == 0:
            return P()
        if "cache" in names:
            return _cache_spec(names, leaf, rules, mesh, baxes, bsize)
        spec = [None] * leaf.ndim
        if (baxes is not None and leaf.ndim > b_idx
                and leaf.shape[b_idx] % bsize == 0 and leaf.shape[b_idx] > 1):
            spec[b_idx] = baxes
        return P(*spec)

    return tree_map_with_path(spec_for, batch_abstract)


def _cache_spec(names, leaf, rules, mesh, baxes, bsize):
    """KV cache (L, B, C, kvd) / conv (L, B, K, cd) / ssm (L, B, H, P, N).

    VLM self-cache has an extra leading dim.  Batch dim = the one sized
    like global batch — identified positionally: k/v/conv are ndim-3,
    ssm state is ndim-4.
    """
    taxes = _axes(rules, mesh, "tp")
    sizes = mesh_axis_sizes(mesh)
    tsize = 1
    if taxes is not None:
        for ax in (taxes if isinstance(taxes, tuple) else (taxes,)):
            tsize *= sizes[ax]
    spec = [None] * leaf.ndim
    if "ssm" in names and leaf.ndim >= 4 and names[-1] == "ssm":
        b_idx, t_idx = leaf.ndim - 4, leaf.ndim - 2      # (.., B, H, P, N)
    else:
        b_idx, t_idx = leaf.ndim - 3, leaf.ndim - 1      # (.., B, C, kvd)
    if baxes is not None and leaf.shape[b_idx] % bsize == 0 and leaf.shape[b_idx] > 1:
        spec[b_idx] = baxes
    if taxes is not None and leaf.shape[t_idx] % tsize == 0:
        spec[t_idx] = taxes
    return P(*spec)


def optimizer_shardings(opt_state_abstract, param_shardings, mesh):
    """m/v mirror the parameter shardings; step is replicated."""
    return AdamWState(step=P(), m=param_shardings, v=param_shardings)


def train_shardings(cfg: ModelConfig, params_abstract, opt_state_abstract,
                    batch_abstract, rules: ShardingRules, mesh,
                    grad_accum: int = 1):
    pspec = param_spec_tree(params_abstract, rules, mesh)
    ospec = optimizer_shardings(opt_state_abstract, pspec, mesh)
    bspec = batch_shardings(batch_abstract, rules, mesh, grad_accum)
    return (pspec, ospec, bspec), (pspec, ospec, P())


def _div_axes(rules, mesh, logical, dim):
    """Axes for ``logical`` only when they divide ``dim`` (else replicate)."""
    axes = _axes(rules, mesh, logical)
    if axes is None:
        return None
    sizes = mesh_axis_sizes(mesh)
    total = 1
    for ax in (axes if isinstance(axes, tuple) else (axes,)):
        total *= sizes[ax]
    return axes if (dim % total == 0 and dim > 1) else None


def serve_shardings(cfg: ModelConfig, params_abstract, batch_abstract,
                    rules: ShardingRules, mesh, *, global_batch: int,
                    cache_abstract=None):
    """Shardings for prefill (cache_abstract given) or decode steps."""
    pspec = param_spec_tree(params_abstract, rules, mesh)
    bspec = batch_shardings(batch_abstract, rules, mesh)
    logits = P(_div_axes(rules, mesh, "batch", global_batch),
               _div_axes(rules, mesh, "tp", cfg.vocab_size))
    if cache_abstract is not None:     # prefill: cache is an output
        cspec = batch_shardings({"cache": cache_abstract}, rules, mesh)["cache"]
        return (pspec, bspec), (logits, cspec)
    # decode: cache rides in and out through batch["cache"]
    return (pspec, bspec), (logits, bspec["cache"])
