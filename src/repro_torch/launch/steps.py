"""Train, prefill and decode steps on one device.

Port of the step functions of ``repro.launch.steps``.  A train step is
functional, as JAX's: ``train_step(params, opt_state, batch) ->
(params, opt_state, loss)`` over a parameter tree in the JAX package's
stacked layout and names (``transformer.stack_params``), so that AdamW
sees JAX's leaves (its weight decay takes the leaves of two or more
axes, the stacked norm scales among them) and a checkpoint holds JAX's
tree.  The loss and its gradient come from one autograd pass through
``transformer.model_view`` of the tree.  The prefill and decode steps
take a ``Transformer`` or such a view.

The sharding half of the JAX module (``batch_shardings``,
``train_shardings``, ``serve_shardings`` and their helpers) lays steps
out over a TPU mesh and has no counterpart on one card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.runtime.stages import with_zeros
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (decode_step, init_cache,
                                            model_view, prefill, train_loss)
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import flatten, unflatten


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
                    moe_impl: str = "dense", grad_accum: int = 1):
    """grad_accum > 1: batch leaves carry a leading (grad_accum,) dim; the
    microbatches' gradients are summed in f32 and averaged, as JAX's scan
    does, so only one microbatch's activations are live at a time."""
    opt = opt or AdamW()

    def train_step(params, opt_state, batch):
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
        return new_params, new_state, loss

    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int,
                      moe_impl: str = "dense"):
    """``prefill_step(model, batch) -> (logits, cache)``; the cache is
    allocated in ``init_cache``'s default dtype (bf16), as in JAX."""

    def prefill_step(model, batch):
        first = next(iter(batch.values()))
        cache = init_cache(cfg, first.shape[0], cache_len,
                           device=first.device)
        return prefill(model, cfg, tokens=batch.get("tokens"),
                       embeds=batch.get("embeds"), vision=batch.get("vision"),
                       cache=cache, moe_impl=moe_impl)

    return prefill_step


def make_decode_step(cfg: ModelConfig, window=None, moe_impl: str = "dense"):
    """``serve_step(model, batch) -> (logits, cache)``; ``batch`` holds the
    cache and the absolute ``index`` beside the inputs."""

    def serve_step(model, batch):
        return decode_step(model, cfg, tokens=batch.get("tokens"),
                           embeds=batch.get("embeds"),
                           vision=batch.get("vision"), cache=batch["cache"],
                           index=int(batch["index"]), window=window,
                           moe_impl=moe_impl)

    return serve_step
