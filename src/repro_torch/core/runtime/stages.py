"""Per-stage compute: fused forward+residual dispatch, VJP backward.

Port of ``repro.core.runtime.stages``.  A stage's parameters are one
stacked tree, as in the JAX package (``init_stage_params`` stacks the
blocks along a leading axis): a norm scale is (L, D), so AdamW's
``ndim >= 2`` rule decays it there as in JAX, and checkpoint leaves line
up with the JAX package's.  A model whose leading layers hold a dense MLP
in place of the experts (``first_dense_layers``, Moonlight's first layer)
has blocks of two kinds: its stage tree is ``{"dense": stack, "moe":
stack}``, each kind present stacked on its own (dense layers come first);
every other model's stage tree is the one stack.  ``stage_forward``
unbinds each stack into one view per layer for
``transformer._apply_block`` with ``use_kernel=False``: causal attention
takes the differentiable flash pair (``kops.flash_attention_train``, the
forward kernel and a hand-written backward) on plain CUDA bf16 tensors of
head dim 64 or 128 and ``_online_attention`` elsewhere, as the JAX stage
does; an SSM layer's scan takes ``ssd_chunked`` (the SSD kernel has no
backward).  An MoE layer runs the token-routed experts (``moe_impl=
"ragged"``: the work of the chosen experts only, no host sync on the
card), where the JAX stage runs every expert on every token; the two
compute the same function.

* ``forward_fused(s, params, x)`` — one forward under autograd on a
  detached input and detached parameter leaves that require grad.  The
  graph is the residual object (:class:`Residuals`): every tensor autograd
  saves goes through ``saved_tensors_hooks`` into a holder that the
  activation store may encode with its codec (int8, bf16, ...) between
  the forward and the backward, and that decodes when the backward
  unpacks it.  The primal output is the plain forward's, bit for bit.
* ``backward_from_residuals(s, residuals, g)`` — ``torch.autograd.grad``
  over the stored graph with ``retain_graph=True``, so a crash replay can
  run the same VJP a second time (``RecoveryManager.replay_lost``); the
  graph is freed when the store drops it.
* ``forward(s, params, x)`` / ``backward(s, params, x, g)`` — the
  rematerialising pair: ``backward`` runs the same residual-capturing
  forward and then the same residual-consuming backward, so remat and
  fused gradients are bit-identical by construction.

Torch has no buffer donation, so the JAX package's ``donate`` option
has no counterpart: no dispatch here writes into its cotangent.

Dispatch counters (``fwd_calls``/``bwd_calls`` per stage,
``remat_recomputes``, embed and head calls) are the ground truth of the
recovery tests, as in JAX.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, dense_layer_config
from repro_torch.models.transformer import (DTYPES, _apply_block, _init_block,
                                            unstack_blocks)
from repro_torch.tree import flatten, tree_map, unflatten


# ---------------------------------------------------------------------------
# Stage modules
# ---------------------------------------------------------------------------

def stage_bounds(cfg: ModelConfig, stage: int, num_stages: int):
    per = cfg.num_layers // num_stages
    extra = cfg.num_layers - per * num_stages
    lo = stage * per + min(stage, extra)
    hi = lo + per + (1 if stage < extra else 0)
    return lo, hi


def stage_kinds(cfg: ModelConfig, lo: int, hi: int) -> List[Tuple[str, range]]:
    """Layers [lo, hi) as runs of one kind each, ``("dense", layers)``
    then ``("moe", layers)``, the kinds present; ``[("", range(lo,
    hi))]`` for a model of one kind of block."""
    if not cfg.first_dense_layers:
        return [("", range(lo, hi))]
    cut = min(max(cfg.first_dense_layers, lo), hi)
    runs = [("dense", range(lo, cut)), ("moe", range(cut, hi))]
    return [(kind, layers) for kind, layers in runs if len(layers)]


def init_stage_params(cfg: ModelConfig, stage: int, num_stages: int,
                      generator: torch.Generator, device="cpu"):
    """Blocks [lo, hi) of the model as one stage, stacked along a leading
    layer axis (a stack a kind, ``stage_kinds``), drawn from ``generator``
    at the JAX package's scales."""
    lo, hi = stage_bounds(cfg, stage, num_stages)
    dtype = DTYPES[cfg.param_dtype]
    if hi == lo:
        # more stages than layers: a block's leaves with a leading axis of
        # 0, as JAX's vmap over no keys gives (the template's draw leaves
        # ``generator`` untouched)
        block = _init_block(torch.Generator(device=device), cfg, dtype, device)
        return tree_map(lambda t: t.new_empty((0, *t.shape)), block)
    tree = {}
    for kind, layers in stage_kinds(cfg, lo, hi):
        kind_cfg = dense_layer_config(cfg) if kind == "dense" else cfg
        blocks = [_init_block(generator, kind_cfg, dtype, device)
                  for _ in layers]
        tree[kind] = tree_map(lambda *ts: torch.stack(ts), *blocks)
    return tree.pop("") if "" in tree else tree


def stage_forward(stage_params, x, cfg: ModelConfig):
    """The stage's blocks in order (``unstack_blocks``' per-layer views of
    each kind's stack, the ``dense`` stack's on ``dense_layer_config``);
    an MoE block runs the token-routed experts and drops its auxiliary
    loss, as the JAX stage drops it.  A block's position in the stage keys
    its expert-load counter (``moe.apply_moe``'s ``layer``)."""
    positions = torch.arange(x.shape[1], device=x.device)
    trees = ([(dense_layer_config(cfg) if k == "dense" else cfg, stage_params[k])
              for k in ("dense", "moe") if k in stage_params]
             if cfg.first_dense_layers else [(cfg, stage_params)])
    i = 0
    for kind_cfg, tree in trees:
        for bp in unstack_blocks(tree):
            x, _ = _apply_block(bp, x, kind_cfg, positions=positions,
                                window=None, cache=None, write_index=None,
                                kv_valid=None, use_kernel=False,
                                moe_impl="ragged", layer=i)
            i += 1
    return x


def init_head_params(cfg: ModelConfig, generator: torch.Generator,
                     device="cpu"):
    """Data-node module: embedding + final norm + LM head."""
    return {"embed": L.init_embed(generator, cfg, DTYPES[cfg.param_dtype],
                                  device),
            "final_norm": L.init_norm(cfg, device)}


def embed_fn(head_params, tokens):
    return L.embed_tokens(head_params["embed"], tokens)


def loss_fn(head_params, hidden, labels, cfg: ModelConfig):
    h = L.apply_norm(head_params["final_norm"], hidden, cfg)
    return L.chunked_xent_loss(head_params["embed"], h, labels, cfg)


# ---------------------------------------------------------------------------
# Residuals: the fused forward's autograd graph, with its saved tensors
# held where the activation store can encode them
# ---------------------------------------------------------------------------

class SavedTensor:
    """One tensor autograd saved in a fused forward.  ``encode`` replaces
    it by the codec's encoding (the store's codec, applied between the
    forward and the backward); ``get`` decodes it when the backward needs
    it, as often as the backward runs."""
    __slots__ = ("enc", "codec")

    def __init__(self, t: torch.Tensor):
        self.enc = t
        self.codec = None

    def encode(self, codec) -> None:
        if self.codec is None:
            self.enc = codec.encode(self.enc)
            self.codec = codec

    def get(self) -> torch.Tensor:
        return self.enc if self.codec is None else self.codec.decode(self.enc)


class Residuals:
    """A fused forward's graph: its output, the parameter leaves and input
    it differentiates against, and the tensors it saved."""
    __slots__ = ("out", "params", "x", "spec", "saved")

    def __init__(self, out, params, x, spec, saved):
        self.out, self.params, self.x = out, params, x
        self.spec, self.saved = spec, saved


def _forward_residuals(cfg: ModelConfig, params, x) -> Tuple[torch.Tensor,
                                                              Residuals]:
    flat, spec = flatten(params)
    leaves_g = [p.detach().requires_grad_() for p in flat]
    xin = x.detach().requires_grad_()
    saved: List[SavedTensor] = []

    def pack(t):
        # detached: a saved output holds its grad_fn, and the graph holds
        # the holder, so keeping ``t`` itself would make a reference cycle
        # through the graph that never frees it
        holder = SavedTensor(t.detach())
        saved.append(holder)
        return holder

    with torch.enable_grad(), \
            torch.autograd.graph.saved_tensors_hooks(pack, SavedTensor.get):
        out = stage_forward(unflatten(spec, leaves_g), xin, cfg)
    return out.detach(), Residuals(out, leaves_g, xin, spec, saved)


def _backward_residuals(resid: Residuals, g) -> Tuple[Any, torch.Tensor]:
    with torch.enable_grad():
        # a stage with no blocks uses none of its (empty) leaves
        grads = torch.autograd.grad(resid.out, resid.params + [resid.x], g,
                                    retain_graph=True, allow_unused=True)
    return (unflatten(resid.spec, with_zeros(resid.params, grads[:-1])),
            grads[-1])


def with_zeros(flat, grads) -> List[torch.Tensor]:
    """Grads of ``flat``'s leaves, zeros where autograd found no use (as
    ``jax.vjp`` gives)."""
    return [torch.zeros_like(p) if d is None else d
            for p, d in zip(flat, grads)]


class StageCompute:
    """Per-stage primitives + dispatch accounting."""

    def __init__(self, cfg: ModelConfig, num_stages: int):
        self.cfg = cfg
        self.num_stages = num_stages
        self.fwd_calls: List[int] = [0] * num_stages
        self.bwd_calls: List[int] = [0] * num_stages
        self.remat_recomputes: List[int] = [0] * num_stages
        self.embed_calls = 0
        self.embed_bwd_calls = 0
        self.head_calls = 0

    # ------------------------------------------------------------------
    def embed(self, head_params, tokens):
        self.embed_calls += 1
        with torch.no_grad():
            return embed_fn(head_params, tokens)

    def embed_backward(self, head_params, tokens, g):
        """Head-gradient contribution of the embedding lookup (the
        cotangent leaving stage 0's VJP), a full head tree with zeros
        where the lookup reads nothing."""
        self.embed_bwd_calls += 1
        flat, spec = flatten(head_params)
        leaves_g = [p.detach().requires_grad_() for p in flat]
        with torch.enable_grad():
            out = embed_fn(unflatten(spec, leaves_g), tokens)
            grads = torch.autograd.grad(out, leaves_g, g, allow_unused=True)
        return unflatten(spec, with_zeros(flat, grads))

    def forward(self, stage: int, params, x):
        """One plain dispatch of stage ``stage`` over a stacked batch
        (no residual capture — the remat path and forward repairs)."""
        self.fwd_calls[stage] += 1
        with torch.no_grad():
            return stage_forward(params, x, self.cfg)

    def forward_fused(self, stage: int, params, x) -> Tuple[Any, Residuals]:
        """One fused dispatch: ``(output, residuals)``; the output is
        :meth:`forward`'s bit for bit."""
        self.fwd_calls[stage] += 1
        return _forward_residuals(self.cfg, params, x)

    def backward_from_residuals(self, stage: int, residuals: Residuals, g
                                ) -> Tuple[Any, Any]:
        """Stage ``stage``'s VJP from stored residuals: zero forward
        recompute; the residuals stay usable for a replay."""
        self.bwd_calls[stage] += 1
        return _backward_residuals(residuals, g)

    def backward(self, stage: int, params, x, g) -> Tuple[Any, Any]:
        """Rematerialising backward from the stored input ``x``, composed
        of the fused path's two programs (bit-identical gradients).
        Counts one backward dispatch plus one ``remat_recomputes``."""
        self.bwd_calls[stage] += 1
        self.remat_recomputes[stage] += 1
        _, resid = _forward_residuals(self.cfg, params, x)
        return _backward_residuals(resid, g)

    def head_loss(self, head_params, hidden, labels):
        """hidden: (B, mb, S, D); labels: (B, mb, S).

        Per-microbatch losses (each the mean over its own tokens), the
        head gradient summed over the B microbatches (zeros where the
        loss reads nothing) and the per-microbatch hidden cotangents."""
        self.head_calls += 1
        flat, spec = flatten(head_params)
        leaves_g = [p.detach().requires_grad_() for p in flat]
        h = hidden.detach().requires_grad_()
        with torch.enable_grad():
            hp = unflatten(spec, leaves_g)
            losses = torch.stack([loss_fn(hp, h[i], labels[i], self.cfg)
                                  for i in range(h.shape[0])])
            grads = torch.autograd.grad(losses.sum(), leaves_g + [h],
                                        allow_unused=True)
        g_head = unflatten(spec, with_zeros(flat, grads[:-1]))
        return losses.detach(), g_head, grads[-1]

    # ------------------------------------------------------------------
    @property
    def stage_dispatches(self) -> int:
        """Total logical stage-level dispatches (one per forward, one per
        backward; remat's hidden forward is counted separately)."""
        return sum(self.fwd_calls) + sum(self.bwd_calls)

    @property
    def remat_recompute_count(self) -> int:
        """Forward recomputes hidden inside remat backwards — 0 on the
        fused path by construction."""
        return sum(self.remat_recomputes)

    def snapshot(self) -> Dict[str, Any]:
        return dict(fwd=list(self.fwd_calls), bwd=list(self.bwd_calls),
                    remat=list(self.remat_recomputes),
                    embed=self.embed_calls, embed_bwd=self.embed_bwd_calls,
                    head=self.head_calls)

