"""AdamW and SGD over pytrees of tensors (port of ``repro.optim.adamw``).

The math is the JAX package's, leaf for leaf, in ``jax.tree.flatten``
order: the gradients of one tree are clipped to a global norm of
``grad_clip`` over that tree's leaves (the trainers update each stage
tree and each data-node head on its own, as the JAX package's jitted
update is called per tree); moments are f32 and bias-corrected; the
decoupled weight decay applies to leaves with ``ndim >= 2`` only, which
includes the stacked (L, D) norm scales of a stage tree.  Updates are
functional: new tensors are returned and nothing is written in place, so
trees shared between trainers (the cached initial parameters) and the
tensors a stored residual graph refers to stay as they were.

``torch.optim.AdamW`` is not used: it decays every leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import spans
from repro_torch.tree import flatten, leaves, tree_map, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    m: Any
    v: Any


def _device(tree):
    flat = leaves(tree)
    return flat[0].device if flat else torch.device("cpu")


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=_device(params)),
            m=zeros, v=tree_map(torch.clone, zeros))

    def update(self, grads, state: AdamWState, params):
        """Returns (new_params, new_state)."""
        flat_p, spec = flatten(params)
        flat_g = leaves(grads)
        flat_m, flat_v = leaves(state.m), leaves(state.v)
        if self.grad_clip is not None:
            with spans.span("adamw.clip"):
                gnorm = sum(g.float().square().sum() for g in flat_g).sqrt()
                scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
                flat_g = [g.float() * scale for g in flat_g]
        with spans.span("adamw.step"):
            step = state.step + 1
            t = step.float()
            b1t = 1.0 - torch.full_like(t, self.b1) ** t
            b2t = 1.0 - torch.full_like(t, self.b2) ** t
            new_p, new_m, new_v = [], [], []
            for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
                g = g.float()
                m = self.b1 * m + (1 - self.b1) * g
                v = self.b2 * v + (1 - self.b2) * g.square()
                delta = (m / b1t) / ((v / b2t).sqrt() + self.eps)
                if p.ndim >= 2:  # decoupled decay on matrices only
                    delta = delta + self.weight_decay * p.float()
                new_p.append((p.float() - self.lr * delta).to(p.dtype))
                new_m.append(m)
                new_v.append(v)
        m_spec, v_spec = flatten(state.m)[1], flatten(state.v)[1]
        return unflatten(spec, new_p), AdamWState(
            step=step, m=unflatten(m_spec, new_m), v=unflatten(v_spec, new_v))


@dataclass(frozen=True)
class SGD:
    """Plain SGD — the paper's convergence argument is stated for SGD."""
    lr: float = 1e-2
    momentum: float = 0.0

    def init(self, params):
        if self.momentum:
            return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
        return ()

    def update(self, grads, state, params):
        if self.momentum:
            new_state = tree_map(lambda s, g: self.momentum * s + g.float(),
                                 state, grads)
            new_p = tree_map(lambda p, s: (p.float() - self.lr * s).to(p.dtype),
                             params, new_state)
            return new_p, new_state
        new_p = tree_map(
            lambda p, g: (p.float() - self.lr * g.float()).to(p.dtype),
            params, grads)
        return new_p, state
