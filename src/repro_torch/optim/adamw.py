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

``AdamW.update`` hands a tree's leaves to ``kernels/ops.py::adamw_update``.
On the card, plain CUDA tensors take a fused kernel written by hand
(``kernels/csrc/adamw.cu``), though no TPU kernel precedes it: under
``jit`` XLA fuses the JAX package's update, while eager PyTorch runs it as
some twenty-five elementwise passes a leaf.  The kernel clips and steps in
two passes over each parameter, bound by bytes: it reads g twice and p, m,
v once and writes p', m', v' once, 24 B a bf16 parameter.  The
``divisor`` argument folds the trainers' mean over completed microbatches
into those passes (the gradients are divided and rounded to their dtype,
as a separate ``g / n`` would round them).  The sharded steps' DTensor
leaves on the card take it on their local shards, the norm's partial sums
summed over the mesh between the two passes.  CPU tensors, and fake and
meta leaves (the dry run, whose costs count the update's operations),
take the plain version, the same PyTorch operations as before the kernel.

``torch.optim.AdamW`` is not used: it decays every leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.kernels import ops
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

    def update(self, grads, state: AdamWState, params, divisor=1):
        """Returns (new_params, new_state) for the gradients' sum over
        ``divisor`` (1: the gradients as given)."""
        flat_p, spec = flatten(params)
        new_p, new_m, new_v, step = ops.adamw_update(
            leaves(grads), flat_p, leaves(state.m), leaves(state.v),
            state.step, lr=self.lr, b1=self.b1, b2=self.b2, eps=self.eps,
            weight_decay=self.weight_decay, grad_clip=self.grad_clip,
            divisor=divisor)
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
