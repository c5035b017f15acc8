"""What a GWTF training iteration computes (paper Sec. V-E), in plain
PyTorch, for the microbatches that completed.

The model's layers are split into contiguous stages (the first
``L mod stages`` stages take one layer more); each stage's parameters are
one tree, stacked along a leading layer axis, shared by the stage's
replicas.  Each data node keeps its own head: the embedding (tied to the
LM head or not) and the final norm.  In an iteration:

* each completed microbatch's loss is the mean cross-entropy of its tokens;
  the iteration's loss is the mean over the completed microbatches;
* a stage's gradient is the mean, over every completed microbatch, of the
  gradient of its loss; a data node's head takes the mean over that data
  node's own completed microbatches, and is not updated when it has none;
* each tree's gradient is clipped to a global norm of ``grad_clip``, then
  AdamW: f32 moments, bias correction, decoupled weight decay on leaves of
  two or more dimensions (stacked norm scales and biases included).

Which microbatches completed is the routing's outcome (flow planning,
churn, recovery): the caller gives it.  The reference keeps its parameters
in f32 and never rounds them.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from perfbench.reference import dense

ROWS = 2        # rows of a microbatch through the reference at a time


def stage_layers(num_layers: int, num_stages: int) -> List[range]:
    per, extra = divmod(num_layers, num_stages)
    out, lo = [], 0
    for s in range(num_stages):
        hi = lo + per + (1 if s < extra else 0)
        out.append(range(lo, hi))
        lo = hi
    return out


def _adamw(p, g, m, v, step: int, opt: dict):
    b1, b2 = opt["b1"], opt["b2"]
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    delta = (m / (1 - b1 ** step)) / ((v / (1 - b2 ** step)).sqrt() + opt["eps"])
    if p.ndim >= 2:
        delta = delta + opt["weight_decay"] * p
    p.sub_(opt["lr"] * delta)


class Trainer:
    """The reference's state: ``trees`` maps a tree's name (``stage<s>``,
    ``head<dn>``) to ``{leaf path: f32 tensor}``."""

    def __init__(self, cfg: dict, trees: Dict[str, Dict[str, torch.Tensor]],
                 opt: dict, num_stages: int, pr: dense.Precision = dense.F32):
        self.cfg, self.opt, self.pr = cfg, opt, pr
        self.stages = stage_layers(cfg["num_layers"], num_stages)
        self.trees = {name: {k: t.clone().requires_grad_() for k, t in tree.items()}
                      for name, tree in trees.items()}
        zeros = lambda: {n: {k: torch.zeros_like(t) for k, t in tr.items()}  # noqa: E731
                         for n, tr in self.trees.items()}
        self.m, self.v = zeros(), zeros()
        self.steps = {n: 0 for n in self.trees}

    def _layers(self) -> List[dict]:
        out = []
        for s in range(len(self.stages)):
            nested = dense.nest(self.trees[f"stage{s}"])
            out += [{blk: {k: t[i] for k, t in leaves.items()} for blk, leaves in nested.items()}
                    for i in range(len(self.stages[s]))]
        return out

    def iteration(self, completed: List[Tuple[int, torch.Tensor, torch.Tensor]]
                  ) -> Tuple[float, Dict[str, Dict[str, torch.Tensor]]]:
        """One iteration over ``completed``, a list of (data node, tokens,
        labels); returns (mean loss, {tree: clipped gradient}) of the trees
        it updated."""
        if not completed:
            return float("nan"), {}
        layers = self._layers()
        per_dn: Dict[int, int] = {}
        for dn, _, _ in completed:
            per_dn[dn] = per_dn.get(dn, 0) + 1
        total = 0.0
        for dn, tokens, labels in completed:
            head = dense.nest(self.trees[f"head{dn}"])
            # the microbatch's mean loss as the mean of equal blocks of rows
            # (each block's backward on its own, to hold the memory down)
            rows = tokens.shape[0]
            for lo in range(0, rows, ROWS):
                part = slice(lo, min(lo + ROWS, rows))
                loss = dense.loss(layers, head, tokens[part], labels[part], self.cfg, self.pr)
                loss = loss * (tokens[part].shape[0] / rows)
                total += float(loss.detach())
                loss.backward()
        grads = {}
        for name, tree in self.trees.items():
            n = len(completed) if name.startswith("stage") else per_dn.get(int(name[4:]), 0)
            if n == 0:
                for t in tree.values():
                    t.grad = None
                continue
            g = {k: t.grad / n for k, t in tree.items()}
            for t in tree.values():
                t.grad = None
            gnorm = torch.sqrt(sum(x.square().sum() for x in g.values()))
            scale = torch.clamp(self.opt["grad_clip"] / (gnorm + 1e-9), max=1.0)
            g = {k: x * scale for k, x in g.items()}
            self.steps[name] += 1
            with torch.no_grad():
                for k, t in tree.items():
                    _adamw(t, g[k], self.m[name][k], self.v[name][k], self.steps[name], self.opt)
            grads[name] = g
        return total / len(completed), grads
