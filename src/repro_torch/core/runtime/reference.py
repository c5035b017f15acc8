"""FROZEN pre-refactor executor — the per-microbatch whole-model reference.

Port of ``repro.core.runtime.reference``: the monolithic
``DecentralizedTrainer`` as it stood before the staged runtime existed.
One autograd pass over the *entire* model per microbatch, hand-rolled
Bernoulli churn with an ``integers(0, 2)`` crash budget, silent drops
when no live same-stage substitute exists, no activation store, no
checkpointing.  The numpy draws (churn, budget) and the flow protocol's
stream are the JAX trainer's, one for one, so on one network and seed
both trainers route, crash, drop and complete the same microbatches.

It is the frozen baseline a benchmark measures the staged runtime
against (microbatches/s and recovery cost), as
``benchmarks/bench_exec.py``'s reference row does in the JAX package:
change it only to track the port's API.  Its initial parameters are
``cache.initial_params``' draw (``torch.Generator`` cannot reproduce the
JAX keys; tests set ``stage_params`` and ``head_params`` to JAX's).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.flow.decentralized import GWTFProtocol
from repro_torch.core.flow.graph import FlowNetwork
from repro_torch.core.runtime.cache import initial_params
from repro_torch.core.runtime.stages import (embed_fn, loss_fn, stage_forward,
                                             with_zeros)
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import flatten, tree_map, unflatten


@dataclass
class ReferenceIterationResult:
    loss: float
    completed: int
    launched: int
    dropped: int


class ReferenceDecentralizedTrainer:
    """The seed's GWTF trainer: whole-model autograd per microbatch."""

    def __init__(self, cfg, net: FlowNetwork, *,
                 churn: float = 0.0, lr: float = 1e-3,
                 seed: int = 0,
                 rng: Optional[np.random.Generator] = None,
                 device="cuda"):
        self.cfg = cfg
        self.net = net
        self.churn = churn
        self.device = resolve_device(device)
        self.rng = rng or np.random.default_rng(seed)
        self.protocol = GWTFProtocol(net, rng=self.rng)
        self.protocol.run(max_rounds=100)
        stage_p, head_p = initial_params(cfg, net.num_stages, seed,
                                         self.device)
        self.stage_params = list(stage_p)
        self.head_params = {d.id: head_p for d in net.data_nodes()}
        self.opt = AdamW(lr=lr)
        self.stage_opt = [self.opt.init(p) for p in self.stage_params]
        self.head_opt = {d: self.opt.init(p)
                         for d, p in self.head_params.items()}
        self.losses: List[float] = []

    # ------------------------------------------------------------------
    def iteration(self, batches_per_data_node: Dict[int, List[dict]]
                  ) -> ReferenceIterationResult:
        """One training iteration: route, fwd, bwd, aggregate, update."""
        S = self.net.num_stages
        # --- churn: pick crashing relays for this iteration -------------
        crashed = set()
        for n in self.net.nodes.values():
            if n.is_data:
                continue
            if n.alive and self.rng.uniform() < self.churn:
                crashed.add(n.id)
            elif not n.alive and self.rng.uniform() < self.churn:
                n.alive = True
                self.protocol.add_node(n)
        # --- routing -----------------------------------------------------
        self.protocol.reclaim_sink_slots()
        self.protocol.run(max_rounds=30, quiet_rounds=2)
        flows = self.protocol.complete_flows()
        mb_queue: List[Tuple[int, dict, List[int]]] = []
        per_dn_counts: Dict[int, int] = {d.id: 0 for d in self.net.data_nodes()}
        for chain in flows:
            dn = chain[0]
            avail = batches_per_data_node.get(dn, [])
            k = per_dn_counts[dn]
            if k < len(avail):
                mb_queue.append((dn, avail[k], chain))
                per_dn_counts[dn] += 1
        launched = len(mb_queue)
        crash_budget = {nid: self.rng.integers(0, 2) for nid in crashed}

        # --- forward + backward per microbatch ---------------------------
        grad_stage: List[Any] = [None] * S
        grad_head: Dict[int, Any] = {}
        counts = [0] * S
        head_counts: Dict[int, int] = {}
        total_loss, completed, dropped = 0.0, 0, 0

        for dn, mb, chain in mb_queue:
            relays = list(chain[1:-1])
            ok = True
            for idx, nid in enumerate(relays):
                if nid in crashed and crash_budget[nid] <= 0:
                    sub = self._substitute(nid, crashed)
                    if sub is None:
                        ok = False
                        break
                    relays[idx] = sub
                elif nid in crashed:
                    crash_budget[nid] -= 1
            if not ok:
                dropped += 1
                continue
            loss, g_head, g_stages = self._train_microbatch(dn, mb)
            total_loss += loss
            completed += 1
            for s, g in enumerate(g_stages):
                grad_stage[s] = g if grad_stage[s] is None else tree_map(
                    torch.add, grad_stage[s], g)
                counts[s] += 1
            if dn in grad_head:
                grad_head[dn] = tree_map(torch.add, grad_head[dn], g_head)
                head_counts[dn] += 1
            else:
                grad_head[dn] = g_head
                head_counts[dn] = 1

        # --- aggregation + update (Sec. V-E) ------------------------------
        for s in range(S):
            if grad_stage[s] is None:
                continue
            g = tree_map(lambda x: x / counts[s], grad_stage[s])
            self.stage_params[s], self.stage_opt[s] = self.opt.update(
                g, self.stage_opt[s], self.stage_params[s])
        for dn, g in grad_head.items():
            g = tree_map(lambda x: x / head_counts[dn], g)
            self.head_params[dn], self.head_opt[dn] = self.opt.update(
                g, self.head_opt[dn], self.head_params[dn])

        # --- commit crashes ------------------------------------------------
        for nid in crashed:
            self.net.nodes[nid].alive = False
            self.protocol.remove_node(nid)

        mean_loss = total_loss / max(1, completed)
        self.losses.append(mean_loss)
        return ReferenceIterationResult(loss=mean_loss, completed=completed,
                                        launched=launched, dropped=dropped)

    # ------------------------------------------------------------------
    def _substitute(self, dead: int, crashed: set) -> Optional[int]:
        stage = self.net.nodes[dead].stage
        cands = [n.id for n in self.net.stage_nodes(stage)
                 if n.id not in crashed and n.id != dead]
        return cands[0] if cands else None

    def _train_microbatch(self, dn: int, mb: dict):
        """Full fwd+bwd for one microbatch through every stage: ``(loss,
        head gradient, [stage gradients])``, zeros where the loss reads
        nothing (as ``jax.value_and_grad`` gives)."""
        flat, spec = flatten((self.head_params[dn], self.stage_params))
        leaves_g = [p.detach().requires_grad_() for p in flat]
        tokens = torch.as_tensor(mb["tokens"]).to(self.device)
        labels = torch.as_tensor(mb["labels"]).to(self.device)
        with torch.enable_grad():
            head_p, stage_ps = unflatten(spec, leaves_g)
            x = embed_fn(head_p, tokens)
            for sp in stage_ps:
                x = stage_forward(sp, x, self.cfg)
            loss = loss_fn(head_p, x, labels, self.cfg)
            grads = torch.autograd.grad(loss, leaves_g, allow_unused=True)
        g_head, g_stages = unflatten(spec, with_zeros(flat, grads))
        return float(loss.detach()), g_head, list(g_stages)
