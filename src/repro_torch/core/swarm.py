"""SWARM parallelism baseline (Ryabinin et al., ICML'23) — as characterised
in the GWTF paper:

* stochastic greedy wiring: each node independently forwards a microbatch
  to the closest (lowest comm-cost) *responsive* node of the next stage —
  no flow construction, no capacity planning;
* assumes homogeneous memory: nodes are considered available regardless of
  their real capacity, so heterogeneous nodes over-commit and queue;
* forward-pass crash: timeout + resend to a different next-stage node;
* backward-pass crash: the WHOLE pipeline for that microbatch is
  recomputed from the data node (the paper's key inefficiency claim).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core.flow.graph import FlowNetwork


class SwarmRouter:
    """Greedy next-stage selection with optional stochastic tie-breaking.

    The per-hop cost scan is batched: candidate costs come from one row
    gather of the cached dense Eq. 1 matrix instead of a per-pair
    ``d()`` call per candidate, and a *routing context* (per-stage alive
    membership snapshot + the matrix) can be shared across every path
    of a planning wave — membership cannot change while a plan is being
    built, so ``SwarmPolicy.plan`` derives it once instead of re-scanning
    the node table per hop.  Results (and the RNG stream of stochastic
    tie-breaking) are identical to the scalar scan's.
    """

    def __init__(self, net: FlowNetwork, *,
                 cost_matrix: Optional[np.ndarray] = None,
                 stochastic: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self.net = net
        self.cost_matrix = cost_matrix
        self.stochastic = stochastic
        self.rng = rng or np.random.default_rng(0)
        self._cm: Optional[np.ndarray] = None

    def d(self, i: int, j: int) -> float:
        if self.cost_matrix is not None:
            return float(self.cost_matrix[i, j])
        return self.net.edge_cost(i, j)

    def _matrix(self) -> np.ndarray:
        if self.cost_matrix is not None:
            if self._cm is None:
                self._cm = np.asarray(self.cost_matrix, np.float64)
            return self._cm
        return self.net.cost_matrix()    # cached by the network

    def route_context(self) -> tuple:
        """Snapshot (cost matrix, per-stage alive candidate ids) for one
        planning wave."""
        return (self._matrix(),
                [[n.id for n in self.net.stage_nodes(s)]
                 for s in range(self.net.num_stages)])

    def next_hop(self, current: int, next_stage: int, data_node: int,
                 exclude: Optional[set] = None,
                 ctx: Optional[tuple] = None) -> Optional[int]:
        """Greedy: closest alive node of the next stage (or the data node
        when the pipeline is done).  ``exclude`` = peers already timed out."""
        if next_stage >= self.net.num_stages:
            return data_node if self.net.nodes[data_node].alive else None
        if ctx is not None:
            cands = ctx[1][next_stage]
            cm = ctx[0]
        else:
            cands = [n.id for n in self.net.stage_nodes(next_stage)]
            cm = self._matrix()
        if exclude:
            cands = [j for j in cands if j not in exclude]
        if not cands:
            return None
        costs = cm[current][cands]
        if self.stochastic:
            # SWARM prioritises faster peers stochastically
            w = 1.0 / np.maximum(costs, 1e-9)
            w = w / w.sum()
            return int(self.rng.choice(cands, p=w))
        return int(cands[int(np.argmin(costs))])

    def route(self, data_node: int,
              ctx: Optional[tuple] = None) -> Optional[List[int]]:
        """A full greedy path for one microbatch (no capacity checks)."""
        if ctx is None:
            ctx = self.route_context()
        path = [data_node]
        cur = data_node
        for s in range(self.net.num_stages):
            nxt = self.next_hop(cur, s, data_node, ctx=ctx)
            if nxt is None:
                return None
            path.append(nxt)
            cur = nxt
        path.append(data_node)
        return path

    def route_with_capacity(self, data_node: int, used: dict,
                            ctx: Optional[tuple] = None
                            ) -> Optional[List[int]]:
        """Greedy path that only uses nodes with remaining capacity
        (``used`` is a shared node_id -> consumed-slots dict).  This is
        the *feasible* SWARM baseline of Fig. 7 — a schedule that
        over-commits capacity is not executable."""
        if ctx is None:
            ctx = self.route_context()
        path = [data_node]
        cur = data_node
        for s in range(self.net.num_stages):
            full = {nid for nid, u in used.items()
                    if u >= self.net.nodes[nid].capacity}
            nxt = self.next_hop(cur, s, data_node, exclude=full, ctx=ctx)
            if nxt is None:
                return None
            path.append(nxt)
            used[nxt] = used.get(nxt, 0) + 1
            cur = nxt
        path.append(data_node)
        return path
