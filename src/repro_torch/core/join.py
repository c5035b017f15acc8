"""Node insertion (paper Sec. V-B): bottleneck-stage-first assignment.

The elected leader periodically (1) floods a utilization query through the
stages — each node appends (capacity, flows-through) and forwards to known
peers of the next stage — and (2) assigns the highest-capacity joining
candidates to the most-utilized stages, one per stage, highest to highest.

Baselines for Fig. 5: highest-capacity-first (ignore utilization, fill
stages round-robin by raw capacity) and random assignment.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.flow.graph import FlowNetwork, Node


@dataclass
class StageReport:
    stage: int
    capacity: int
    flows: int

    @property
    def utilization(self) -> float:
        return self.flows / self.capacity if self.capacity else float("inf")


def flood_utilization(net: FlowNetwork, flows: Sequence[Sequence[int]]
                      ) -> List[StageReport]:
    """The leader's flooding query: per-stage (capacity, flow count).

    ``flows`` are node-id chains (data -> s0 -> ... -> data); each chain
    contributes one flow to every stage it crosses.
    """
    per_stage_flows = [0] * net.num_stages
    for chain in flows:
        for nid in chain[1:-1]:
            node = net.nodes.get(nid)
            if node is not None and not node.is_data:
                per_stage_flows[node.stage] += 1
    return [StageReport(s, net.stage_capacity(s), per_stage_flows[s])
            for s in range(net.num_stages)]


def assign_joiners(reports: List[StageReport],
                   candidate_capacities: Sequence[int],
                   policy: str = "gwtf",
                   rng: Optional[np.random.Generator] = None) -> List[int]:
    """Returns the stage assignment for each candidate (parallel list).

    * gwtf     — highest capacity -> most utilized stage (paper Sec. V-B)
    * capacity — highest capacity candidate first, stages filled round-
                 robin (utilization-blind; the paper's "highest capacity
                 first" baseline)
    * random   — uniform random stage per candidate
    """
    rng = rng or np.random.default_rng(0)
    n = len(candidate_capacities)
    if policy == "random":
        return list(rng.integers(0, len(reports), size=n))
    order = np.argsort(candidate_capacities)[::-1]      # high cap first
    out = [0] * n
    if policy == "gwtf":
        stage_rank = sorted(reports, key=lambda r: -r.utilization)
        for k, ci in enumerate(order):
            out[ci] = stage_rank[k % len(stage_rank)].stage
    elif policy == "capacity":
        for k, ci in enumerate(order):
            out[ci] = reports[k % len(reports)].stage    # round robin
    else:
        raise ValueError(policy)
    return out
