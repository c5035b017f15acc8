"""Hierarchical geo-planning: region super-nodes + local refinement.

The paper's evaluation topology has a fixed geographic structure (10
locations, Sec. VI): intra-location links are fast and cheap,
inter-location links slow and expensive.  At internet scale (10k+
relays) a flat planner pays O(N) scan costs per decision even though
most of the placement signal lives at the *region* level.  This module
exploits that structure in two phases:

1. **Region graph.**  Alive relays are aggregated by
   (``Node.stage``, ``Node.location``) into super-nodes whose capacity
   is the sum of their members' capacities; the super-edge cost between
   adjacent-stage super-nodes is the mean pairwise member cost (rounded
   to the nearest integer when the underlying matrix is integral, so
   the O(V + C) dial core stays applicable).  The exact
   ``solve_training_flow`` MCMF oracle then runs on this
   ~``num_locations x num_stages`` graph — thousands of times smaller
   than the flat problem — and its path decomposition yields one
   *region chain* per unit of flow.

2. **Local refinement.**  Region chains are materialized stage by
   stage: all units entering the same (stage, region) super-node form
   one small transportation problem — unit ``u`` (whose concrete
   predecessor is already fixed) is matched to a member node ``m`` at
   cost ``d(prev_u, m)`` (plus the return edge ``d(m, origin_u)`` at
   the last stage, so the closing hop is not chosen blindly), subject
   to member capacities.  Each transport is solved exactly with a tiny
   `MinCostFlow` (dial core on quantized costs), and the transports of
   one stage are independent across regions — ``parallel=`` hands them
   to a thread pool.  The forward construction is myopic (it cannot see
   a node's *outgoing* edge yet), so ``refine_passes`` coordinate-descent
   sweeps follow: each re-solves one stage's transports with both
   neighbours fixed (cost ``d(prev_u, m) + d(m, next_u)``), which only
   ever lowers the plan cost.

The result is a feasible concrete plan whose cost is measured against
the flat dial MCMF oracle by ``benchmarks/bench_scale.py`` (the
committed optimality-gap bound) — hierarchy trades a bounded gap for
planning time that scales with ``regions^2 x stages`` instead of
``N^2``.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.flow.graph import FlowNetwork, Node
from repro_torch.core.flow.mincost import MinCostFlow, solve_training_flow

#: quantization step (cost units) used to make float (geo) costs
#: integral for the dial core; the per-edge rounding error is bounded
#: by half this quantum.
DEFAULT_QUANTUM = 1e-3


@dataclass
class HierarchicalPlan:
    """Result of ``solve_hierarchical``.

    ``cost`` is the concrete (refined) plan's total chain cost under
    the *original* cost matrix; ``region_cost`` is the super-node
    relaxation's optimal objective (quantized units when the input was
    float) — a lower-fidelity signal, kept for diagnostics.
    """
    flow: float
    cost: float
    paths: List[List[int]]
    region_cost: float
    num_regions: int
    regions: Dict[Tuple[int, int], List[int]] = field(default_factory=dict)


def aggregate_regions(net: FlowNetwork) -> Dict[Tuple[int, int], List[int]]:
    """Alive relays grouped by (stage, location).

    Relays with an unset location (-1) form their own pseudo-region per
    stage, so topologies without geography degrade to one super-node
    per stage (the hierarchy then *is* the stage graph).
    """
    regions: Dict[Tuple[int, int], List[int]] = {}
    for n in net.alive_nodes():
        if n.is_data:
            continue
        regions.setdefault((n.stage, n.location), []).append(n.id)
    return regions


def build_region_network(
        net: FlowNetwork,
        cost_matrix: Optional[np.ndarray] = None,
) -> Tuple[FlowNetwork, np.ndarray, Dict[int, Tuple[int, int]], Dict[int, int]]:
    """The super-node relaxation of ``net``.

    Returns ``(region_net, region_cm, super_of, data_map)`` where
    ``region_net`` has one data node per alive data node of ``net``
    (same capacity) and one relay super-node per (stage, region);
    ``super_of`` maps super-node id -> (stage, region) and ``data_map``
    maps original data-node id -> region-net id.  ``region_cm[a, b]``
    is the mean member-pair cost (integral when the input matrix is
    integral, so ``method="auto"`` keeps selecting the dial core) on
    the adjacent-stage blocks the layered flow consumes; unconsumed
    blocks are left zero rather than aggregated.

    When ``net`` carries a wire-codec menu, ``net.cost_matrix()`` is
    already priced at each link's best admissible codec, so the region
    aggregation (and everything downstream) is codec-aware for free;
    the region net itself stores the aggregated costs directly
    (infinite bandwidth), so no second round of codec pricing applies.
    """
    CM = (np.asarray(cost_matrix, float) if cost_matrix is not None
          else net.cost_matrix())
    regions = aggregate_regions(net)
    data = [n for n in net.data_nodes() if n.alive]
    nodes: Dict[int, Node] = {}
    data_map: Dict[int, int] = {}
    rid = 0
    for n in data:
        nodes[rid] = Node(rid, -1, n.capacity, 0.0, is_data=True)
        data_map[n.id] = rid
        rid += 1
    super_of: Dict[int, Tuple[int, int]] = {}
    member_ids: Dict[int, np.ndarray] = {}
    for (s, loc) in sorted(regions):
        ids = regions[(s, loc)]
        cap = sum(net.nodes[i].capacity for i in ids)
        nodes[rid] = Node(rid, s, cap, 0.0, location=loc)
        super_of[rid] = (s, loc)
        member_ids[rid] = np.asarray(ids, np.int64)
        rid += 1
    R = rid
    groups: List[np.ndarray] = []
    for r in range(R):
        if r in member_ids:
            groups.append(member_ids[r])
        else:
            orig = next(k for k, v in data_map.items() if v == r)
            groups.append(np.asarray([orig], np.int64))
    # The layered region flow only consumes data->stage0,
    # stage_s->stage_{s+1} and stage_{S-1}->data edges, so aggregate
    # exactly those directed blocks (reduceat over a per-stage-pair
    # gather) instead of paying a full N^2 pass for R^2 means — the
    # difference between ~5 s and ~0.1 s at 10k nodes.
    rcm = np.zeros((R, R))
    data_rids = [data_map[n.id] for n in data]
    stage_rids: List[List[int]] = [[] for _ in range(net.num_stages)]
    for srid, (s, _) in super_of.items():
        stage_rids[s].append(srid)
    integral = True

    def fill(rows_rids: List[int], cols_rids: List[int]) -> None:
        nonlocal integral
        if not rows_rids or not cols_rids:
            return
        rlens = np.asarray([len(groups[r]) for r in rows_rids], np.int64)
        clens = np.asarray([len(groups[r]) for r in cols_rids], np.int64)
        rows = np.concatenate([groups[r] for r in rows_rids])
        cols = np.concatenate([groups[r] for r in cols_rids])
        block = CM[np.ix_(rows, cols)]
        if integral:
            integral = bool(np.isfinite(block).all()
                            and (block == np.floor(block)).all())
        rstarts = np.zeros(len(rows_rids), np.int64)
        np.cumsum(rlens[:-1], out=rstarts[1:])
        cstarts = np.zeros(len(cols_rids), np.int64)
        np.cumsum(clens[:-1], out=cstarts[1:])
        sums = np.add.reduceat(
            np.add.reduceat(block, rstarts, axis=0), cstarts, axis=1)
        rcm[np.ix_(rows_rids, cols_rids)] = \
            sums / (rlens[:, None] * clens[None, :])

    S = net.num_stages
    fill(data_rids, stage_rids[0])
    for s in range(S - 1):
        fill(stage_rids[s], stage_rids[s + 1])
    fill(stage_rids[S - 1], data_rids)
    if integral:
        rcm = np.rint(rcm)          # keep the dial core applicable
    region_net = FlowNetwork(nodes=nodes, num_stages=net.num_stages,
                             latency=rcm,
                             bandwidth=np.full((R, R), np.inf),
                             activation_size=0.0)
    return region_net, rcm, super_of, data_map


try:
    from scipy.optimize import linear_sum_assignment as _lsa
except ImportError:                               # pragma: no cover
    _lsa = None


def _solve_transport(C: np.ndarray, caps: np.ndarray,
                     quantum: float) -> List[int]:
    """Exact min-cost matching of k units to m capacitated members.

    ``C[u, j]`` is the cost of placing unit ``u`` on member ``j``;
    returns the chosen member column per unit.  Members are expanded
    into capacity-many columns and handed to scipy's C assignment
    solver (exact, ~100x faster than a python-level MCMF on these
    ~100x100 problems); without scipy the `MinCostFlow` dial core on
    quantized costs is the fallback (same optimum, bounded rounding).
    """
    k, m = C.shape
    if m == 1:
        return [0] * k
    if _lsa is not None:
        icaps = caps.astype(np.int64)
        cols = np.repeat(np.arange(m), icaps)
        _, chosen = _lsa(C[:, cols])
        return cols[chosen].tolist()
    solve_method = "dial"
    if not np.isfinite(C).all():
        Cq = C                      # disconnected pairs: dense core
        solve_method = "dense"
    elif (C == np.floor(C)).all():
        Cq = C
    else:
        Cq = np.round(C / quantum)
    V = k + m + 2
    S, T = V - 2, V - 1
    mc = MinCostFlow(V, arc_hint=k * m + k + m)
    uk = np.arange(k, dtype=np.int64)
    mk = k + np.arange(m, dtype=np.int64)
    mc.add_edges(np.full(k, S, np.int64), uk, 1.0, 0.0)
    unit_arcs = mc.add_edges(np.repeat(uk, m), np.tile(mk, k),
                             1.0, Cq.ravel())
    mc.add_edges(mk, np.full(m, T, np.int64), caps.astype(float), 0.0)
    mc.solve(S, T, float(k), method=solve_method)
    cap = mc.cap
    choice: List[int] = []
    for u in range(k):
        arcs = unit_arcs[u * m:(u + 1) * m]
        picked = np.flatnonzero(cap[arcs ^ 1] > 0.5)
        choice.append(int(picked[0]) if picked.size else 0)
    return choice


def solve_hierarchical(net: FlowNetwork,
                       cost_matrix: Optional[np.ndarray] = None,
                       data_node: Optional[int] = None,
                       max_flow: Optional[float] = None,
                       method: str = "auto",
                       parallel: int = 0,
                       refine_passes: int = 2,
                       quantum: float = DEFAULT_QUANTUM) -> HierarchicalPlan:
    """Two-phase hierarchical plan (region MCMF + local refinement).

    ``parallel`` > 0 refines a stage's per-region transports on that
    many worker threads (they are independent problems); 0 = serial.
    ``refine_passes`` coordinate-descent sweeps follow the forward
    construction (each monotonically lowers the plan cost).  Other
    parameters mirror ``solve_training_flow``.
    """
    CM = (np.asarray(cost_matrix, float) if cost_matrix is not None
          else net.cost_matrix())
    region_net, rcm, super_of, data_map = build_region_network(net, CM)
    regions = aggregate_regions(net)
    rplan = solve_training_flow(
        region_net, cost_matrix=rcm,
        data_node=None if data_node is None else data_map[data_node],
        max_flow=max_flow, want_paths=True, method=method)
    inv_data = {v: k for k, v in data_map.items()}
    S = net.num_stages
    # unit u: origin data node + its region chain (location per stage)
    origins: List[int] = []
    chains: List[List[int]] = []
    for rpath in rplan.paths:
        if len(rpath) != S + 2 or rpath[0] not in inv_data:
            continue
        origins.append(inv_data[rpath[0]])
        chains.append([super_of[r][1] for r in rpath[1:-1]])
    U = len(origins)
    concrete: List[List[int]] = [[dn] for dn in origins]
    caps_left = {nid: net.nodes[nid].capacity
                 for ids in regions.values() for nid in ids}

    def refine_group(s: int, loc: int, units: List[int], sweep: bool):
        members = regions[(s, loc)]
        marr = np.asarray(members, np.int64)
        # concrete[u][s] is unit u's stage-(s-1) node (or origin at s=0)
        parr = np.asarray([concrete[u][s] for u in units], np.int64)
        C = CM[np.ix_(parr, marr)]
        if s == S - 1:
            # the closing hop back to each unit's own origin is known
            # even during construction — fold it in so the last stage
            # is not chosen blindly
            nxt = np.asarray([origins[u] for u in units], np.int64)
            C = C + CM[np.ix_(marr, nxt)].T
        elif sweep:
            nxt = np.asarray([concrete[u][s + 2] for u in units], np.int64)
            C = C + CM[np.ix_(marr, nxt)].T
        caps = np.asarray([caps_left[mid] for mid in members], float)
        choice = _solve_transport(C, caps, quantum)
        return units, marr, choice

    def run_stage(s: int, sweep: bool):
        by_loc: Dict[int, List[int]] = {}
        for u in range(U):
            by_loc.setdefault(chains[u][s], []).append(u)
        if sweep:
            # release this stage's current seats before re-matching
            for u in range(U):
                caps_left[concrete[u][s + 1]] += 1
        groups = [(s, loc, units, sweep) for loc, units in by_loc.items()]
        if parallel > 0 and len(groups) > 1:
            with ThreadPoolExecutor(max_workers=parallel) as pool:
                results = list(pool.map(lambda g: refine_group(*g), groups))
        else:
            results = [refine_group(*g) for g in groups]
        for units, marr, choice in results:
            for u, j in zip(units, choice):
                nid = int(marr[j])
                caps_left[nid] -= 1
                if sweep:
                    concrete[u][s + 1] = nid
                else:
                    concrete[u].append(nid)

    for s in range(S):
        run_stage(s, sweep=False)
    for _ in range(max(0, refine_passes)):
        for s in range(S):
            run_stage(s, sweep=True)
    total = 0.0
    paths: List[List[int]] = []
    for u in range(U):
        chain = concrete[u] + [origins[u]]
        paths.append(chain)
        total += float(sum(CM[a, b] for a, b in zip(chain, chain[1:])))
    return HierarchicalPlan(flow=float(U), cost=total, paths=paths,
                            region_cost=rplan.cost,
                            num_regions=len({loc for _, loc in regions}),
                            regions=regions)
