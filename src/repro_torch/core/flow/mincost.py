"""Centralized min-cost max-flow oracle (out-of-kilter equivalent).

The paper's optimal baselines (Fig. 5, Fig. 7, Table VI) use Fulkerson's
out-of-kilter algorithm [19].  We implement successive shortest paths
with Johnson potentials, which computes the same optimum (min-cost
max-flow is unique in value).

Arc storage is preallocated NumPy arrays with geometric growth (amortized
O(1) per ``add_edge``; ``add_edges`` appends whole arc batches in one
vectorized write — the layered training graph's dense stage-to-stage
mesh builds in milliseconds instead of hundreds of thousands of Python
calls).  Two interchangeable Dijkstra cores drive the successive
shortest paths:

* **dial** (default when every arc cost is a small integer, as in the
  paper's Table IV/V graphs): Johnson potentials stay integral, so each
  Dijkstra runs over integer distances with a bucket (Dial) queue —
  node extraction is an O(1) bucket pop driven by a tiny heap of
  distinct distances, relaxation stays vectorized per CSR slice, and
  the search stops as soon as the sink settles.  O(F * (E + D log D))
  with D = distinct distance values; ~10x over the dense core on the
  2000-relay scaling benchmark, which makes the optimal baseline cheap
  enough to re-run online next to the decentralized engine.
* **dense**: masked ``argmin`` extraction over the distance vector,
  O(F * (V^2 + E)) — the general-cost fallback (and the equality oracle
  for the dial core's tests).

``solve(..., method=)`` accepts ``"auto"`` (integer costs -> dial),
``"dial"``, or ``"dense"``.

The training graph is layered: super-source -> data nodes -> stage 0 ->
... -> stage S-1 -> super-sink, node capacities enforced by splitting
every node into (in, out) with a capacity arc.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.flow.graph import FlowNetwork


class MinCostFlow:
    """Successive-shortest-paths MCMF on preallocated NumPy arc arrays.

    ``to``/``cap``/``cost`` keep their original (arc-indexed) meaning —
    arc ``i ^ 1`` is the reverse of arc ``i`` — but are exposed as array
    views; ``graph[u]`` (adjacency lists of arc ids, insertion order) is
    materialised lazily for the path-decomposition consumers.
    """

    def __init__(self, n: int, arc_hint: int = 64):
        self.n = n
        self._m = 0
        capacity = max(16, 2 * arc_hint)
        self._to = np.empty(capacity, np.int64)
        self._cap = np.empty(capacity, np.float64)
        self._cost = np.empty(capacity, np.float64)
        self._src = np.empty(capacity, np.int64)
        self._graph: Optional[List[List[int]]] = None

    # -- array views / legacy accessors ---------------------------------
    @property
    def to(self) -> np.ndarray:
        return self._to[:self._m]

    @property
    def cap(self) -> np.ndarray:
        return self._cap[:self._m]

    @property
    def cost(self) -> np.ndarray:
        return self._cost[:self._m]

    @property
    def graph(self) -> List[List[int]]:
        if self._graph is None:
            g: List[List[int]] = [[] for _ in range(self.n)]
            for idx, u in enumerate(self._src[:self._m].tolist()):
                g[u].append(idx)
            self._graph = g
        return self._graph

    def _grow(self, need: int):
        capacity = len(self._to)
        if need <= capacity:
            return
        new = max(need, 2 * capacity)
        for name in ("_to", "_cap", "_cost", "_src"):
            old = getattr(self, name)
            arr = np.empty(new, old.dtype)
            arr[:self._m] = old[:self._m]
            setattr(self, name, arr)

    def add_edge(self, u: int, v: int, cap: float, cost: float) -> int:
        idx = self._m
        self._grow(idx + 2)
        self._to[idx] = v
        self._cap[idx] = cap
        self._cost[idx] = cost
        self._src[idx] = u
        self._to[idx + 1] = u
        self._cap[idx + 1] = 0.0
        self._cost[idx + 1] = -cost
        self._src[idx + 1] = v
        self._m += 2
        self._graph = None
        return idx

    def add_edges(self, us, vs, caps, costs) -> np.ndarray:
        """Vectorized batch append; returns the forward arc indices.

        Equivalent to ``[add_edge(u, v, c, w) for ...]`` (same arc ids,
        same ``i ^ 1`` reverse pairing) in a handful of array writes.
        """
        us = np.asarray(us, np.int64)
        vs = np.asarray(vs, np.int64)
        caps = np.broadcast_to(np.asarray(caps, np.float64), us.shape)
        costs = np.broadcast_to(np.asarray(costs, np.float64), us.shape)
        k = len(us)
        m0 = self._m
        self._grow(m0 + 2 * k)
        fwd = m0 + 2 * np.arange(k, dtype=np.int64)
        self._to[fwd] = vs
        self._to[fwd + 1] = us
        self._cap[fwd] = caps
        self._cap[fwd + 1] = 0.0
        self._cost[fwd] = costs
        self._cost[fwd + 1] = -costs
        self._src[fwd] = us
        self._src[fwd + 1] = vs
        self._m = m0 + 2 * k
        self._graph = None
        return fwd

    def solve(self, s: int, t: int, max_flow: float = float("inf"),
              method: str = "auto") -> Tuple[float, float]:
        """Returns (flow, cost).

        ``method``: ``"dial"`` (integer-cost bucket-queue Dijkstra),
        ``"dense"`` (masked-argmin Dijkstra, any costs), or ``"auto"``
        (dial iff every arc cost is a finite integer).
        """
        m = self._m
        costs = self._cost[:m]
        if method == "auto":
            finite = np.isfinite(costs)
            integral = bool(finite.all()
                            and (costs == np.floor(costs)).all())
            method = "dial" if integral else "dense"
        elif method == "dial":
            if not (np.isfinite(costs).all()
                    and (costs == np.floor(costs)).all()):
                raise ValueError("dial method requires finite integer "
                                 "arc costs")
        if method == "dial":
            return self._solve_dial(s, t, max_flow)
        return self._solve_dense(s, t, max_flow)

    def _csr(self):
        """CSR adjacency: arcs grouped by source, insertion order kept."""
        n, m = self.n, self._m
        src = self._src[:m]
        arc_order = np.argsort(src, kind="stable")
        to_sorted = self._to[arc_order]
        cost_sorted = self._cost[arc_order]
        start = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(src, minlength=n), out=start[1:])
        return arc_order, to_sorted, cost_sorted, start

    def _augment(self, s: int, t: int, prev_arc: np.ndarray,
                 headroom: float) -> Tuple[float, float]:
        """Push the bottleneck along prev_arc's s->t path; returns
        (pushed flow, added cost)."""
        push = headroom
        v = t
        while v != s:
            idx = int(prev_arc[v])
            cap = float(self._cap[idx])
            if cap < push:
                push = cap
            v = int(self._to[idx ^ 1])
        cost = 0.0
        v = t
        while v != s:
            idx = int(prev_arc[v])
            self._cap[idx] -= push
            self._cap[idx ^ 1] += push
            cost += push * float(self._cost[idx])
            v = int(self._to[idx ^ 1])
        return push, cost

    def _solve_dense(self, s: int, t: int,
                     max_flow: float) -> Tuple[float, float]:
        n = self.n
        arc_order, to_sorted, cost_sorted, start = self._csr()
        inf = float("inf")
        flow = cost = 0.0
        potential = np.zeros(n)
        while flow < max_flow:
            dist = np.full(n, inf)
            dist[s] = 0.0
            prev_arc = np.full(n, -1, np.int64)
            done = np.zeros(n, bool)
            for _ in range(n):
                u = int(np.argmin(np.where(done, inf, dist)))
                if done[u] or dist[u] == inf:
                    break
                done[u] = True
                a0, a1 = int(start[u]), int(start[u + 1])
                if a0 == a1:
                    continue
                arcs = arc_order[a0:a1]
                open_ = self._cap[arcs] > 1e-9
                if not open_.any():
                    continue
                arcs = arcs[open_]
                vs = to_sorted[a0:a1][open_]
                nd = dist[u] + cost_sorted[a0:a1][open_] \
                    + potential[u] - potential[vs]
                better = nd < dist[vs] - 1e-12
                if better.any():
                    vs_b = vs[better]
                    nd_b = nd[better]
                    arcs_b = arcs[better]
                    np.minimum.at(dist, vs_b, nd_b)
                    # any arc achieving the (possibly shared) new minimum
                    won = nd_b == dist[vs_b]
                    prev_arc[vs_b[won]] = arcs_b[won]
            if dist[t] == inf:
                break
            finite = dist < inf
            potential[finite] += dist[finite]
            push, added = self._augment(s, t, prev_arc, max_flow - flow)
            cost += added
            flow += push
        return float(flow), float(cost)

    def _solve_dial(self, s: int, t: int,
                    max_flow: float) -> Tuple[float, float]:
        """Integer-cost core: bucket-queue Dijkstra phases, each
        followed by a *blocking flow* over the admissible
        (zero-reduced-cost) subgraph.

        Reduced costs under integral Johnson potentials stay integral
        and non-negative, so distances are exact ints (no epsilon
        comparisons) and node extraction is an O(1) bucket pop driven
        by a heap of distinct distances, stopping as soon as the sink
        settles.  Every augmenting path inside the admissible subgraph
        is a current shortest path, so saturating a blocking flow per
        phase pushes what plain successive-shortest-paths would push
        over many identical Dijkstra re-runs — same optimum, a fraction
        of the searches."""
        n = self.n
        arc_order, to_sorted, cost_sorted, start = self._csr()
        cost_i = cost_sorted.astype(np.int64)
        INF = np.iinfo(np.int64).max
        flow = cost = 0.0
        potential = np.zeros(n, np.int64)
        cap = self._cap
        while flow < max_flow:
            dist = np.full(n, INF, np.int64)
            dist[s] = 0
            done = np.zeros(n, bool)
            buckets: Dict[int, List[int]] = {0: [s]}
            heap = [0]
            dist_t = INF
            while heap:
                d = heapq.heappop(heap)
                if d >= dist_t:
                    break                      # sink settled: done
                for u in buckets.pop(d, ()):
                    if done[u] or dist[u] != d:
                        continue               # stale bucket entry
                    done[u] = True
                    if u == t:
                        dist_t = d
                        break
                    a0, a1 = int(start[u]), int(start[u + 1])
                    if a0 == a1:
                        continue
                    arcs = arc_order[a0:a1]
                    open_ = cap[arcs] > 1e-9
                    if not open_.any():
                        continue
                    vs = to_sorted[a0:a1][open_]
                    nd = d + cost_i[a0:a1][open_] \
                        + potential[u] - potential[vs]
                    better = nd < dist[vs]
                    if not better.any():
                        continue
                    vs_b = vs[better]
                    nd_b = nd[better]
                    np.minimum.at(dist, vs_b, nd_b)
                    won = nd_b == dist[vs_b]
                    for v, nv in zip(vs_b[won].tolist(),
                                     nd_b[won].tolist()):
                        bk = buckets.get(nv)
                        if bk is None:
                            buckets[nv] = [v]
                            heapq.heappush(heap, nv)
                        else:
                            bk.append(v)
                if dist_t < INF:
                    break
            if dist_t == INF:
                break
            # early-stopped: unsettled nodes count as dist_t (the
            # standard truncation keeps reduced costs non-negative)
            np.minimum(dist, dist_t, out=dist)
            potential += dist
            pushed, added = self._blocking_flow(
                s, t, max_flow - flow, potential,
                arc_order, to_sorted, start)
            if pushed <= 0.0:
                break                          # numerical safety valve
            flow += pushed
            cost += added
        return float(flow), float(cost)

    def _blocking_flow(self, s: int, t: int, headroom: float,
                       potential: np.ndarray, arc_order: np.ndarray,
                       to_sorted: np.ndarray, start: np.ndarray
                       ) -> Tuple[float, float]:
        """Saturate augmenting paths in the admissible subgraph (arcs
        with zero reduced cost and open capacity) via a current-arc DFS
        — Dinic's blocking-flow step specialised to the cost-admissible
        network.  Returns (pushed flow, added cost)."""
        m = self._m
        src = self._src[:m]
        to = self._to[:m]
        # reduced costs are integral-valued floats: exact zero test
        rc = self._cost[:m] + potential[src] - potential[to]
        adm = (rc == 0.0) & (self._cap[:m] > 1e-9)
        adm_sorted = adm[arc_order]
        pos = np.flatnonzero(adm_sorted)
        if not pos.size:
            return 0.0, 0.0
        arcs_c = arc_order[pos].tolist()
        to_c = to_sorted[pos].tolist()
        start_c = np.searchsorted(pos, start).tolist()
        ptr = start_c[:-1]                     # current-arc pointers
        end_c = start_c[1:]
        cap = self._cap
        cost_arr = self._cost
        pushed = added = 0.0
        path: List[int] = []                   # compacted arc positions
        nodes: List[int] = [s]
        onpath = [False] * self.n              # zero-cost cycles exist in
        onpath[s] = True                       # the admissible graph —
        u = s                                  # never re-enter the path
        while True:
            if u == t:
                arcs = [arcs_c[p] for p in path]
                push = headroom - pushed
                for a in arcs:
                    c = float(cap[a])
                    if c < push:
                        push = c
                for a in arcs:
                    cap[a] -= push
                    cap[a ^ 1] += push
                    added += push * float(cost_arr[a])
                pushed += push
                if pushed >= headroom - 1e-9:
                    break
                # rewind to just before the first saturated arc
                cut = 0
                for k, a in enumerate(arcs):
                    if cap[a] <= 1e-9:
                        cut = k
                        break
                del path[cut:]
                for nid in nodes[cut + 1:]:
                    onpath[nid] = False
                del nodes[cut + 1:]
                u = nodes[-1]
                continue
            advanced = False
            p = ptr[u]
            e = end_c[u]
            while p < e:
                if cap[arcs_c[p]] > 1e-9 and not onpath[to_c[p]]:
                    advanced = True
                    break
                p += 1
            ptr[u] = p
            if advanced:
                path.append(p)
                u = to_c[p]
                nodes.append(u)
                onpath[u] = True
            else:
                if u == s:
                    break
                path.pop()
                nodes.pop()
                onpath[u] = False
                u = nodes[-1]
                ptr[u] += 1             # dead-end child: advance past
        return pushed, added


@dataclass
class OptimalPlan:
    flow: float
    cost: float
    paths: List[List[int]]       # node-id paths, one per unit of flow


def solve_training_flow(net: FlowNetwork,
                        cost_matrix: Optional[np.ndarray] = None,
                        data_node: Optional[int] = None,
                        max_flow: Optional[float] = None,
                        want_paths: bool = False,
                        method: str = "auto") -> OptimalPlan:
    """Optimal min-cost max-flow through the stage-layered training graph.

    cost_matrix overrides Eq.1 edge costs (flow tests draw d_ij directly).
    When no override is given, ``net.cost_matrix()`` is consumed as-is —
    including per-link wire-codec pricing when the network carries a
    codec menu — so the oracle optimizes over the same codec-priced
    graph as the decentralized engine.
    When ``data_node`` is given, only that source's flow is considered
    (the GWTF formulation requires flow to return to its own origin).
    ``method`` selects the Dijkstra core (see ``MinCostFlow.solve``).
    """
    CM = (np.asarray(cost_matrix, np.float64) if cost_matrix is not None
          else net.cost_matrix())

    sources = ([net.nodes[data_node]] if data_node is not None
               else net.data_nodes())
    relays = [n for n in net.alive_nodes() if not n.is_data]
    ids = [n.id for n in sources + relays]
    # node splitting: in = 2*k, out = 2*k+1
    index = {nid: k for k, nid in enumerate(ids)}
    V = 2 * len(ids) + 2
    S, T = V - 2, V - 1
    mc = MinCostFlow(V, arc_hint=len(ids) * 8)
    # split-node capacity arcs (in -> out), then supply arcs — batched,
    # same arc order as the scalar construction
    ks = np.array([index[n.id] for n in sources + relays], np.int64)
    caps = np.array([n.capacity for n in sources + relays], np.float64)
    mc.add_edges(2 * ks, 2 * ks + 1, caps, 0.0)
    src_ks = np.array([index[n.id] for n in sources], np.int64)
    src_caps = np.array([n.capacity for n in sources], np.float64)
    mc.add_edges(np.full(len(sources), S, np.int64), 2 * src_ks,
                 src_caps, 0.0)
    total_supply = float(src_caps.sum())
    first = [n for n in relays if n.stage == 0]
    last = [n for n in relays if n.stage == net.num_stages - 1]
    first_ids = np.array([n.id for n in first], np.int64)
    last_ids = np.array([n.id for n in last], np.int64)
    first_ks = np.array([index[n.id] for n in first], np.int64)
    last_ks = np.array([index[n.id] for n in last], np.int64)
    inf = float("inf")
    for src in sources:
        sk = index[src.id]
        if len(first):
            mc.add_edges(np.full(len(first), 2 * sk + 1, np.int64),
                         2 * first_ks, inf, CM[src.id, first_ids])
        if len(last):
            mc.add_edges(2 * last_ks + 1,
                         np.full(len(last), T, np.int64),
                         inf, CM[last_ids, src.id])
    by_stage: Dict[int, List] = {}
    for n in relays:
        by_stage.setdefault(n.stage, []).append(n)
    for s in range(net.num_stages - 1):
        a_nodes = by_stage.get(s, [])
        b_nodes = by_stage.get(s + 1, [])
        if not a_nodes or not b_nodes:
            continue
        a_ids = np.array([n.id for n in a_nodes], np.int64)
        b_ids = np.array([n.id for n in b_nodes], np.int64)
        a_ks = np.array([index[n.id] for n in a_nodes], np.int64)
        b_ks = np.array([index[n.id] for n in b_nodes], np.int64)
        us = np.repeat(2 * a_ks + 1, len(b_nodes))
        vs = np.tile(2 * b_ks, len(a_nodes))
        costs = CM[a_ids][:, b_ids].ravel()
        mc.add_edges(us, vs, inf, costs)
    cap = total_supply if max_flow is None else max_flow
    flow, cost = mc.solve(S, T, cap, method=method)
    paths: List[List[int]] = []
    if want_paths:
        # flow decomposition over the layered DAG: forward arcs with
        # positive residual-backwards capacity carry flow.
        rev = {2 * index[n.id]: n.id for n in sources + relays}
        rev.update({2 * index[n.id] + 1: n.id for n in sources + relays})
        arc_flow = {}
        for u in range(mc.n):
            for idx in mc.graph[u]:
                if idx % 2 == 0 and mc.cap[idx ^ 1] > 1e-9:
                    arc_flow[idx] = mc.cap[idx ^ 1]
        for _ in range(int(flow)):
            # walk S -> T via arcs with remaining decomposed flow
            path, u, ok = [], S, True
            guard = 0
            while u != T and guard < 10 * mc.n:
                guard += 1
                nxt = None
                for idx in mc.graph[u]:
                    if idx % 2 == 0 and arc_flow.get(idx, 0) > 1e-9:
                        nxt = idx
                        break
                if nxt is None:
                    ok = False
                    break
                arc_flow[nxt] -= 1
                u = mc.to[nxt]
                if u in rev and (not path or path[-1] != rev[u]):
                    path.append(rev[u])
            if ok and path:
                # dedupe node-split duplicates, close the loop at origin
                dedup = []
                for nid in path:
                    if not dedup or dedup[-1] != nid:
                        dedup.append(nid)
                dedup.append(dedup[0])
                paths.append(dedup)
    return OptimalPlan(flow=flow, cost=cost, paths=paths)
