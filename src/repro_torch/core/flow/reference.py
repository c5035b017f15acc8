"""Reference (unindexed) GWTF protocol — the equivalence oracle.

This is the seed's straightforward implementation of the decentralized
flow construction, kept verbatim except for two fixes shared with the
optimized engine:

* the ``step_round`` indentation bug — Request Change / Redirect used to
  run inside the data-node repair loop with a stale loop variable, so
  annealed refinement effectively never executed; here (and in the
  optimized engine) they run once per relay per round as the paper
  specifies (Sec. V-C);
* the refinement sampling uses a *batched per-round RNG discipline*: a
  round draws ``rng.shuffle`` for the node order and then ONE uniform
  block ``rng.random((len(order), 4))`` whose row ``k`` holds the four
  variates node ``order[k]`` may need this round — source polling
  rotation, refinement segment choice, and the Request Change / Request
  Redirect visit-order rotations (candidate lists are visited in sorted
  order starting at a random offset, ``int(u * n)``).  Unused slots are
  simply not read, so the stream position after a round is a pure
  function of the membership size — which is what lets the optimized
  engine vectorize whole scans without perturbing the stream.  The only
  draws made *inside* a scan are the annealed-acceptance uniforms, one
  per non-improving candidate visited while T > 1e-6, taken from the
  same stream in visit order (``numpy`` sized draws produce the
  identical sequence, so the optimized engine may draw them as one
  block).

Every query here is a linear scan (O(peers x segments) per round) and
``_refresh_costs`` is recursive — this is intentionally the *slow but
obviously correct* formulation.  ``GWTFProtocol`` in ``decentralized.py``
must produce byte-identical flows and an identical RNG stream for any
seed; ``tests/test_flow_scale.py`` asserts this and
``benchmarks/bench_scale.py`` uses this class as the pre-optimization
baseline.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.flow.decentralized import ProtoNode, Segment
from repro_torch.core.flow.graph import FlowNetwork, Node


class ReferenceGWTFProtocol:
    """Round-based execution of the decentralized flow construction,
    with per-round linear scans instead of incremental indexes."""

    def __init__(self, net: FlowNetwork, *,
                 cost_matrix: Optional[np.ndarray] = None,
                 temperature: float = 1.7, alpha: float = 0.95,
                 objective: str = "minmax",
                 peer_view: Optional[int] = None,
                 refine: bool = True,
                 rng: Optional[np.random.Generator] = None):
        self.net = net
        self.cost_matrix = cost_matrix
        self.T = temperature
        self.alpha = alpha
        self.objective = objective
        self.refine = refine
        self.rng = rng or np.random.default_rng(0)
        self.peer_view = peer_view
        self._flow_counter = itertools.count()
        self.protos: Dict[int, ProtoNode] = {}
        self._sink_slots: Dict[int, int] = {}    # data node -> free sink slots
        self._build_protocol_state()

    # ------------------------------------------------------------------
    def d(self, i: int, j: int) -> float:
        if self.cost_matrix is not None:
            return float(self.cost_matrix[i, j])
        return self.net.edge_cost(i, j)

    def _build_protocol_state(self):
        S = self.net.num_stages
        for n in self.net.nodes.values():
            if not n.alive:
                continue
            p = ProtoNode(n.id, n.stage, n.capacity)
            self.protos[n.id] = p
        for p in self.protos.values():
            n = self.net.nodes[p.node_id]
            if n.is_data:
                self._sink_slots[n.id] = n.capacity
                nxt = {m.id for m in self.net.stage_nodes(0)}
            elif n.stage == S - 1:
                nxt = {m.id for m in self.net.data_nodes() if m.alive}
            else:
                nxt = {m.id for m in self.net.stage_nodes(n.stage + 1)}
            same = {m.id for m in self.net.stage_nodes(n.stage)} - {n.id}
            if self.peer_view is not None:
                nxt = set(self.rng.choice(sorted(nxt),
                                          size=min(self.peer_view, len(nxt)),
                                          replace=False)) if nxt else set()
            p.known_next = nxt
            p.known_same = same

    # ------------------------------------------------------------------
    # Queries (what a peer answers when asked — local information only)
    # ------------------------------------------------------------------
    def _advertised(self, j: int, data_node: int) -> Optional[float]:
        """Peer j's advertised cost-to-sink for an unpaired outflow to
        ``data_node``; None if it has none (infinite)."""
        pj = self.protos.get(j)
        if pj is None or not pj.alive:
            return None
        if self.net.nodes[j].is_data:
            # the sink itself: free slot -> cost 0
            return 0.0 if (j == data_node and self._sink_slots[j] > 0) else None
        best = None
        for s in pj.unpaired_outflows():
            if s.data_node == data_node:
                if best is None or s.cost_to_sink < best:
                    best = s.cost_to_sink
        return best

    # ------------------------------------------------------------------
    # Request Flow
    # ------------------------------------------------------------------
    def _request_flow(self, i: int, data_node: int) -> bool:
        """Node i tries to pair with a subsequent-stage unpaired outflow."""
        pi = self.protos[i]
        best_j, best_total, best_cts = None, None, None
        for j in pi.known_next:
            cts = self._advertised(j, data_node)
            if cts is None:
                continue
            total = cts + self.d(i, j)
            if best_total is None or total < best_total:
                best_j, best_total, best_cts = j, total, cts
        if best_j is None:
            return False
        # --- the Request Flow message exchange ---
        pj = self.protos.get(best_j)
        if self.net.nodes[best_j].is_data:
            if self._sink_slots[best_j] <= 0:
                return False
            self._sink_slots[best_j] -= 1
            fid = next(self._flow_counter)
            pi.segments.append(Segment(fid, data_node, best_j, None, self.d(i, best_j)))
            return True
        target = None
        for s in pj.unpaired_outflows():
            if s.data_node == data_node and abs(s.cost_to_sink - best_cts) < 1e-9:
                target = s
                break
        if target is None:      # stale cost -> reject (requester retries next round)
            return False
        target.upstream = i
        pi.segments.append(Segment(target.flow_id, data_node, best_j, None,
                                   target.cost_to_sink + self.d(i, best_j)))
        return True

    # ------------------------------------------------------------------
    # Request Change (same-stage peer swap, annealed)
    # ------------------------------------------------------------------
    def _request_change(self, i: int, u_seg: float, u_rot: float) -> bool:
        pi = self.protos[i]
        if not pi.segments:
            return False
        si = pi.segments[int(u_seg * len(pi.segments))]
        if si.downstream is None or self.net.nodes[si.downstream].is_data:
            return False
        candidates = sorted(j for j in pi.known_same
                            if j in self.protos and self.protos[j].alive)
        n = len(candidates)
        start = int(u_rot * n) if n else 0
        for k in range(n):
            t = start + k
            j = candidates[t if t < n else t - n]
            pj = self.protos[j]
            for sj in pj.segments:
                if (sj.data_node != si.data_node or sj.downstream is None
                        or self.net.nodes[sj.downstream].is_data
                        or sj.downstream == si.downstream):
                    continue
                if self.objective == "sum":
                    cur = self.d(i, si.downstream) + self.d(j, sj.downstream)
                    new = self.d(i, sj.downstream) + self.d(j, si.downstream)
                else:
                    cur = max(self.d(i, si.downstream), self.d(j, sj.downstream))
                    new = max(self.d(i, sj.downstream), self.d(j, si.downstream))
                if self._anneal_accept(cur, new):
                    # swap downstream peers; inform next-stage nodes
                    di, dj = si.downstream, sj.downstream
                    self._repoint_upstream(di, old_up=i, new_up=j,
                                           data_node=si.data_node)
                    self._repoint_upstream(dj, old_up=j, new_up=i,
                                           data_node=sj.data_node)
                    si.downstream, sj.downstream = dj, di
                    self._refresh_costs(i)
                    self._refresh_costs(j)
                    return True
        return False

    def _repoint_upstream(self, downstream_id: int, *, old_up: int,
                          new_up: Optional[int], data_node: int):
        pd = self.protos.get(downstream_id)
        if pd is None:
            return
        for s in pd.segments:
            if s.upstream == old_up and s.data_node == data_node:
                s.upstream = new_up
                return

    # ------------------------------------------------------------------
    # Request Redirect (node substitution, annealed)
    # ------------------------------------------------------------------
    def _request_redirect(self, m: int, u_rot: float) -> bool:
        """Spare node m offers to replace peer b on a chain a -> b -> c."""
        pm = self.protos[m]
        if pm.free <= 0:
            return False
        peers = sorted(j for j in pm.known_same
                       if j in self.protos and self.protos[j].alive
                       and self.protos[j].segments)
        n = len(peers)
        start = int(u_rot * n) if n else 0
        for k in range(n):
            t = start + k
            b = peers[t if t < n else t - n]
            pb = self.protos[b]
            for sb in pb.segments:
                if sb.upstream is None or sb.downstream is None:
                    continue
                a, c = sb.upstream, sb.downstream
                cur = self.d(a, b) + self.d(b, c)
                new = self.d(a, m) + self.d(m, c)
                if self._anneal_accept(cur, new):
                    # b approves: m takes over the segment
                    pb.segments.remove(sb)
                    seg = dataclasses.replace(
                        sb, cost_to_sink=sb.cost_to_sink
                        - self.d(b, c) + self.d(m, c))
                    pm.segments.append(seg)
                    # upstream a (may be the data node) and downstream c repoint
                    pa = self.protos.get(a)
                    if pa is not None:
                        for s in pa.segments:
                            if s.downstream == b and s.data_node == sb.data_node:
                                s.downstream = m
                                break
                    if not self.net.nodes[c].is_data:
                        self._repoint_upstream(c, old_up=b, new_up=m,
                                               data_node=sb.data_node)
                    self._refresh_costs(m)
                    return True
        return False

    def _anneal_accept(self, cur: float, new: float) -> bool:
        if new < cur:
            self.T *= self.alpha
            return True
        if self.T <= 1e-6:
            return False
        p = math.exp(min((cur - new) / self.T, 0.0))
        if p > self.rng.uniform(0.0, 1.0):
            self.T *= self.alpha
            return True
        return False

    def _refresh_costs(self, i: int):
        """Recompute cost_to_sink for node i and broadcast upstream.

        Level-order (stage-by-stage) propagation with two message-passing
        rules shared with the optimized engine: a node visited once per
        wave recomputes *all* its segments, and a cost update is
        forwarded to a segment's feeder only if recomputation *changed*
        that segment's value (a no-op advertisement is not sent).
        """
        level = [i]
        seen = {i}
        while level:
            nxt: List[int] = []
            for nid in level:
                pi = self.protos.get(nid)
                if pi is None:
                    continue
                for s in pi.segments:
                    if s.downstream is None:
                        continue
                    down_cost = 0.0
                    pd = self.protos.get(s.downstream)
                    if (pd is not None
                            and not self.net.nodes[s.downstream].is_data):
                        for sd in pd.segments:
                            if (sd.upstream == nid
                                    and sd.data_node == s.data_node):
                                down_cost = sd.cost_to_sink
                                break
                    val = down_cost + self.d(nid, s.downstream)
                    if val != s.cost_to_sink:
                        s.cost_to_sink = val
                        up = s.upstream
                        if (up is not None and up not in seen
                                and not self.net.nodes[up].is_data):
                            seen.add(up)
                            nxt.append(up)
            level = nxt

    # ------------------------------------------------------------------
    # Round driver
    # ------------------------------------------------------------------
    def step_round(self) -> int:
        """One synchronous protocol round; returns number of state changes."""
        changes = 0
        order = np.asarray(sorted(self.protos))
        self.rng.shuffle(order)
        # the round's RNG block: row k = (source rotation, segment choice,
        # change rotation, redirect rotation) for node order[k].  Drawn
        # unconditionally so the stream position is decision-independent.
        block = self.rng.random((len(order), 4))
        for k, i in enumerate(order.tolist()):
            pi = self.protos[i]
            if not pi.alive or self.net.nodes[i].is_data:
                continue
            if pi.free > 0 and pi.stable():
                for dn in self._known_data_nodes(i, block[k, 0]):
                    if pi.free <= 0:
                        break
                    if self._request_flow(i, dn):
                        changes += 1
            # nodes with unpaired inflow (downstream lost) re-pair downstream
            for s in list(pi.segments):
                if s.downstream is None:
                    if self._repair_downstream(i, s):
                        s._deny_after = 3
                        changes += 1
                    else:
                        # DENY (Sec. V-D): if no alternate peer exists after
                        # a few attempts, release the segment and tell the
                        # upstream so the flow can be redistributed.
                        s._deny_after = getattr(s, "_deny_after", 3) - 1
                        if s._deny_after <= 0:
                            self._deny(i, s)
                            changes += 1
            # annealed refinement runs for every relay, every round
            # (paper Sec. V-C)
            if self.refine:
                if self._request_change(i, block[k, 1], block[k, 2]):
                    changes += 1
                if self._request_redirect(i, block[k, 3]):
                    changes += 1
        # data nodes also repair source-side segments whose downstream died
        for dn in self.net.data_nodes():
            pd = self.protos.get(dn.id)
            if pd is None:
                continue
            for s in list(pd.segments):
                if s.downstream is None:
                    pd.segments.remove(s)       # re-issue via _connect_sources
                    changes += 1
        # data nodes (source side) connect to stage-0 unpaired outflows
        changes += self._connect_sources()
        return changes

    def _known_data_nodes(self, i: int, u_rot: float) -> List[int]:
        # rotation from a random offset: avoids fixed-priority source
        # bias without a per-node shuffle draw
        dns = [n.id for n in self.net.data_nodes() if n.alive]
        if len(dns) > 1:
            r = int(u_rot * len(dns))
            dns = dns[r:] + dns[:r]
        return dns

    def _repair_downstream(self, i: int, seg: Segment) -> bool:
        """Re-pair a segment whose downstream crashed (unpaired inflow)."""
        pi = self.protos[i]
        best_j, best_total, best_cts = None, None, None
        for j in pi.known_next:
            cts = self._advertised(j, seg.data_node)
            if cts is None:
                continue
            total = cts + self.d(i, j)
            if best_total is None or total < best_total:
                best_j, best_total, best_cts = j, total, cts
        if best_j is None:
            return False
        if self.net.nodes[best_j].is_data:
            if self._sink_slots[best_j] <= 0:
                return False
            self._sink_slots[best_j] -= 1
            seg.downstream = best_j
            seg.cost_to_sink = self.d(i, best_j)
            return True
        pj = self.protos[best_j]
        for s in pj.unpaired_outflows():
            if s.data_node == seg.data_node and abs(s.cost_to_sink - best_cts) < 1e-9:
                s.upstream = i
                seg.downstream = best_j
                seg.cost_to_sink = s.cost_to_sink + self.d(i, best_j)
                return True
        return False

    def _deny(self, i: int, seg: Segment):
        """Drop an unrepairable segment and unpair its upstream feeder."""
        pi = self.protos.get(i)
        if pi is None or seg not in pi.segments:
            return
        up = seg.upstream
        pi.segments.remove(seg)
        if up is None:
            return
        pu = self.protos.get(up)
        if pu is None:
            return
        if self.net.nodes[up].is_data:
            # the source drops its segment and re-issues via connect_sources
            for su in list(pu.segments):
                if su.downstream == i and su.data_node == seg.data_node:
                    pu.segments.remove(su)
                    break
        else:
            for su in pu.segments:
                if su.downstream == i and su.data_node == seg.data_node:
                    su.downstream = None
                    break

    def _connect_sources(self) -> int:
        """Source side of each data node pairs with stage-0 unpaired outflows."""
        changes = 0
        for dn in self.net.data_nodes():
            if not dn.alive:
                continue
            pd = self.protos[dn.id]
            while pd.used < pd.capacity:
                best = None
                for j in pd.known_next:
                    pj = self.protos.get(j)
                    if pj is None or not pj.alive:
                        continue
                    for s in pj.unpaired_outflows():
                        if s.data_node == dn.id:
                            total = s.cost_to_sink + self.d(dn.id, j)
                            if best is None or total < best[0]:
                                best = (total, j, s)
                if best is None:
                    break
                _, j, s = best
                s.upstream = dn.id
                pd.segments.append(Segment(s.flow_id, dn.id, j, None,
                                           best[0]))
                changes += 1
        return changes

    def run(self, max_rounds: int = 200, quiet_rounds: int = 25) -> int:
        quiet = 0
        r = 0
        for r in range(max_rounds):
            if self.step_round() == 0:
                quiet += 1
                if quiet >= quiet_rounds:
                    break
            else:
                quiet = 0
        return r + 1

    # ------------------------------------------------------------------
    # Results
    # ------------------------------------------------------------------
    def complete_flows(self) -> List[List[int]]:
        """Chains data_node -> s0 -> ... -> s(S-1) -> data_node."""
        chains = []
        visited = set()
        for dn in self.net.data_nodes():
            pd = self.protos.get(dn.id)
            if pd is None:
                continue
            for seg in pd.segments:
                chain = [dn.id]
                prev, cur = dn.id, seg.downstream
                ok = True
                for _ in range(self.net.num_stages + 1):
                    if cur is None:
                        ok = False
                        break
                    chain.append(cur)
                    if cur == dn.id:
                        break
                    pc = self.protos.get(cur)
                    nxt = None
                    if pc is not None:
                        for s in pc.segments:
                            if (id(s) not in visited and s.upstream == prev
                                    and s.data_node == dn.id):
                                nxt = s.downstream
                                visited.add(id(s))
                                break
                    prev, cur = cur, nxt
                if ok and chain[-1] == dn.id and len(chain) == self.net.num_stages + 2:
                    chains.append(chain)
        return chains

    def flow_costs(self) -> List[float]:
        costs = []
        for chain in self.complete_flows():
            c = sum(self.d(chain[k], chain[k + 1]) for k in range(len(chain) - 1))
            costs.append(c)
        return costs

    def total_cost(self) -> float:
        return float(sum(self.flow_costs()))

    def max_edge_cost(self) -> float:
        m = 0.0
        for chain in self.complete_flows():
            for k in range(len(chain) - 1):
                m = max(m, self.d(chain[k], chain[k + 1]))
        return m

    # ------------------------------------------------------------------
    # Churn hooks (used by the simulator)
    # ------------------------------------------------------------------
    def reclaim_sink_slots(self):
        """Recount free sink slots + garbage-collect stale segments."""
        self._gc_pass = getattr(self, "_gc_pass", 0) + 1
        for p in self.protos.values():
            node = self.net.nodes.get(p.node_id)
            if node is None or node.is_data:
                continue
            for s in list(p.segments):
                unpaired = s.upstream is None or s.downstream is None
                last = getattr(s, "_stale_since", None)
                if unpaired:
                    if last is None:
                        s._stale_since = self._gc_pass
                    elif self._gc_pass - last >= 2:
                        # free the memory; downstream/upstream unpair too
                        if s.downstream is not None:
                            self._repoint_upstream(s.downstream, old_up=p.node_id,
                                                   new_up=None,
                                                   data_node=s.data_node)
                        if s.upstream is not None:
                            pu = self.protos.get(s.upstream)
                            if pu is not None:
                                for su in pu.segments:
                                    if (su.downstream == p.node_id
                                            and su.data_node == s.data_node):
                                        su.downstream = None
                                        break
                        p.segments.remove(s)
                else:
                    s._stale_since = None
        for dn in self.net.data_nodes():
            used = 0
            for p in self.protos.values():
                node = self.net.nodes.get(p.node_id)
                if node is None or node.is_data:
                    continue
                for s in p.segments:
                    if s.downstream == dn.id and s.data_node == dn.id:
                        used += 1
            self._sink_slots[dn.id] = max(0, dn.capacity - used)

    def remove_node(self, nid: int):
        """Crash: drop the node, unpair all segments that touched it."""
        p = self.protos.pop(nid, None)
        if p is None:
            return
        for other in self.protos.values():
            other.known_next.discard(nid)
            other.known_same.discard(nid)
            for s in other.segments:
                if s.downstream == nid:
                    s.downstream = None          # unpaired inflow: re-pair later
                if s.upstream == nid:
                    s.upstream = None            # unpaired outflow again
        # sink slots freed for flows that died with this node are reclaimed
        # lazily by the simulator between iterations.

    def add_node(self, node: Node):
        """Join: create protocol state with adjacent-stage views."""
        S = self.net.num_stages
        p = ProtoNode(node.id, node.stage, node.capacity)
        if node.stage == S - 1:
            p.known_next = {m.id for m in self.net.data_nodes() if m.alive}
        else:
            p.known_next = {m.id for m in self.net.stage_nodes(node.stage + 1)}
        p.known_same = {m.id for m in self.net.stage_nodes(node.stage)} - {node.id}
        self.protos[node.id] = p
        for other in self.protos.values():
            if other.node_id == node.id:
                continue
            on = self.net.nodes.get(other.node_id)
            if on is None:
                continue
            if on.stage == node.stage - 1 or (on.is_data and node.stage == 0):
                other.known_next.add(node.id)
            if on.stage == node.stage and not on.is_data:
                other.known_same.add(node.id)
            if on.is_data and node.stage == S - 1:
                p.known_next.add(on.id)
