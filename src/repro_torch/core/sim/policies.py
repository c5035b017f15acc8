"""Scheduler layer: pluggable routing/recovery policies for the engine.

A `RoutingPolicy` answers the three questions the event core asks:

* `plan()` — which microbatch paths run this iteration;
* `recover(view, mb, frm, dead, t)` — a sender timed out on `dead`:
  what now?  Returns one of the `Decision` shapes below; the engine
  applies the bookkeeping (slot release, wasted-GPU accounting, resend)
  so every policy shares identical, well-tested fault mechanics;
* membership hooks `on_rejoin` / `on_crash` — keep any internal state
  (e.g. the GWTF protocol's flow graph) in sync with churn.

Decisions (plain tuples, matched on the first element):

* `("fail",)` — give up on the microbatch (accounted as wasted GPU);
* `("substitute", node_id, extra_delay)` — splice `node_id` into the
  current path position and resend after `extra_delay` seconds (GWTF's
  backward *pipeline repair* pays one stage-forward recompute here);
* `("restart", path_or_None)` — SWARM's full-pipeline recomputation:
  drop all progress and start over on `path` (fail if None).

Implementations extract the pre-refactor `TrainingSimulator` if/elif
branches verbatim: `GWTFPolicy` (flow-based, `GWTFProtocol` behind the
interface), `SwarmPolicy` (greedy stochastic `SwarmRouter`), and
`FixedPolicy` (preset schedules — the DT-FM baseline of Table VI; it
cannot reroute).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from repro_torch.core.flow.decentralized import GWTFProtocol
from repro_torch.core.flow.graph import FlowNetwork, Node
from repro_torch.core.swarm import SwarmRouter

Decision = Tuple  # ("fail",) | ("substitute", nid, delay) | ("restart", path)


class FaultView:
    """Read-only window onto the engine's iteration state, handed to
    policies at fault time.

    Exposes the engine's batched per-iteration tables directly (plain
    lists — the fault path scans whole candidate stages, so indexing
    must not pay per-call overhead): node `nid` is alive at time `t`
    iff ``alive[nid] and t < crash[nid]``; its current load is
    ``busy[nid] + len(queues[nid])``; transfer/edge costs from `i` to
    `j` are ``comm_rows[i][j]`` / ``edge_rows[i][j]`` at
    ``activation_bytes``; per-direction compute times are
    ``fwd_t[nid]`` / ``bwd_t[nid]``.  ``stage_nodes(s)`` returns the
    stage's alive-membership list, cached for the iteration (liveness
    within the running iteration is `alive`/`crash`, not membership).
    """
    __slots__ = ("net", "activation_bytes", "alive", "crash", "busy",
                 "queues", "fwd_t", "bwd_t", "comm_rows", "edge_rows",
                 "stage_nodes")

    net: FlowNetwork
    activation_bytes: float
    alive: List[bool]
    crash: List[float]
    busy: List[int]
    queues: list
    fwd_t: List[float]
    bwd_t: List[float]
    comm_rows: List[List[float]]
    edge_rows: List[List[float]]
    stage_nodes: Callable[[int], list]


class RoutingPolicy(Protocol):
    name: str

    def plan(self) -> List[Sequence[int]]:
        """Paths (data_node, stage_0, ..., stage_{S-1}, data_node) to
        launch this iteration."""
        ...

    def recover(self, view: FaultView, mb, frm: int, dead: int,
                t: float) -> Decision:
        ...

    def on_rejoin(self, node: Node) -> None:
        ...

    def on_crash(self, nid: int) -> None:
        ...


def _target_stage(net: FlowNetwork, dead: int) -> int:
    dead_node = net.nodes[dead]
    return dead_node.stage if not dead_node.is_data else net.num_stages


class GWTFPolicy:
    """Flow-based scheduling (paper Sec. V) behind the policy interface.

    Forward fault: Request Flow applied at fault time — cheapest alive
    next-stage node with spare capacity.  Backward fault: *pipeline
    repair* (Sec. V-D) — a substitute recomputes only the dead stage's
    forward from the stored upstream activation before the backward
    resumes; no full-pipeline recompute.

    ``track_optimality=True`` runs the dial `MinCostFlow` oracle next
    to every plan and publishes ``last_cost_ratio`` — (cost of the
    planned flows) / (the oracle's optimal cost for the *same number of
    flows* on the same alive network) — which the engine copies into
    ``IterationMetrics.cost_ratio_vs_optimal``.  Float (geo) cost
    matrices are quantized to integers for the dial core
    (``oracle_quantum``), so the reported ratio carries a bounded
    quantization error of at most one quantum per edge.

    ``throttle_planning()`` is the engine's planning-overrun cap: each
    call halves ``repair_rounds`` (floor 2) so a planner whose wall
    time dwarfs the event loop degrades gracefully instead of
    superlinearly.
    """
    name = "gwtf"

    def __init__(self, net: FlowNetwork, *,
                 rng: Optional[np.random.Generator] = None,
                 warmup_rounds: int = 100, repair_rounds: int = 30,
                 repair_quiet_rounds: int = 2,
                 track_optimality: bool = False,
                 oracle_quantum: float = 1e-3):
        self.net = net
        self.repair_rounds = repair_rounds
        self.repair_quiet_rounds = repair_quiet_rounds
        self.track_optimality = track_optimality
        self.oracle_quantum = oracle_quantum
        self.last_cost_ratio: Optional[float] = None
        self.last_oracle_seconds: float = 0.0
        self.protocol = GWTFProtocol(net, rng=rng)
        self.protocol.run(max_rounds=warmup_rounds)

    def plan(self) -> List[Sequence[int]]:
        # Nodes still dead from previous iterations were removed; run a
        # few repair rounds (Sec. V-A runs in parallel with training).
        self.protocol.reclaim_sink_slots()
        self.protocol.run(max_rounds=self.repair_rounds,
                          quiet_rounds=self.repair_quiet_rounds)
        flows = self.protocol.complete_flows()
        if self.track_optimality:
            self._update_cost_ratio(flows)
        return flows

    def throttle_planning(self) -> int:
        """Engine overrun cap: halve the per-iteration repair budget."""
        self.repair_rounds = max(2, self.repair_rounds // 2)
        return self.repair_rounds

    def _update_cost_ratio(self, flows: List[Sequence[int]]):
        """Dial-oracle optimality gap of this iteration's plan.

        The oracle is restricted to the planned flow *volume* (so a
        partially-repaired plan is compared against the optimal routing
        of the same number of flows, not blamed for flows it could not
        launch), and the cost matrix is quantized to ``oracle_quantum``
        integer steps to keep the O(V + C) dial core applicable to
        float geo costs.  Consumes no protocol RNG.
        """
        import time as _time
        from repro_torch.core.flow.mincost import solve_training_flow
        self.last_cost_ratio = None
        if not flows:
            return
        t0 = _time.perf_counter()
        CM = self.net.cost_matrix()
        q = self.oracle_quantum
        CMq = np.round(CM / q)
        planned = sum(sum(CMq[a][b] for a, b in zip(f, f[1:]))
                      for f in flows)
        try:
            plan_opt = solve_training_flow(
                self.net, cost_matrix=CMq, max_flow=float(len(flows)),
                method="dial")
        except ValueError:
            self.last_oracle_seconds = _time.perf_counter() - t0
            return                      # non-finite costs: oracle N/A
        if plan_opt.cost > 0 and plan_opt.flow >= len(flows):
            self.last_cost_ratio = float(planned) / plan_opt.cost
        self.last_oracle_seconds = _time.perf_counter() - t0

    def _reroute(self, view: FaultView, mb, frm: int, target_stage: int,
                 t: float) -> Optional[int]:
        if target_stage >= self.net.num_stages:
            return mb.data_node
        alive, crash = view.alive, view.crash
        busy, queues = view.busy, view.queues
        erow = view.edge_rows[frm]
        ct = view.bwd_t if mb.direction == "bwd" else view.fwd_t
        best, best_c = None, None
        for n in view.stage_nodes(target_stage):
            j = n.id
            if not (alive[j] and t < crash[j]):
                continue
            load_penalty = max(0, busy[j] + len(queues[j]) - n.capacity + 1)
            c = erow[j]
            c += load_penalty * ct[j]
            if best_c is None or c < best_c:
                best, best_c = j, c
        return best

    def recover(self, view: FaultView, mb, frm: int, dead: int,
                t: float) -> Decision:
        sub = self._reroute(view, mb, frm, _target_stage(self.net, dead), t)
        if sub is None:
            return ("fail",)               # DENY upstream: defer the batch
        delay = view.fwd_t[sub] if mb.direction == "bwd" else 0.0
        return ("substitute", sub, delay)

    def on_rejoin(self, node: Node) -> None:
        self.protocol.add_node(node)

    def on_crash(self, nid: int) -> None:
        self.protocol.remove_node(nid)


class SwarmPolicy:
    """SWARM baseline: greedy stochastic wiring, capacity-blind.

    Forward fault: timeout + resend to a different next-stage node.
    Backward fault: the whole pipeline for that microbatch restarts
    from the data node (the paper's key inefficiency claim).
    """
    name = "swarm"

    def __init__(self, net: FlowNetwork, *,
                 rng: Optional[np.random.Generator] = None):
        self.net = net
        self.router = SwarmRouter(net, stochastic=True, rng=rng)

    def plan(self) -> List[Sequence[int]]:
        paths: List[Sequence[int]] = []
        # one routing context for the whole wave: membership cannot
        # change while a plan is built, so the per-stage candidate
        # tables and the cost matrix are derived once, not per hop
        ctx = self.router.route_context()
        for dn in self.net.data_nodes():
            for _ in range(dn.capacity):
                path = self.router.route(dn.id, ctx=ctx)
                if path is not None:
                    paths.append(path)
        return paths

    def _reroute(self, view: FaultView, mb, frm: int, target_stage: int,
                 t: float, exclude: set) -> Optional[int]:
        if target_stage >= self.net.num_stages:
            return mb.data_node
        alive, crash = view.alive, view.crash
        crow = view.comm_rows[frm]
        # first strict minimum in stage order == np.argmin over the
        # candidate list (first occurrence wins) in the reference loop
        best, best_c = None, None
        for n in view.stage_nodes(target_stage):
            j = n.id
            if not (alive[j] and t < crash[j]) or j in exclude:
                continue
            c = crow[j]
            if best_c is None or c < best_c:
                best, best_c = j, c
        return best

    def recover(self, view: FaultView, mb, frm: int, dead: int,
                t: float) -> Decision:
        if mb.direction == "bwd":
            return ("restart", self.router.route(mb.data_node))
        sub = self._reroute(view, mb, frm, _target_stage(self.net, dead), t,
                            exclude={dead})
        return ("fail",) if sub is None else ("substitute", sub, 0.0)

    def on_rejoin(self, node: Node) -> None:
        pass

    def on_crash(self, nid: int) -> None:
        pass


class FixedPolicy:
    """Preset schedules (DT-FM optimal baseline, Table VI): the same
    paths every iteration, no rerouting — any timed-out leg fails the
    microbatch."""
    name = "fixed"

    def __init__(self, net: FlowNetwork, paths: Sequence[Sequence[int]]):
        self.net = net
        self.paths = [list(p) for p in (paths or [])]

    def plan(self) -> List[Sequence[int]]:
        return [list(p) for p in self.paths]

    def recover(self, view: FaultView, mb, frm: int, dead: int,
                t: float) -> Decision:
        return ("fail",)

    def on_rejoin(self, node: Node) -> None:
        pass

    def on_crash(self, nid: int) -> None:
        pass


def make_policy(scheduler: str, net: FlowNetwork, *,
                rng: Optional[np.random.Generator] = None,
                fixed_paths=None) -> RoutingPolicy:
    """The pre-refactor `scheduler=` string, resolved to a policy."""
    if scheduler == "gwtf":
        return GWTFPolicy(net, rng=rng)
    if scheduler == "swarm":
        return SwarmPolicy(net, rng=rng)
    if scheduler == "fixed":
        return FixedPolicy(net, fixed_paths or [])
    raise ValueError(f"unknown scheduler {scheduler!r} "
                     f"(expected 'gwtf' | 'swarm' | 'fixed')")
