"""Pre-refactor simulator loop, kept verbatim for benchmarking.

`ReferenceTrainingSimulator` is the monolithic ``TrainingSimulator``
exactly as it stood before the layered `repro.core.sim` engine replaced
it (hard-coded scheduler branches, per-event ``comm_cost`` /
``_compute_time`` method calls, string-typed heapq events, O(n^2)
aggregation loop) — including the SWARM backward-restart slot leak the
refactor fixed.  ``benchmarks/bench_sim.py`` runs it side by side with
the new event core to measure events/sec and to prove the GWTF path
metric-identical (same RNG stream, same float arithmetic).

The only changes from the pre-refactor file: `ModelProfile` /
`IterationMetrics` are imported from `repro.core.sim.metrics` instead
of being redefined, and the event loop stamps ``m.events`` /
``m.loop_seconds`` so events/sec is measured identically in both
implementations.  Do not "improve" this module — its value is being
frozen history.
"""
from __future__ import annotations

import heapq
import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.flow.decentralized import GWTFProtocol
from repro_torch.core.flow.graph import FlowNetwork, Node
from repro_torch.core.sim.metrics import IterationMetrics, ModelProfile
from repro_torch.core.swarm import SwarmRouter


@dataclass
class _MB:
    """One microbatch's lifecycle."""
    id: int
    data_node: int
    path: List[int]                   # planned chain (GWTF) / realised (SWARM)
    pos: int = 0                      # index into path
    direction: str = "fwd"
    compute_history: List[Tuple[int, float]] = field(default_factory=list)
    slots: set = field(default_factory=set)   # nodes holding memory for us
    leg: int = 0                  # increments on every send; stale events ignored
    retries: int = 0
    done: bool = False
    failed: bool = False


@dataclass
class _NodeState:
    busy: int = 0
    queue: deque = field(default_factory=deque)   # FIFO, O(1) popleft
    crash_time: Optional[float] = None     # this iteration


class ReferenceTrainingSimulator:
    def __init__(self, net: FlowNetwork, *, scheduler: str = "gwtf",
                 profile: Optional[ModelProfile] = None,
                 churn: float = 0.0, timeout: float = 30.0,
                 max_retries: int = 2, fixed_paths=None,
                 rng: Optional[np.random.Generator] = None):
        """scheduler: 'gwtf' | 'swarm' | 'fixed' (preset paths — used for
        the DT-FM optimal-schedule baseline of Table VI)."""
        self.net = net
        self.scheduler = scheduler
        self.profile = profile or ModelProfile(fwd_compute=2.0)
        self.churn = churn
        self.timeout = timeout
        self.max_retries = max_retries
        self.fixed_paths = fixed_paths or []
        self.rng = rng or np.random.default_rng(0)
        self._mb_ids = itertools.count()
        self.protocol: Optional[GWTFProtocol] = None
        self.router: Optional[SwarmRouter] = None
        if scheduler == "gwtf":
            self.protocol = GWTFProtocol(net, rng=self.rng)
            self.protocol.run(max_rounds=100)
        elif scheduler == "swarm":
            self.router = SwarmRouter(net, stochastic=True, rng=self.rng)

    # ------------------------------------------------------------------
    # Churn at iteration boundaries
    # ------------------------------------------------------------------
    def _apply_churn(self) -> Dict[int, float]:
        """Sample crashes (mid-iteration times) and rejoins; returns
        {node_id: crash_time}."""
        crash_times: Dict[int, float] = {}
        est = self._estimate_iteration()
        for n in list(self.net.nodes.values()):
            if n.is_data:
                continue
            if n.alive and self.rng.uniform() < self.churn:
                crash_times[n.id] = float(self.rng.uniform(0.0, est))
            elif not n.alive and self.rng.uniform() < self.churn:
                n.alive = True                     # rejoin, usable this iter
                if self.protocol is not None:
                    self.protocol.add_node(n)
        return crash_times

    def _estimate_iteration(self) -> float:
        S = self.net.num_stages
        costs = [n.compute_cost for n in self.net.alive_nodes() if not n.is_data]
        mean_c = float(np.mean(costs)) if costs else 1.0
        per_hop = mean_c * (1 + self.profile.bwd_mult)
        return max(60.0, S * (per_hop + 10.0))

    # ------------------------------------------------------------------
    def _comm(self, i: int, j: int) -> float:
        return self.net.comm_cost(i, j, self.profile.activation_bytes)

    def _compute_time(self, nid: int, direction: str) -> float:
        """Node.compute_cost is seconds per microbatch forward pass."""
        n = self.net.nodes[nid]
        base = max(0.05, n.compute_cost)
        return base * (self.profile.bwd_mult if direction == "bwd" else 1.0)

    def _alive_at(self, nid: int, t: float, crash_times: Dict[int, float]) -> bool:
        n = self.net.nodes.get(nid)
        if n is None or not n.alive:
            return False
        ct = crash_times.get(nid)
        return ct is None or t < ct

    # ------------------------------------------------------------------
    # Routing / recovery decisions
    # ------------------------------------------------------------------
    def _gwtf_reroute(self, mb: _MB, from_node: int, target_stage: int,
                      t: float, crash_times: Dict[int, float],
                      states: Dict[int, _NodeState]) -> Optional[int]:
        """Flow-algorithm reroute: cheapest alive next-stage node with
        spare capacity (the protocol's Request Flow applied at fault time)."""
        if target_stage >= self.net.num_stages:
            return mb.data_node
        best, best_c = None, None
        for n in self.net.stage_nodes(target_stage):
            if not self._alive_at(n.id, t, crash_times):
                continue
            st = states[n.id]
            load_penalty = max(0, st.busy + len(st.queue) - n.capacity + 1)
            c = self.net.edge_cost(from_node, n.id,
                                   self.profile.activation_bytes)
            c += load_penalty * self._compute_time(n.id, mb.direction)
            if best_c is None or c < best_c:
                best, best_c = n.id, c
        return best

    def _swarm_reroute(self, mb: _MB, from_node: int, target_stage: int,
                       t: float, crash_times: Dict[int, float],
                       exclude: set) -> Optional[int]:
        if target_stage >= self.net.num_stages:
            return mb.data_node
        cands = [n.id for n in self.net.stage_nodes(target_stage)
                 if self._alive_at(n.id, t, crash_times)
                 and n.id not in exclude]
        if not cands:
            return None
        costs = [self._comm(from_node, j) for j in cands]
        return int(cands[int(np.argmin(costs))])

    # ------------------------------------------------------------------
    # One training iteration
    # ------------------------------------------------------------------
    def run_iteration(self) -> IterationMetrics:
        m = IterationMetrics()
        crash_times = self._apply_churn()
        states: Dict[int, _NodeState] = {
            nid: _NodeState(crash_time=crash_times.get(nid))
            for nid in self.net.nodes}

        # ---- routing: build this iteration's paths --------------------
        mbs: List[_MB] = []
        if self.scheduler == "gwtf":
            # nodes already crashed (still dead from previous iterations)
            # were removed; re-run a few repair rounds (Sec. V-A runs in
            # parallel with training).
            self.protocol.reclaim_sink_slots()
            self.protocol.run(max_rounds=30, quiet_rounds=2)
            for chain in self.protocol.complete_flows():
                mbs.append(_MB(next(self._mb_ids), chain[0], list(chain)))
        elif self.scheduler == "fixed":
            for path in self.fixed_paths:
                mbs.append(_MB(next(self._mb_ids), path[0], list(path)))
        else:
            for dn in self.net.data_nodes():
                for _ in range(dn.capacity):
                    path = self.router.route(dn.id)
                    if path is not None:
                        mbs.append(_MB(next(self._mb_ids), dn.id, path))
        m.launched = len(mbs)

        # ---- event loop ------------------------------------------------
        # Memory semantics: a relay node's capacity counts *in-flight*
        # microbatches — the slot is held from forward arrival until the
        # backward pass completes at that node (activations must be kept
        # for the backward).  This is exactly why heterogeneous capacities
        # matter: SWARM routes capacity-blind and serialises on cap-1
        # nodes; GWTF's flows respect capacity by construction.
        seq = itertools.count()
        events: List = []

        def push(t, kind, mb, node, payload=None):
            heapq.heappush(events, (t, next(seq), kind, mb, node, payload))

        def send(mb: _MB, frm: int, to: int, t: float):
            mb.leg += 1
            c = self._comm(frm, to)
            m.comm_time += c
            push(t + c, "arrive", mb, to, (frm, mb.leg))
            # sender expects a COMPLETE within comm+compute+timeout; a slow
            # (overloaded) peer is indistinguishable from a dead one.
            expect = c + self._compute_time(to, mb.direction) + self.timeout
            push(t + expect, "check", mb, to, (frm, mb.leg))

        def release_slot(mb: _MB, nid: int, t: float):
            if nid not in mb.slots:
                return
            mb.slots.discard(nid)
            st = states[nid]
            st.busy -= 1
            while st.queue and self._alive_at(nid, t, crash_times):
                qmb, qleg = st.queue.popleft()
                if qmb.done or qmb.failed or qleg != qmb.leg:
                    continue                       # stale queue entry
                st.busy += 1
                qmb.slots.add(nid)
                push(t + self._compute_time(nid, qmb.direction),
                     "done", qmb, nid, qleg)
                break

        def fail(mb: _MB, t: float):
            mb.failed = True
            m.wasted_gpu += sum(c for _, c in mb.compute_history)
            for nid in list(mb.slots):
                release_slot(mb, nid, t)

        loop_t0 = time.perf_counter()
        for mb in mbs:
            nxt = mb.path[1]
            mb.pos = 1
            send(mb, mb.data_node, nxt, 0.0)

        end_time = 0.0
        max_events = 500_000
        while events and max_events > 0:
            max_events -= 1
            t, _, kind, mb, nid, payload = heapq.heappop(events)
            if mb.done or mb.failed:
                continue
            if kind == "arrive":
                frm, leg = payload
                if leg != mb.leg:
                    continue                       # rerouted while in flight
                if not self._alive_at(nid, t, crash_times):
                    continue                       # sender's check recovers
                if nid == mb.data_node:
                    if mb.direction == "fwd":
                        # loss computed at data node; turn around
                        mb.direction = "bwd"
                        mb.pos = len(mb.path) - 2
                        send(mb, mb.data_node, mb.path[mb.pos], t)
                    else:
                        mb.done = True
                        m.completed += 1
                        end_time = max(end_time, t)
                    continue
                st = states[nid]
                cap = self.net.nodes[nid].capacity
                if mb.direction == "bwd":
                    if nid not in mb.slots and st.busy < cap:
                        st.busy += 1
                        mb.slots.add(nid)
                    push(t + self._compute_time(nid, "bwd"),
                         "done", mb, nid, leg)
                elif nid in mb.slots:
                    push(t + self._compute_time(nid, "fwd"),
                         "done", mb, nid, leg)
                elif st.busy < cap:
                    st.busy += 1
                    mb.slots.add(nid)
                    push(t + self._compute_time(nid, "fwd"),
                         "done", mb, nid, leg)
                else:
                    st.queue.append((mb, leg))     # wait for a free slot
            elif kind == "done":
                leg = payload
                if leg is not None and leg != mb.leg:
                    # we were rerouted away while this node was computing:
                    # its work is wasted, its slot freed.
                    m.wasted_gpu += self._compute_time(nid, mb.direction)
                    release_slot(mb, nid, t)
                    continue
                if not self._alive_at(nid, t, crash_times):
                    # crashed mid-compute: work lost; sender's check recovers
                    m.wasted_gpu += self._compute_time(nid, mb.direction)
                    continue
                mb.compute_history.append(
                    (nid, self._compute_time(nid, mb.direction)))
                if mb.direction == "bwd":
                    release_slot(mb, nid, t)
                    mb.pos -= 1
                else:
                    mb.pos += 1
                nxt = (mb.data_node if (mb.pos <= 0 or mb.pos >= len(mb.path) - 1)
                       else mb.path[mb.pos])
                send(mb, nid, nxt, t)
                end_time = max(end_time, t)
            elif kind == "check":
                frm, leg = payload
                if leg != mb.leg:
                    continue                       # progressed past this leg
                # no COMPLETE for this leg: the receiver is dead OR too
                # slow (queued behind an over-committed node) — the sender
                # cannot tell the difference and reroutes either way.
                if not self._alive_at(nid, t, crash_times):
                    mb.slots.discard(nid)
                self._recover(mb, frm, nid, t, crash_times, states,
                              send, fail, m)
                end_time = max(end_time, t)
        m.loop_seconds = time.perf_counter() - loop_t0
        m.events = 500_000 - max_events

        for mb in mbs:
            if not mb.done and not mb.failed:
                mb.failed = True
                m.wasted_gpu += sum(c for _, c in mb.compute_history)

        # ---- aggregation phase (Sec. V-E) ------------------------------
        m.aggregation_time = self._aggregation_time(crash_times)
        m.duration = end_time + m.aggregation_time

        # ---- commit crashes for the next iteration ---------------------
        for nid in crash_times:
            self.net.kill_node(nid)
            if self.protocol is not None:
                self.protocol.remove_node(nid)
        return m

    # ------------------------------------------------------------------
    def _recover(self, mb: _MB, frm: int, dead: int, t: float,
                 crash_times, states, send, fail, m: IterationMetrics):
        """Sender `frm` noticed `dead` is unresponsive."""
        if mb.retries >= self.max_retries:
            fail(mb, t)
            return
        mb.retries += 1
        if self.scheduler == "fixed":
            fail(mb, t)                # preset schedules cannot reroute
            return
        dead_node = self.net.nodes[dead]
        target_stage = (dead_node.stage if not dead_node.is_data
                        else self.net.num_stages)
        if self.scheduler == "gwtf":
            sub = self._gwtf_reroute(mb, frm, target_stage, t, crash_times,
                                     states)
            if sub is None:
                fail(mb, t)                 # DENY upstream: defer the batch
                return
            if mb.direction == "bwd":
                # pipeline repair (Sec. V-D): the substitute recomputes
                # ONLY this stage's forward from the stored upstream
                # activation, then the backward resumes from the stored
                # gradient — no full-pipeline recompute.
                mb.path[mb.pos] = sub
                recompute = self._compute_time(sub, "fwd")
                send(mb, frm, sub, t + recompute)
            else:
                mb.path[mb.pos] = sub
                send(mb, frm, sub, t)
        else:
            if mb.direction == "bwd":
                # SWARM: full pipeline recomputation from the data node
                m.wasted_gpu += sum(c for _, c in mb.compute_history)
                mb.compute_history.clear()
                for nid2 in list(mb.slots):
                    # slots released while the pipeline restarts
                    st = states[nid2]
                    st.busy -= 1
                    mb.slots.discard(nid2)
                path = self.router.route(mb.data_node)
                if path is None:
                    fail(mb, t)
                    return
                mb.path = path
                mb.direction = "fwd"
                mb.pos = 1
                send(mb, mb.data_node, path[1], t)
            else:
                sub = self._swarm_reroute(mb, frm, target_stage, t,
                                          crash_times, exclude={dead})
                if sub is None:
                    fail(mb, t)
                    return
                mb.path[mb.pos] = sub
                send(mb, frm, sub, t)

    # ------------------------------------------------------------------
    def _aggregation_time(self, crash_times) -> float:
        """BEGIN-AGGREGATION wave + intra-stage weight exchange + CAN-TAKE."""
        total_wave = 0.0
        agg = 0.0
        for s in range(self.net.num_stages):
            nodes = [n for n in self.net.stage_nodes(s)
                     if crash_times.get(n.id) is None]
            if len(nodes) < 2:
                continue
            worst = 0.0
            for a in nodes:
                for b in nodes:
                    if a.id == b.id:
                        continue
                    worst = max(worst, self.net.comm_cost(
                        a.id, b.id, self.profile.stage_param_bytes))
            agg = max(agg, worst)
            total_wave += 0.05          # BEGIN AGG / CAN TAKE hop latency
        return agg + 2 * total_wave

    # ------------------------------------------------------------------
    def run(self, iterations: int) -> List[IterationMetrics]:
        return [self.run_iteration() for _ in range(iterations)]
