"""Event core of the layered simulation engine (paper Sec. VI).

`SimulationEngine` runs the discrete-event clock that times one
training iteration: per-node compute slots (capacity) with FIFO
queueing, per-link transfer delays, mid-iteration crashes, and
timeout-based fault discovery.  Routing and recovery decisions are
delegated to a `RoutingPolicy` (scheduler layer) and crash/rejoin
sampling to a `ChurnModel` (fault layer), so the core contains no
scheduler- or fault-specific branches.

Design of the fast core
-----------------------
* **Typed event records.**  Events are flat 7-tuples
  ``(time, seq, kind, mb, node, leg, frm)`` with integer kinds
  (ARRIVE/DONE/CHECK) — no nested payload tuples, no string dispatch.
  ``seq`` is a global monotonic counter so simultaneous events pop in
  push order (deterministic FIFO tie-break).
* **Two-level batched calendar.**  The calendar is split into a small
  ``near`` binary heap (every pending event with time ≤ a moving
  boundary ``B``) and an unsorted ``far`` list (everything later).
  Pushes compare once against ``B`` and either ``heappush`` into
  ``near`` or plain-``append`` to ``far``; when ``near`` drains, one
  bulk ``far.sort()`` (Timsort in C over the ``(time, seq, ...)``
  records) promotes the next batch — at least 256 events, half of
  ``far`` when larger, always extended across time ties so ``far``
  holds strictly-later events only.  A sorted ascending run is already
  a valid min-heap, so promotion is a slice, and every ``heappush`` /
  ``heappop`` works a heap of batch size instead of total calendar
  residency — that breaks the ~µs/event floor a single monolithic heap
  hits past ~10k concurrent microbatches (log-factor tuple compares
  per operation), while bulk Timsort amortizes ordering at
  O(log batch) compares per event.  Pop order is *provably identical*
  to the single heap: ``far`` only ever holds events strictly later
  than everything in ``near``, and ``(time, seq)`` is a unique total
  order (so sorting never compares the payload fields).  (A bucketed
  calendar queue was measured slower here: its per-event bucket scan
  runs in bytecode, while the sort/heap primitives run in C.)
* **Lazy timeout records.**  The pre-refactor loop pushed one CHECK
  event per send; in a healthy iteration every one of them pops stale.
  A timeout can only ever *fire* if the microbatch actually stalled,
  and the loop observes every stall directly: an arrival dropped at a
  dead receiver, a compute lost to a mid-compute crash, or a
  capacity-wait enqueue.  The core therefore materializes the CHECK
  record (with the deadline computed at send time, so fire times are
  bit-identical) only at those three points.  This removes a third of
  all calendar traffic and keeps the calendar an order of magnitude
  smaller — long-deadline timeout records no longer dominate its
  residency.  Caveat: on calendars with *exactly* tying float
  timestamps (e.g. all-integer link costs) a fired timeout may
  tie-break differently against a simultaneous arrival than the
  reference loop; on the continuous geo topologies used by the tests
  and benchmarks, seeded runs are metric- and RNG-identical.
* **Batched cost lookups.**  All per-event cost queries are resolved
  against per-iteration tables derived from ``FlowNetwork``'s cached
  Eq. 1 matrices: the dense communication and edge-cost matrices
  (``FlowNetwork.comm_matrix`` / ``edge_matrix`` at the profile's
  activation size, lowered to nested Python lists so the hot loop and
  the fault path do plain float indexing) and per-node
  forward/backward compute-time vectors.  The pre-refactor loop
  resolved every one of these through two or three method calls per
  event.
* **Per-iteration event accounting.**  The loop counts calendar pops,
  capacity-wait enqueues, peak queue depth, reroutes, and its own wall
  time into `IterationMetrics` (``events``, ``events_per_sec``), which
  is what ``benchmarks/bench_sim.py`` measures against the
  pre-refactor loop kept in `repro.core.sim.reference`.

Semantics are identical to the pre-refactor ``TrainingSimulator``
(same RNG stream, same float arithmetic, same tie-breaking) with two
deliberate, documented exceptions:

* the SWARM backward-restart slot leak is fixed — restarting
  microbatches release their slots through ``release_slot`` so queued
  microbatches behind them wake immediately instead of stalling until
  their sender's timeout;
* ``max_events`` exhaustion is surfaced (``IterationMetrics.truncated``
  + a ``RuntimeWarning``) instead of silently reporting a short, clean
  iteration.

Planning-overrun guard: when ``policy.plan()`` wall time exceeds the
event-loop wall time by ``plan_overrun_factor`` (and is long enough in
absolute terms to matter — ``plan_overrun_min_seconds``), the engine
warns, flags the iteration (``IterationMetrics.plan_overrun``), and
asks the policy to cap its planning effort via an optional
``throttle_planning()`` hook — a planner regression now surfaces in CI
profiles instead of silently turning the simulator superlinear.
"""
from __future__ import annotations

import heapq
import itertools
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.flow.graph import FlowNetwork
from repro_torch.core.sim.faults import (BernoulliChurn, ChurnContext, ChurnModel,
                                   adversarial_plan)
from repro_torch.core.sim.metrics import (IterationMetrics, ModelProfile,
                                    RequestMetrics, ServingIterationMetrics)
from repro_torch.core.sim.policies import FaultView, RoutingPolicy
from repro_torch.core.sim.timeline import FaultTimeline, record_injections

# Typed event kinds (ints: cheap compares, no string dispatch)
ARRIVE, DONE, CHECK = 0, 1, 2

# two-level calendar: minimum promotion batch (events) pulled from the
# far list each time the near heap drains
_PROMOTE_MIN = 256


@dataclass(slots=True)
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
    # current leg's timeout deadline + sender, stamped by send() so a
    # lazily-materialized CHECK record is bit-identical to an eager one
    deadline: float = 0.0
    sent_from: int = -1
    # node whose capacity-wait queue currently holds us (-1 = none);
    # lets the queue-depth gauge drop entries that leave the waiting
    # state sideways (rerouted away, failed, stranded at a crashed
    # node) instead of only when their queue entry is popped
    wait_node: int = -1
    # adversarial per-leg markers: the leg whose delivery was dropped
    # by a flaky link / whose receiver is a deadline-catchable
    # straggler (-1 = none).  Lets the CHECK handler attribute the
    # fired deadline to its cause without payload-tuple changes.
    dropped_leg: int = -1
    slow_leg: int = -1


class SimulationEngine:
    """The event core: policy + churn model + profile -> timed iterations.

    Memory semantics: a relay node's capacity counts *in-flight*
    microbatches — the slot is held from forward arrival until the
    backward pass completes at that node (activations must be kept for
    the backward).  This is exactly why heterogeneous capacities
    matter: SWARM routes capacity-blind and serialises on cap-1 nodes;
    GWTF's flows respect capacity by construction.
    """

    def __init__(self, net: FlowNetwork, policy: RoutingPolicy, *,
                 churn_model: Optional[ChurnModel] = None,
                 profile: Optional[ModelProfile] = None,
                 timeout: float = 30.0, max_retries: int = 2,
                 rng: Optional[np.random.Generator] = None,
                 max_events: int = 500_000,
                 plan_overrun_factor: float = 100.0,
                 plan_overrun_min_seconds: float = 0.5,
                 deadline_defense: bool = True,
                 corrupt_screen: bool = True):
        self.net = net
        self.policy = policy
        self.churn_model = churn_model or BernoulliChurn(0.0)
        self.profile = profile or ModelProfile(fwd_compute=2.0)
        self.timeout = timeout
        self.max_retries = max_retries
        # adversarial defenses: deadline-triggered re-dispatch for
        # hung/straggling/dropped legs, and the (modelled) gradient
        # screen for corrupt contributions.  Both are inert unless the
        # churn model publishes an AdversarialPlan.
        self.deadline_defense = deadline_defense
        self.corrupt_screen = corrupt_screen
        self.timeline = FaultTimeline()
        self.rng = rng or np.random.default_rng(0)
        self.max_events = max_events
        self.plan_overrun_factor = plan_overrun_factor
        self.plan_overrun_min_seconds = plan_overrun_min_seconds
        self._mb_ids = itertools.count()
        self._iteration = 0
        self._tables_key = None          # (cost_version, size, N)
        self._comm_rows: List[List[float]] = []
        self._edge_rows: List[List[float]] = []
        self._codec_names: Tuple[str, ...] = ("fp32",)
        self._codec_rows: Optional[List[List[int]]] = None
        self._legbytes_rows: Optional[List[List[float]]] = None
        self._node_tables_key = None     # (cost_version, N)
        self._fwd_t: List[float] = []
        self._bwd_t: List[float] = []
        self._caps: List[int] = []

    # ------------------------------------------------------------------
    # Batched per-iteration cost tables
    # ------------------------------------------------------------------
    def _cost_tables(self, n_nodes: int) -> Tuple[List[List[float]],
                                                  List[List[float]]]:
        """Dense comm-only and full-edge Eq. 1 matrices at the profile's
        activation size, lowered to nested lists (plain-float reads in
        the hot loop and the fault path).  Rebuilt only when the
        network's cost epoch moves.

        With a non-trivial wire-codec menu the matrices are already
        codec-priced (encoded bytes + encode/decode delay baked into
        each entry by ``FlowNetwork``); this also lowers the per-link
        chosen-codec indices and encoded-bytes-per-leg tables the event
        loop charges ``bytes_on_wire`` / ``codec_legs`` against."""
        key = (self.net.cost_version, self.profile.activation_bytes, n_nodes)
        if key != self._tables_key:
            size = self.profile.activation_bytes
            self._comm_rows = self.net.comm_matrix(size)[
                :n_nodes, :n_nodes].tolist()
            self._edge_rows = self.net.edge_matrix(size)[
                :n_nodes, :n_nodes].tolist()
            names = self.net.wire_codec_names()
            self._codec_names = names
            if len(names) > 1:
                choice = self.net.wire_codec_matrix(size)[:n_nodes, :n_nodes]
                ratios = self.net.wire_codec_ratios()
                self._codec_rows = choice.tolist()
                self._legbytes_rows = (ratios[choice] * float(size)).tolist()
            else:
                self._codec_rows = None
                self._legbytes_rows = None
            self._tables_key = key
        return self._comm_rows, self._edge_rows

    def _estimate_iteration(self) -> float:
        S = self.net.num_stages
        costs = [n.compute_cost for n in self.net.alive_nodes() if not n.is_data]
        mean_c = float(np.mean(costs)) if costs else 1.0
        per_hop = mean_c * (1 + self.profile.bwd_mult)
        return max(60.0, S * (per_hop + 10.0))

    # ------------------------------------------------------------------
    # One training iteration
    # ------------------------------------------------------------------
    def run_iteration(self) -> IterationMetrics:
        net = self.net
        m = IterationMetrics()

        # ---- fault layer: sample crashes/rejoins ----------------------
        it = self._iteration
        crash_times = self.churn_model.sample(ChurnContext(
            net=net, rng=self.rng, horizon=self._estimate_iteration(),
            iteration=it, on_rejoin=self.policy.on_rejoin))
        self._iteration += 1
        # adversarial side channel (None for plain fail-stop models —
        # every branch it gates below is then skipped, keeping the
        # fail-stop event stream bit-identical to the reference loop)
        adv = adversarial_plan(self.churn_model, it)
        record_injections(self.timeline, it, crash_times, adv)
        slow = adv.slow if adv is not None else {}
        hung = adv.hung if adv is not None else frozenset()
        corrupt = adv.corrupt if adv is not None else {}
        flaky = adv is not None and bool(adv.flaky)
        deadline_defense = self.deadline_defense

        # ---- scheduler layer: build this iteration's paths ------------
        plan_t0 = time.perf_counter()
        mbs = [_MB(next(self._mb_ids), path[0], list(path))
               for path in self.policy.plan()]
        m.plan_seconds = time.perf_counter() - plan_t0
        m.launched = len(mbs)
        m.cost_ratio_vs_optimal = getattr(self.policy,
                                          "last_cost_ratio", None)

        # ---- batched cost tables (resolved against the Eq. 1 caches) --
        N = (max(net.nodes) + 1) if net.nodes else 0
        comm, edge = self._cost_tables(N)
        # node-attribute tables: compute times and capacities move only
        # with the cost epoch / membership size, so they are part of the
        # reusable planning context; liveness is per-iteration state
        nt_key = (net.cost_version, N)
        if nt_key != self._node_tables_key:
            fwd_t = [0.05] * N
            caps = [0] * N
            for nid, node in net.nodes.items():
                fwd_t[nid] = max(0.05, node.compute_cost)
                caps[nid] = node.capacity
            bwd_mult = self.profile.bwd_mult
            self._fwd_t = fwd_t
            self._bwd_t = [c * bwd_mult for c in fwd_t]
            self._caps = caps
            self._node_tables_key = nt_key
        fwd_t, bwd_t, caps = self._fwd_t, self._bwd_t, self._caps
        # effective compute times under straggler slowdowns; deadlines
        # keep being stamped from the *healthy* tables (fwd_t/bwd_t in
        # send()), which is exactly what lets the deadline catch a
        # pathological slowdown
        if slow:
            eff_fwd, eff_bwd = list(fwd_t), list(bwd_t)
            for s_nid, s_f in slow.items():
                if s_nid < N:
                    eff_fwd[s_nid] *= s_f
                    eff_bwd[s_nid] *= s_f
        else:
            eff_fwd, eff_bwd = fwd_t, bwd_t
        alive = [False] * N
        for nid, node in net.nodes.items():
            alive[nid] = node.alive
        INF = float("inf")
        crash = [INF] * N
        for nid, ct in crash_times.items():
            crash[nid] = ct

        # ---- per-iteration node state ---------------------------------
        busy = [0] * N
        queues = [deque() for _ in range(N)]   # capacity-wait FIFOs

        view = FaultView()
        view.net = net
        view.activation_bytes = self.profile.activation_bytes
        # hung nodes (and stragglers slow enough that the deadline is
        # guaranteed to fire on any forward leg) are alive but useless
        # this iteration: mark them crashed-at-0 in the *policy's* view
        # (not the engine's own liveness tables) so recovery never
        # substitutes a microbatch onto one.  The runtime's
        # RecoveryManager applies the same predicate to its view.
        blocked = set(hung)
        for s_nid, s_f in slow.items():
            if s_nid < N and fwd_t[s_nid] * (s_f - 1.0) > self.timeout:
                blocked.add(s_nid)
        if blocked:
            vcrash = list(crash)
            for b_nid in blocked:
                if b_nid < N:
                    vcrash[b_nid] = 0.0
            view.alive, view.crash = alive, vcrash
        else:
            view.alive, view.crash = alive, crash
        view.busy, view.queues = busy, queues
        view.fwd_t, view.bwd_t = fwd_t, bwd_t
        view.comm_rows, view.edge_rows = comm, edge
        _stage_cache: Dict[int, list] = {}

        def stage_nodes(s: int) -> list:
            nodes = _stage_cache.get(s)
            if nodes is None:
                nodes = net.stage_nodes(s)     # membership frozen mid-loop
                _stage_cache[s] = nodes
            return nodes

        view.stage_nodes = stage_nodes

        # ---- event calendar (two-level: near heap + far list) ---------
        near: List[tuple] = []        # heap: every pending event t <= boundary
        far: List[tuple] = []         # unsorted: every pending event t > boundary
        boundary = float("-inf")      # initial launches bulk-sort on first pop
        heappush, heappop = heapq.heappush, heapq.heappop
        far_append = far.append
        seq = itertools.count()
        timeout = self.timeout
        comm_total = 0.0
        qdepth = 0
        sends = 0
        timeouts_ctr = 0
        retries_ctr = 0
        rep_reports: List[int] = []       # detection-attributed nodes
        wire_bytes = 0.0
        codec_rows, legb = self._codec_rows, self._legbytes_rows
        codec_hist = [0] * len(self._codec_names)

        def push(ev: tuple):
            if ev[0] <= boundary:
                heappush(near, ev)
            else:
                far_append(ev)

        def send(mb: _MB, frm: int, to: int, t: float):
            nonlocal comm_total, sends, wire_bytes
            mb.leg += 1
            c = comm[frm][to]
            comm_total += c
            sends += 1
            if legb is not None:
                # leg priced at the link's chosen codec: encoded bytes
                # on the wire, encode/decode delay already inside c
                wire_bytes += legb[frm][to]
                codec_hist[codec_rows[frm][to]] += 1
            # sender expects a COMPLETE within comm+compute+timeout; a slow
            # (overloaded) peer is indistinguishable from a dead one.  The
            # CHECK record itself is materialized lazily, at the stall.
            expect = c + (bwd_t[to] if mb.direction == "bwd"
                          else fwd_t[to]) + timeout
            mb.deadline = t + expect
            mb.sent_from = frm
            if (flaky and to != mb.data_node
                    and not adv.leg_ok(it, mb.id, mb.direction, mb.pos,
                                       mb.retries)):
                # delivery dropped on the wire (bytes were still spent):
                # the receiver never sees the ARRIVE, so the stall point
                # is known immediately — materialize the CHECK now
                mb.dropped_leg = mb.leg
                push((mb.deadline, next(seq), CHECK, mb, to, mb.leg, frm))
                return
            push((t + c, next(seq), ARRIVE, mb, to, mb.leg, frm))

        def release_slot(mb: _MB, nid: int, t: float):
            nonlocal qdepth
            if nid not in mb.slots:
                return
            mb.slots.discard(nid)
            busy[nid] -= 1
            q = queues[nid]
            while q and alive[nid] and t < crash[nid]:
                qmb, qleg = q.popleft()
                if qmb.done or qmb.failed or qleg != qmb.leg:
                    continue                       # stale queue entry
                qdepth -= 1
                qmb.wait_node = -1
                busy[nid] += 1
                qmb.slots.add(nid)
                push((t + (eff_bwd[nid] if qmb.direction == "bwd"
                           else eff_fwd[nid]),
                      next(seq), DONE, qmb, nid, qleg, -1))
                break

        def fail(mb: _MB, t: float):
            mb.failed = True
            m.wasted_gpu += sum(c for _, c in mb.compute_history)
            for nid in list(mb.slots):
                release_slot(mb, nid, t)

        def recover(mb: _MB, frm: int, dead: int, t: float):
            """Sender `frm` noticed `dead` is unresponsive."""
            nonlocal qdepth, retries_ctr
            if mb.wait_node >= 0:
                # leaving the waiting state sideways: the queue entry
                # goes stale (popped-and-skipped later, or stranded at a
                # crashed node) — drop it from the depth gauge now
                qdepth -= 1
                mb.wait_node = -1
            if mb.retries >= self.max_retries:
                fail(mb, t)
                return
            mb.retries += 1
            retries_ctr += 1
            decision = self.policy.recover(view, mb, frm, dead, t)
            kind = decision[0]
            if kind == "substitute":
                sub, delay = decision[1], decision[2]
                m.reroutes += 1
                mb.path[mb.pos] = sub
                send(mb, frm, sub, t + delay)
            elif kind == "restart":
                # full pipeline recomputation from the data node: all
                # forward work so far is wasted and every held slot is
                # released (through release_slot, so microbatches queued
                # behind this one wake up instead of waiting out their
                # sender's timeout — the pre-refactor loop leaked these
                # slots by decrementing busy directly).
                m.wasted_gpu += sum(c for _, c in mb.compute_history)
                mb.compute_history.clear()
                for nid2 in list(mb.slots):
                    release_slot(mb, nid2, t)
                path = decision[1]
                if path is None:
                    fail(mb, t)
                    return
                m.reroutes += 1
                mb.path = list(path)
                mb.direction = "fwd"
                mb.pos = 1
                send(mb, mb.data_node, mb.path[1], t)
            else:
                fail(mb, t)

        # ---- event loop -----------------------------------------------
        loop_t0 = time.perf_counter()
        for mb in mbs:
            mb.pos = 1
            send(mb, mb.data_node, mb.path[1], 0.0)

        end_time = 0.0
        completed = 0
        pops = 0
        max_events = self.max_events
        qdepth_peak = 0
        enqueues = 0
        while pops < max_events:
            if near:
                ev = heappop(near)
            elif far:
                # promotion: one bulk Timsort, then slice off the next
                # batch.  (time, seq) is unique, so the sort never
                # compares payload fields; the ascending run is already
                # a valid min-heap.  Extending across time ties keeps
                # the invariant that far holds strictly-later events.
                far.sort()
                nf = len(far)
                k = nf if nf <= _PROMOTE_MIN else max(_PROMOTE_MIN, nf >> 1)
                while k < nf and far[k][0] == far[k - 1][0]:
                    k += 1
                near.extend(far[:k])
                del far[:k]
                boundary = near[-1][0]
                ev = heappop(near)
            else:
                break
            pops += 1
            t, _, kind, mb, nid, leg, frm = ev
            if mb.done or mb.failed:
                continue
            if kind == ARRIVE:
                if leg != mb.leg:
                    continue                       # rerouted while in flight
                if not (alive[nid] and t < crash[nid]):
                    # dead receiver: the mb stalls until the sender's
                    # timeout — materialize the CHECK record now
                    push((mb.deadline, next(seq), CHECK, mb, nid, leg, frm))
                    continue
                if nid == mb.data_node:
                    if mb.direction == "fwd":
                        # loss computed at data node; turn around
                        mb.direction = "bwd"
                        mb.pos = len(mb.path) - 2
                        send(mb, mb.data_node, mb.path[mb.pos], t)
                    else:
                        mb.done = True
                        completed += 1
                        if t > end_time:
                            end_time = t
                    continue
                if nid in hung:
                    # hung relay: accepts the microbatch (and holds its
                    # memory slot — queued work behind it wedges, which
                    # is the cascade an undefended swarm suffers) but
                    # never completes it; only the deadline catches it
                    if nid not in mb.slots and busy[nid] < caps[nid]:
                        busy[nid] += 1
                        mb.slots.add(nid)
                    push((mb.deadline, next(seq), CHECK, mb, nid, leg, frm))
                    continue
                done_at = -1.0
                if mb.direction == "bwd":
                    if nid not in mb.slots and busy[nid] < caps[nid]:
                        busy[nid] += 1
                        mb.slots.add(nid)
                    done_at = t + eff_bwd[nid]
                    push((done_at, next(seq), DONE, mb, nid, leg, -1))
                elif nid in mb.slots:
                    done_at = t + eff_fwd[nid]
                    push((done_at, next(seq), DONE, mb, nid, leg, -1))
                elif busy[nid] < caps[nid]:
                    busy[nid] += 1
                    mb.slots.add(nid)
                    done_at = t + eff_fwd[nid]
                    push((done_at, next(seq), DONE, mb, nid, leg, -1))
                else:
                    # wait for a free slot; may outlive the sender's
                    # patience — materialize the CHECK record
                    queues[nid].append((mb, leg))
                    mb.wait_node = nid
                    push((mb.deadline, next(seq), CHECK, mb, nid, leg, frm))
                    enqueues += 1
                    qdepth += 1
                    if qdepth > qdepth_peak:
                        qdepth_peak = qdepth
                if (done_at >= 0.0 and deadline_defense and nid in slow
                        and done_at > mb.deadline):
                    # deadline-catchable straggler: hedge by
                    # materializing the CHECK at the (healthy-estimate)
                    # deadline; the re-dispatch fires there and the
                    # straggling DONE later pops stale (work wasted)
                    mb.slow_leg = leg
                    push((mb.deadline, next(seq), CHECK, mb, nid, leg, frm))
            elif kind == DONE:
                if leg != mb.leg:
                    # we were rerouted away while this node was computing:
                    # its work is wasted, its slot freed.  The waste is
                    # charged at the mb's *current* direction, which can
                    # differ from the direction this node computed in if
                    # the mb turned around before the stale DONE popped —
                    # inherited verbatim from the pre-refactor loop; a fix
                    # must change reference.py in lockstep or the CI
                    # bit-equivalence gate breaks.
                    m.wasted_gpu += (eff_bwd[nid] if mb.direction == "bwd"
                                     else eff_fwd[nid])
                    release_slot(mb, nid, t)
                    continue
                if not (alive[nid] and t < crash[nid]):
                    # crashed mid-compute: work lost; the sender's
                    # timeout recovers — materialize the CHECK record
                    m.wasted_gpu += (eff_bwd[nid] if mb.direction == "bwd"
                                     else eff_fwd[nid])
                    push((mb.deadline, next(seq), CHECK,
                          mb, nid, leg, mb.sent_from))
                    continue
                if mb.direction == "bwd":
                    mb.compute_history.append((nid, eff_bwd[nid]))
                    release_slot(mb, nid, t)
                    mb.pos -= 1
                else:
                    mb.compute_history.append((nid, eff_fwd[nid]))
                    mb.pos += 1
                pos = mb.pos
                nxt = (mb.data_node if (pos <= 0 or pos >= len(mb.path) - 1)
                       else mb.path[pos])
                send(mb, nid, nxt, t)
                if t > end_time:
                    end_time = t
            else:                                  # CHECK
                if leg != mb.leg:
                    continue                       # progressed past this leg
                # no COMPLETE for this leg: the receiver is dead OR too
                # slow (queued behind an over-committed node) — the sender
                # cannot tell the difference and reroutes either way.
                timeouts_ctr += 1
                dead_recv = not (alive[nid] and t < crash[nid])
                if dead_recv:
                    mb.slots.discard(nid)
                elif nid in hung or mb.slow_leg == leg or \
                        mb.dropped_leg == leg:
                    # adversarial stall on an alive receiver
                    if not deadline_defense:
                        continue          # undefended: the mb is stuck
                    if nid in hung or mb.slow_leg == leg:
                        mb.slow_leg = -1
                        self.timeline.record(it, "straggler",
                                             "detection", nid)
                        rep_reports.append(nid)
                        if nid in hung and nid in mb.slots:
                            # free the wedged slot without waking the
                            # queue — anything queued at a hung node
                            # must deadline out on its own
                            mb.slots.discard(nid)
                            busy[nid] -= 1
                        recover(mb, frm, nid, t)
                        if not mb.failed:
                            self.timeline.record(it, "straggler",
                                                 "repair", nid)
                        if t > end_time:
                            end_time = t
                        continue
                    # dropped delivery: bounded retry with linear
                    # backoff on the same leg before rerouting
                    mb.dropped_leg = -1
                    self.timeline.record(it, "flaky_link",
                                         "detection", nid)
                    if mb.retries < self.max_retries:
                        mb.retries += 1
                        retries_ctr += 1
                        send(mb, frm, nid, t + 0.5 * mb.retries)
                        if mb.dropped_leg != mb.leg:
                            self.timeline.record(it, "flaky_link",
                                                 "repair", nid)
                        if t > end_time:
                            end_time = t
                        continue
                recover(mb, frm, nid, t)
                if t > end_time:
                    end_time = t
        m.loop_seconds = time.perf_counter() - loop_t0
        m.events = pops
        m.completed = completed
        m.comm_time = comm_total
        m.queue_depth_peak = qdepth_peak
        m.queue_enqueues = enqueues
        m.timeouts = timeouts_ctr
        m.retries = retries_ctr
        if legb is not None:
            m.bytes_on_wire = wire_bytes
            m.codec_legs = {self._codec_names[k]: codec_hist[k]
                            for k in range(len(codec_hist)) if codec_hist[k]}
        else:
            m.bytes_on_wire = sends * self.profile.activation_bytes

        # ---- planning-overrun guard (warn-and-cap) ---------------------
        # the optimality oracle (GWTFPolicy track_optimality) is a
        # diagnostic riding inside plan(); its wall time must not trip
        # the throttle and change planning behavior under profiling
        plan_core = m.plan_seconds - getattr(self.policy,
                                             "last_oracle_seconds", 0.0)
        factor = self.plan_overrun_factor
        if (factor is not None
                and plan_core > self.plan_overrun_min_seconds
                and plan_core > factor * m.loop_seconds):
            m.plan_overrun = True
            throttle = getattr(self.policy, "throttle_planning", None)
            capped = throttle() if throttle is not None else None
            warnings.warn(
                f"planning overran the event loop: plan_seconds="
                f"{plan_core:.3f} > {factor:g} x loop_seconds="
                f"{m.loop_seconds:.3f}"
                + (f"; policy planning effort capped to {capped}"
                   if capped is not None else
                   "; policy has no throttle_planning() hook"),
                RuntimeWarning, stacklevel=2)

        if (near or far) and pops >= max_events:
            m.truncated = True
            warnings.warn(
                f"simulation iteration truncated: max_events={max_events} "
                f"exhausted with {len(near) + len(far)} events pending "
                f"({completed}/{m.launched} microbatches complete); "
                f"reported duration is a lower bound",
                RuntimeWarning, stacklevel=2)

        for mb in mbs:
            if not mb.done and not mb.failed:
                mb.failed = True
                m.wasted_gpu += sum(c for _, c in mb.compute_history)

        # ---- modelled gradient screen (corrupt contributions) ----------
        # the simulator carries no gradients; it models the runtime's
        # norm/cosine screen as catching every completed contribution
        # whose (final, post-reroute) chain crossed a corrupt node — the
        # harness' detection precision/recall check pins the runtime
        # screen to exactly this on deterministic programs
        if corrupt and self.corrupt_screen:
            cset = frozenset(corrupt)
            for mb in mbs:
                if not mb.done:
                    continue
                for c_nid in sorted(cset.intersection(mb.path)):
                    self.timeline.record(it, "corrupt_gradient",
                                         "detection", c_nid)
                    self.timeline.record(it, "corrupt_gradient",
                                         "repair", c_nid)
                    rep_reports.append(c_nid)

        # ---- aggregation phase (Sec. V-E) ------------------------------
        m.aggregation_time = self._aggregation_time(crash_times)
        m.duration = end_time + m.aggregation_time

        # ---- commit crashes for the next iteration ---------------------
        for nid in crash_times:
            net.kill_node(nid)
            self.policy.on_crash(nid)

        # ---- reputation: decay first (rehabilitation), then charge this
        # iteration's detections, so the next plan prices fresh faults at
        # full strength.  Both are exact no-ops on an all-1.0 network.
        if rep_reports or net.reputation_active():
            net.decay_reputations()
            for r_nid in rep_reports:
                net.report_fault(r_nid)
        return m

    # ------------------------------------------------------------------
    def _aggregation_time(self, crash_times: Dict[int, float]) -> float:
        """BEGIN-AGGREGATION wave + intra-stage weight exchange + CAN-TAKE.

        The worst pairwise weight-exchange cost per stage is the max
        over the off-diagonal of the stage's slice of the cached comm
        matrix — elementwise identical to the pre-refactor O(n^2)
        per-pair ``comm_cost`` loop, but one NumPy reduction per stage.
        """
        total_wave = 0.0
        agg = 0.0
        M = None
        for s in range(self.net.num_stages):
            ids = [n.id for n in self.net.stage_nodes(s)
                   if crash_times.get(n.id) is None]
            k = len(ids)
            if k < 2:
                continue
            if M is None:
                M = self.net.comm_matrix(self.profile.stage_param_bytes)
            sub = M[np.ix_(ids, ids)]
            worst = float(sub[~np.eye(k, dtype=bool)].max())
            agg = max(agg, worst)
            total_wave += 0.05          # BEGIN AGG / CAN TAKE hop latency
        return agg + 2 * total_wave

    # ------------------------------------------------------------------
    def run(self, iterations: int) -> List[IterationMetrics]:
        return [self.run_iteration() for _ in range(iterations)]


# ---------------------------------------------------------------------------
# Serving plane: decode requests routed as flow units over the stage graph
# ---------------------------------------------------------------------------

# serving event kinds (same tie-break discipline as the training core:
# completions at exactly a crash instant beat the crash)
_S_ARRIVE, _S_DONE, _S_CRASH = 0, 1, 2


@dataclass(slots=True)
class _Req:
    """One decode request's scheduling state (analytic segments).

    A *segment* is a crash-free run of decoding on one chain: token
    ``k0 + j`` lands at ``seg_t0 + j * step`` (``k0`` tokens are in
    hand at ``seg_t0``).  A fresh segment has ``pre = 0, k0 = 1,
    seg_t0 = first-token time``; a post-requeue segment resumes with
    the ``k0`` tokens that survived the migration.  ``epoch``
    invalidates stale completion events after a reschedule.
    """
    rid: int
    rec: RequestMetrics
    chain: Optional[Tuple[int, ...]] = None   # (dn, s0..s_{S-1}, dn)
    epoch: int = 0
    pre: int = 0                  # tokens in hand before seg_t0
    k0: int = 0                   # tokens in hand at seg_t0
    seg_t0: float = 0.0
    step: float = 0.0
    t_complete: float = float("inf")
    done: bool = False
    dropped: bool = False

    def tokens_at(self, t: float, gen: int) -> int:
        if self.chain is None:
            return self.pre
        if t < self.seg_t0:
            return self.pre
        if self.step <= 0.0:
            return gen
        return min(gen, self.k0 + int((t - self.seg_t0) / self.step))


class ServingEngine:
    """Open-loop serving simulator over the planned flow chains.

    Each iteration: sample churn, let the routing policy plan its
    complete-flow chains (the same ``policy.plan()`` the training
    engine consumes — decode requests ride the *identical* chain sets,
    which is what the serving differential tier pins), admit the
    iteration's compiled arrivals, and schedule decode analytically:
    a request occupies one of ``serve_batch`` continuous-batching slots
    on a chain from prefill start to last token.  Per-request TTFT/TPOT
    land in :class:`RequestMetrics`; the per-iteration conservation
    ledger (``admitted == completed + dropped + in_flight``
    cumulatively) lands in :class:`ServingIterationMetrics`.

    Crash handling is the serving analogue of requeue-instead-of-drop
    (``reroute=True``): in-flight sequences migrate to a surviving
    planned chain, paying crash-detection delay + KV migration at the
    link's admissible wire codec for the surviving stages + re-prefill
    of only the crashed stage — the mirror of the runtime's one-stage
    activation replay.  ``reroute=False`` is the drop-and-retry
    baseline: the sequence restarts from scratch (TTFT re-measured at
    the attempt that completes), and ``max_restarts`` failures drop it.

    KV-cache residency feeds back into planning: at iteration end the
    engine publishes per-node resident-sequence counts into
    ``FlowNetwork.update_kv_residency`` (when ``net.kv_weight > 0``),
    so the next ``plan()`` prices loaded nodes per Eq. 1.  Timing
    itself only reads the physics matrices (``comm_matrix``/compute),
    which the surcharge never touches.

    All arithmetic is a deterministic function of (spec seed, arrival
    program, churn program), so metrics pin byte-for-byte in golden
    files and the runtime executor can replay identical schedules.
    """

    def __init__(self, net: FlowNetwork, policy: RoutingPolicy, *,
                 arrival_program: List[List[float]],
                 churn_model: Optional[ChurnModel] = None,
                 profile: Optional[ModelProfile] = None,
                 prompt_len: int = 8, gen_tokens: int = 8,
                 serve_batch: int = 4, tokens_per_mb: int = 128,
                 timeout: float = 5.0, reroute: bool = True,
                 max_restarts: int = 5,
                 rng: Optional[np.random.Generator] = None,
                 timeline: Optional[FaultTimeline] = None):
        self.net = net
        self.policy = policy
        self.churn_model = churn_model or BernoulliChurn(0.0)
        self.profile = profile or ModelProfile(fwd_compute=2.0)
        self.arrival_program = arrival_program
        self.prompt_len = int(prompt_len)
        self.gen_tokens = int(gen_tokens)
        self.serve_batch = int(serve_batch)
        self.tokens_per_mb = max(1, int(tokens_per_mb))
        self.timeout = float(timeout)       # crash-detection delay
        self.reroute = bool(reroute)
        self.max_restarts = int(max_restarts)
        self.rng = rng or np.random.default_rng(0)
        self.timeline = timeline if timeline is not None else FaultTimeline()
        # bytes per token crossing a stage boundary / resident per stage
        self.token_bytes = self.profile.activation_bytes / self.tokens_per_mb
        self.kv_token_bytes = 2.0 * self.token_bytes     # K and V slices
        self._iteration = 0
        self._clock = 0.0
        self._rid = itertools.count()
        self.requests: Dict[int, RequestMetrics] = {}
        self._reqs: Dict[int, _Req] = {}
        self._active: Dict[int, _Req] = {}       # on a chain right now
        self._queue: deque = deque()             # admitted, waiting
        self._load: Dict[Tuple[int, ...], int] = {}
        self._kv_counts: Dict[int, int] = {}
        self.chain_plans: List[List[Tuple[int, ...]]] = []
        self.traces: List[List[tuple]] = []      # runtime replay script
        self.metrics: List[ServingIterationMetrics] = []

    # -- per-chain timing (physics only; the KV surcharge never lands
    # here — it steers planning, not transfer speed) --------------------
    def _chain_times(self, chain: Tuple[int, ...],
                     fwd_t: List[float]) -> Tuple[float, float]:
        comm_p = self.net.comm_matrix(self.prompt_len * self.token_bytes)
        comm_t = self.net.comm_matrix(self.token_bytes)
        prefill = 0.0
        step = 0.0
        for frm, to in zip(chain, chain[1:]):
            prefill += float(comm_p[frm][to])
            step += float(comm_t[frm][to])
        per_tok = [fwd_t[nid] / self.tokens_per_mb for nid in chain[1:-1]]
        prefill += sum(per_tok) * self.prompt_len
        step += sum(per_tok)
        return prefill, step

    def _resume_time(self, chain: Tuple[int, ...], fwd_t: List[float],
                     tokens: int) -> float:
        """Time to re-materialize ``tokens`` of KV on ``chain`` (the
        prefill formula at an arbitrary token count — used when a
        queued eviction finally lands a slot and must rebuild its
        prompt + generated-token cache before decoding resumes)."""
        comm = self.net.comm_matrix(tokens * self.token_bytes)
        t = 0.0
        for frm, to in zip(chain, chain[1:]):
            t += float(comm[frm][to])
        t += sum(fwd_t[nid] / self.tokens_per_mb
                 for nid in chain[1:-1]) * tokens
        return t

    def _estimate_iteration(self) -> float:
        S = self.net.num_stages
        costs = [n.compute_cost for n in self.net.alive_nodes()
                 if not n.is_data]
        mean_c = float(np.mean(costs)) if costs else 1.0
        per_hop = mean_c * (1 + self.profile.bwd_mult)
        return max(60.0, S * (per_hop + 10.0))

    # ------------------------------------------------------------------
    def run_iteration(self) -> ServingIterationMetrics:
        net = self.net
        it = self._iteration
        self._iteration += 1
        m = ServingIterationMetrics()
        horizon = self._estimate_iteration()
        t_start, t_end = self._clock, self._clock + horizon

        # ---- fault layer ----------------------------------------------
        crash_local = self.churn_model.sample(ChurnContext(
            net=net, rng=self.rng, horizon=horizon,
            iteration=it, on_rejoin=self.policy.on_rejoin))
        record_injections(self.timeline, it, crash_local,
                          adversarial_plan(self.churn_model, it))
        crash_at = {nid: t_start + ct for nid, ct in crash_local.items()}

        # ---- scheduler layer ------------------------------------------
        paths = self.policy.plan()
        chains: List[Tuple[int, ...]] = []
        for p in paths:
            key = tuple(p)
            if key not in chains:
                chains.append(key)
        self.chain_plans.append(list(chains))

        N = (max(net.nodes) + 1) if net.nodes else 0
        fwd_t = [0.05] * N
        for nid, node in net.nodes.items():
            fwd_t[nid] = max(0.05, node.compute_cost)
        times = {c: self._chain_times(c, fwd_t) for c in chains}
        for r in self._active.values():
            if r.chain is not None and r.chain not in times:
                times[r.chain] = self._chain_times(r.chain, fwd_t)

        # loads rebuilt from the live census (plans change every
        # iteration; stale keys must not pin phantom slots)
        load: Dict[Tuple[int, ...], int] = {}
        for r in self._active.values():
            load[r.chain] = load.get(r.chain, 0) + 1
        self._load = load
        kv_counts = self._kv_counts
        kv_peak = max(kv_counts.values(), default=0)
        dead = {nid for nid, node in net.nodes.items() if not node.alive}
        trace: List[tuple] = []

        heap: List[tuple] = []
        seq = itertools.count()
        for nid, ct in sorted(crash_at.items()):
            heappush = heapq.heappush
            heappush(heap, (ct, next(seq), _S_CRASH, nid))
        for r in self._active.values():
            if r.t_complete <= t_end:
                heapq.heappush(heap, (r.t_complete, next(seq), _S_DONE,
                                      (r.rid, r.epoch)))
        offsets = (self.arrival_program[it]
                   if it < len(self.arrival_program) else [])
        for u in offsets:
            rid = next(self._rid)
            rec = RequestMetrics(rid=rid, arrival=t_start + u * horizon,
                                 prompt_len=self.prompt_len,
                                 gen_tokens=self.gen_tokens)
            self.requests[rid] = rec
            self._reqs[rid] = _Req(rid=rid, rec=rec)
            heapq.heappush(heap, (rec.arrival, next(seq), _S_ARRIVE, rid))

        gen = self.gen_tokens

        def chain_crashed(chain: Tuple[int, ...], t: float) -> bool:
            return any(nid in dead or crash_at.get(nid, float("inf")) <= t
                       for nid in chain[1:-1])

        def bump_kv(chain: Tuple[int, ...], delta: int):
            nonlocal kv_peak
            for nid in chain[1:-1]:
                c = kv_counts.get(nid, 0) + delta
                if c:
                    kv_counts[nid] = c
                else:
                    kv_counts.pop(nid, None)
                if c > kv_peak:
                    kv_peak = c

        def start(r: _Req, t: float) -> bool:
            """Begin (or resume) service on the first surviving planned
            chain with a free slot.  ``r.pre == 0`` is a fresh prefill;
            ``r.pre > 0`` resumes a queued eviction — the prompt plus
            the surviving tokens re-materialize first (prefill formula
            at prompt_len + pre tokens), the first-token time is NOT
            re-measured, and decode continues from token ``pre``."""
            for chain in chains:
                if self._load.get(chain, 0) >= self.serve_batch:
                    continue
                if chain_crashed(chain, t):
                    continue
                prefill, step = times[chain]
                r.chain = chain
                r.epoch += 1
                r.step = step
                if r.pre > 0:
                    r.k0 = r.pre
                    r.seg_t0 = t + self._resume_time(
                        chain, fwd_t, self.prompt_len + r.pre)
                else:
                    r.k0 = 1
                    r.seg_t0 = t + prefill
                    r.rec.first_token = r.seg_t0
                r.t_complete = r.seg_t0 + (gen - r.k0) * step
                self._load[chain] = self._load.get(chain, 0) + 1
                self._active[r.rid] = r
                bump_kv(chain, +1)
                trace.append(("start", t, r.rid, chain, r.pre))
                if r.t_complete <= t_end:
                    heapq.heappush(heap, (r.t_complete, next(seq), _S_DONE,
                                          (r.rid, r.epoch)))
                return True
            return False

        def release(r: _Req):
            if r.chain is not None:
                self._load[r.chain] = self._load.get(r.chain, 1) - 1
                bump_kv(r.chain, -1)
                r.chain = None

        def drain_queue(t: float):
            while self._queue:
                r = self._reqs[self._queue[0]]
                if r.done or r.dropped:
                    self._queue.popleft()
                    continue
                if not start(r, t):
                    break
                self._queue.popleft()

        def interrupt(r: _Req, nid: int, ct: float):
            """Chain member ``nid`` crashed at ``ct`` mid-service."""
            nonlocal kv_peak
            k = r.tokens_at(ct, gen)
            old = r.chain
            release(r)
            # invalidate the scheduled completion immediately: every
            # interrupt outcome (requeue, queue-wait, restart, drop)
            # reschedules or abandons it, and a stale _S_DONE firing on
            # a queued request would double-count it as completed
            r.epoch += 1
            r.t_complete = float("inf")
            td = ct + self.timeout        # crash-detection delay
            self.timeline.record(it, "crash", "detection", nid)
            if not self.reroute:
                # drop-and-retry baseline: all decode state is lost
                r.rec.restarts += 1
                m.restarts += 1
                r.pre = r.k0 = 0
                r.rec.first_token = None
                trace.append(("restart", td, r.rid))
                if r.rec.restarts > self.max_restarts:
                    r.dropped = True
                    r.rec.dropped = True
                    self._active.pop(r.rid, None)
                    m.dropped += 1
                    trace.append(("drop", td, r.rid))
                    return
                if not start(r, td):
                    self._active.pop(r.rid, None)
                    self._queue.append(r.rid)
                return
            # defended: requeue-instead-of-drop.  Find a surviving
            # planned chain with a free slot; migrate the KV slices of
            # the surviving stages (priced at the links' admissible
            # wire codec) and re-prefill only the crashed stage(s).
            target = None
            for chain in chains:
                if self._load.get(chain, 0) >= self.serve_batch:
                    continue
                if chain_crashed(chain, td):
                    continue
                target = chain
                break
            if target is None:
                # no capacity anywhere yet: keep the tokens, wait
                r.pre = r.k0 = k
                self._active.pop(r.rid, None)
                self._queue.append(r.rid)
                trace.append(("requeue_wait", td, r.rid, k))
                return
            kv_tokens = self.prompt_len + k
            kv_bytes = self.kv_token_bytes * kv_tokens
            mig = 0.0
            reprefill = 0.0
            moved = 0.0
            for s_idx in range(1, len(target) - 1):
                o_nid, n_nid = old[s_idx], target[s_idx]
                o_dead = (o_nid in dead
                          or crash_at.get(o_nid, float("inf")) <= td)
                if o_dead:
                    # crashed stage: KV is gone — re-prefill it from
                    # the surviving boundary activations
                    reprefill += (fwd_t[n_nid] / self.tokens_per_mb
                                  * kv_tokens)
                elif o_nid != n_nid:
                    mig = max(mig, net.kv_migration_cost(
                        o_nid, n_nid, kv_bytes))
                    moved += kv_bytes
            t2 = td + mig + reprefill
            prefill, step = times[target]
            r.chain = target
            r.epoch += 1
            r.step = step
            r.rec.requeues += 1
            r.rec.migrated_kv_bytes += moved
            m.requeues += 1
            m.migrated_kv_bytes += moved
            if k == 0:
                # crashed during prefill: first token still pending
                r.pre = 0
                r.k0 = 1
                r.seg_t0 = t2 + prefill
                r.rec.first_token = r.seg_t0
            else:
                r.pre = r.k0 = k
                r.seg_t0 = t2
            r.t_complete = r.seg_t0 + (gen - r.k0) * r.step
            self._load[target] = self._load.get(target, 0) + 1
            bump_kv(target, +1)
            self.timeline.record(it, "crash", "repair", nid)
            trace.append(("requeue", td, r.rid, old, target, k))
            if r.t_complete <= t_end:
                heapq.heappush(heap, (r.t_complete, next(seq), _S_DONE,
                                      (r.rid, r.epoch)))

        # requests stranded in the queue from earlier iterations get
        # first claim on the fresh plan
        drain_queue(t_start)

        while heap:
            t, _, kind, payload = heapq.heappop(heap)
            if t > t_end:
                break
            if kind == _S_ARRIVE:
                r = self._reqs[payload]
                m.admitted += 1
                if not start(r, t):
                    self._queue.append(payload)
            elif kind == _S_DONE:
                rid, epoch = payload
                r = self._reqs[rid]
                if r.done or r.dropped or r.epoch != epoch:
                    continue
                r.done = True
                r.rec.completion = r.t_complete
                release(r)
                self._active.pop(rid, None)
                m.completed += 1
                m.ttfts.append(r.rec.ttft)
                m.tpots.append(r.rec.tpot)
                trace.append(("complete", t, rid))
                drain_queue(t)
            else:                                  # _S_CRASH
                nid = payload
                hit = [r for r in self._active.values()
                       if r.chain is not None and nid in r.chain[1:-1]]
                hit.sort(key=lambda r: r.rid)
                for r in hit:
                    interrupt(r, nid, t)
                drain_queue(t)

        # ---- iteration close-out --------------------------------------
        m.in_flight = len(self._active) + len(self._queue)
        m.queued = len(self._queue)
        m.kv_peak = kv_peak
        self._clock = t_end
        self.traces.append(trace)

        # commit crashes for the next iteration (same order as training)
        for nid in crash_local:
            net.kill_node(nid)
            self.policy.on_crash(nid)

        # publish residency so the next plan prices loaded nodes; the
        # trivial (kv_weight == 0) network never sees an update, so its
        # cost epochs stay bit-identical to the serving-free stack
        if net.kv_weight > 0.0:
            net.update_kv_residency(dict(kv_counts))
        self.metrics.append(m)
        return m

    # ------------------------------------------------------------------
    def tokens_now(self, rid: int) -> int:
        """Tokens the request holds at the engine's current clock (the
        runtime executor advances real decoding to exactly this)."""
        r = self._reqs[rid]
        if r.done:
            return self.gen_tokens
        if r.dropped:
            return 0
        return r.tokens_at(self._clock, self.gen_tokens)

    def run(self, iterations: int) -> List[ServingIterationMetrics]:
        return [self.run_iteration() for _ in range(iterations)]
