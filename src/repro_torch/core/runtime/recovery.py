"""Crash injection and stage-local repair for the real-compute runtime.

Port of ``repro.core.runtime.recovery``: the bookkeeping is the JAX
package's line for line (over the port's copies of the flow and sim
layers); only ``replay_lost``'s dispatches run in torch.

The pre-refactor executor hand-rolled Bernoulli churn (one uniform per
node plus an ad-hoc ``integers(0, 2)`` "crash budget") and faked the
crash by renaming the relay before a monolithic full-model dispatch.
This module drives the runtime's faults through the *same* layers the
event simulator uses:

* crashes/rejoins are sampled by a :class:`repro_torch.core.sim.faults.ChurnModel`
  (the trainer builds the ``ChurnContext``), so every churn scenario the
  simulator supports — Bernoulli, trace replay, correlated regional
  outages, compositions — runs against real compute unchanged;
* repair decisions come from a :class:`repro_torch.core.sim.policies.RoutingPolicy`
  via the same ``recover(view, mb, frm, dead, t)`` entry point, against
  a :class:`~repro_torch.core.sim.policies.FaultView` built over the real
  network.

Timing model
------------
The runtime executes a synchronous pipeline flush: stage-major forward
(stage 0 for every microbatch, then stage 1, ...), the loss at the data
node, then stage-major backward.  That sweep *is* the iteration's
timeline: visiting stage ``s`` forward happens at normalized time
``(s+1)/(2S)``, stage ``s`` backward at ``(2S-s)/(2S)``.  A churn
model's crash times (sampled against ``horizon=1.0``) place each crash
at a point in that sweep, so a relay serves every visit before its
crash moment and fails every visit after it — mid-iteration faults
with both forward- and backward-phase crashes, derived from the same
crash-time vocabulary the simulator uses.  Each repair advances the
microbatch by a small discovery penalty (the sender's timeout), so a
repaired microbatch can be hit again later in the sweep.

Repair semantics (paper Sec. V-D, now real)
-------------------------------------------
* forward crash at stage ``s``: the policy reroutes to a same-stage
  substitute, which recomputes *only* stage ``s`` from the stored
  input activation (``fwd_recomputes``);
* backward crash at stage ``s``: the substitute replays that stage's
  VJP (``bwd_replays``) — never a full-pipeline recompute.  Since the
  fused dispatch rework the replay consumes the *stored (possibly
  quantized) VJP residuals* of the chunk directly, so repair costs
  zero forward recomputes; the remat oracle path falls back to
  replaying from the stored input activation;
* policy says ``("fail",)`` (no live same-stage candidate, retries
  exhausted, or a no-reroute policy like ``FixedPolicy``): instead of
  silently dropping the microbatch, the manager requeues it onto
  another planned complete-flow chain from the same data node whose
  remaining relays are still expected alive (``requeued``, reported as
  part of ``rerouted``).  Only when no such chain exists is the
  microbatch dropped.

Beyond fail-stop: the deadline defense
--------------------------------------
When the churn model publishes an :class:`~repro_torch.core.sim.faults.AdversarialPlan`
(hung nodes, deadline-catchable stragglers), ``resolve`` mirrors the
simulator's deadline-triggered re-dispatch: a visit to a hung relay —
or to a straggler slow enough that the healthy-estimate deadline is
guaranteed to fire (``leg_time * (factor - 1) > timeout``, the same
predicate the sim engine applies) — is detected at the sender's
timeout, recorded on the shared :class:`~repro_torch.core.sim.timeline.FaultTimeline`,
and re-dispatched through the same substitute/requeue machinery as a
crash (counted in ``Resolution.deadline_requeues``).  The policy's
view marks hung/catchable nodes crashed-at-0 (exactly like the sim
engine) so recovery never substitutes onto one.  With
``deadline_defense=False`` a hung relay wedges its microbatch for the
whole iteration (dropped), and a slow one is simply waited out — the
undefended baseline the adversarial benchmarks compare against.
Detected nodes are reported in ``Resolution.rep_reports`` for the
trainer's reputation update (quarantine).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch import spans
from repro_torch.core.flow.graph import FlowNetwork
from repro_torch.core.sim.faults import AdversarialPlan
from repro_torch.core.sim.policies import FaultView, RoutingPolicy
from repro_torch.core.sim.timeline import FaultTimeline


@dataclass
class Job:
    """One microbatch's assignment for the iteration."""
    index: int                    # iteration-local id == batch row group
    data_node: int
    mb: dict                      # {"tokens", "labels"}
    chain: List[int]              # [dn, r_0, ..., r_{S-1}, dn]
    penalty: float = 0.0          # accumulated repair-discovery delay
    retries: int = 0
    failed_stage: int = -1
    failed_dir: str = ""


@dataclass
class RepairEvent:
    """One observed crash + its resolution (drives the lost-work
    dispatches of the numeric pass)."""
    job: int
    stage: int
    direction: str                # "fwd" | "bwd"
    dead: int
    substitute: Optional[int] = None   # None -> dropped
    requeued: bool = False


@dataclass
class Resolution:
    """Outcome of the bookkeeping sweep: who completed, who was
    repaired where, and what it cost."""
    completed: List[Job] = field(default_factory=list)
    dropped: int = 0
    rerouted: int = 0             # successful repairs (substitute or requeue)
    requeued: int = 0             # subset of rerouted: adopted another chain
    fwd_recomputes: int = 0
    bwd_replays: int = 0
    events: List[RepairEvent] = field(default_factory=list)
    deadline_requeues: int = 0    # subset of rerouted: re-dispatches fired
    #   by the sender's deadline on a hung/straggling (alive) relay
    rep_reports: List[int] = field(default_factory=list)
    #   detection-attributed nodes for the reputation update


class _MBView:
    """The slice of the simulator's ``_MB`` a policy's ``recover``
    reads: direction + data node (GWTF) and the restart origin
    (SWARM)."""
    __slots__ = ("id", "data_node", "direction", "path")

    def __init__(self, job: Job):
        self.id = job.index
        self.data_node = job.data_node
        self.direction = "fwd"
        self.path = job.chain


class RecoveryManager:
    """Resolves one iteration's crashes against the routing policy."""

    def __init__(self, net: FlowNetwork, policy: RoutingPolicy, *,
                 max_retries: int = 2, timeout: float = 30.0,
                 deadline_defense: bool = True):
        self.net = net
        self.policy = policy
        self.max_retries = max_retries
        # sender-side deadline window (seconds, same default as the sim
        # engine): drives the catchable-straggler predicate below
        self.timeout = timeout
        self.deadline_defense = deadline_defense

    # ------------------------------------------------------------------
    def build_view(self, crash_frac: Dict[int, float],
                   blocked: Sequence[int] = ()) -> FaultView:
        """A ``FaultView`` over the real network on the normalized
        iteration clock: ``crash[nid]`` is the crash moment in [0, 1]
        (inf for survivors); the runtime has no capacity queues, so
        ``busy``/``queues`` are empty and the policy's load penalty
        vanishes.  ``blocked`` nodes (hung / deadline-catchable
        stragglers) are marked crashed-at-0 in the view — the policy's
        *opinion* only, not the engine's liveness tables — so recovery
        never substitutes a microbatch onto one (the sim engine applies
        the identical view trick)."""
        net = self.net
        N = (max(net.nodes) + 1) if net.nodes else 0
        view = FaultView()
        view.net = net
        view.activation_bytes = net.activation_size
        alive = [False] * N
        fwd_t = [0.05] * N
        for nid, node in net.nodes.items():
            alive[nid] = node.alive
            fwd_t[nid] = max(0.05, node.compute_cost)
        view.alive = alive
        crash = [float("inf")] * N
        for nid, f in crash_frac.items():
            crash[nid] = f
        for nid in blocked:
            if nid < N:
                crash[nid] = 0.0
        view.crash = crash
        view.busy = [0] * N
        view.queues = [()] * N
        view.fwd_t = fwd_t
        view.bwd_t = [2.0 * c for c in fwd_t]
        view.comm_rows = net.comm_matrix().tolist()
        view.edge_rows = net.edge_matrix().tolist()
        cache: Dict[int, list] = {}

        def stage_nodes(s: int) -> list:
            nodes = cache.get(s)
            if nodes is None:
                nodes = net.stage_nodes(s)
                cache[s] = nodes
            return nodes

        view.stage_nodes = stage_nodes
        return view

    # ------------------------------------------------------------------
    def resolve(self, jobs: Sequence[Job], chains: Sequence[Sequence[int]],
                crash_times: Dict[int, float], horizon: float,
                adv: Optional[AdversarialPlan] = None,
                timeline: Optional[FaultTimeline] = None,
                iteration: int = 0) -> Resolution:
        """Sweep the iteration's visits through the crash plan.

        ``chains`` is the full planned chain set (assigned + spare);
        requeue candidates come from it.  Pure bookkeeping: the numeric
        pass afterwards executes exactly the completed set plus the
        recorded lost-work dispatches.  ``adv`` (when the churn model
        publishes one) adds hung/straggling relays to the sweep;
        detections and repairs land on ``timeline`` at ``iteration``.
        """
        S = self.net.num_stages
        frac = {nid: max(0.0, min(1.0, t / horizon))
                for nid, t in crash_times.items()}
        res = Resolution()
        self._frac = frac
        self._chains = [list(c) for c in chains]
        self._timeline = timeline
        self._iteration = iteration
        # adversarial stall sets, per direction.  Hung nodes stall any
        # visit; a straggler stalls a visit only when the slowed leg is
        # guaranteed past the healthy-estimate deadline — the sim
        # engine's catchability predicate, on this layer's own
        # fwd_t/bwd_t tables.
        self._hung = frozenset(adv.hung) if adv is not None else frozenset()
        slow = adv.slow if adv is not None else {}
        catch_f, catch_b = set(), set()
        for nid, f in slow.items():
            node = self.net.nodes.get(nid)
            if node is None:
                continue
            leg = max(0.05, node.compute_cost)
            if leg * (f - 1.0) > self.timeout:
                catch_f.add(nid)
            if 2.0 * leg * (f - 1.0) > self.timeout:
                catch_b.add(nid)
        self._stall_fwd = self._hung | frozenset(catch_f)
        self._stall_bwd = self._hung | frozenset(catch_b)
        # the policy's view blocks exactly the nodes the *forward*
        # predicate catches (the sim engine blocks the same set)
        blocked = self._stall_fwd if self.deadline_defense else frozenset()
        view = self.build_view(frac, sorted(blocked))
        self._view = view
        self._blocked = blocked

        live = list(jobs)
        for s in range(S):                       # forward sweep
            t = (s + 1) / (2 * S)
            live = [j for j in live
                    if self._visit(j, s, "fwd", t, res)]
        # loss at the data node (data nodes do not churn), turn around
        for s in reversed(range(S)):             # backward sweep
            t = (2 * S - s) / (2 * S)
            live = [j for j in live
                    if self._visit(j, s, "bwd", t, res)]
        res.completed = live
        return res

    # ------------------------------------------------------------------
    def _dead_at(self, nid: int, t: float) -> bool:
        f = self._frac.get(nid)
        return f is not None and f <= t

    def _record(self, fault: str, kind: str, node: int):
        if self._timeline is not None:
            self._timeline.record(self._iteration, fault, kind, node)

    def _visit(self, job: Job, s: int, direction: str, t: float,
               res: Resolution) -> bool:
        relay = job.chain[s + 1]
        stall = self._stall_fwd if direction == "fwd" else self._stall_bwd
        while True:
            now = min(1.0, t + job.penalty)
            dead = self._dead_at(relay, now)
            stalled = not dead and relay in stall
            if not dead and not stalled:
                return True                       # visit served
            if stalled:
                if not self.deadline_defense:
                    if relay in self._hung:
                        # no deadline fires: the hung relay wedges the
                        # microbatch for the whole iteration
                        job.failed_stage, job.failed_dir = s, direction
                        res.dropped += 1
                        return False
                    return True   # undefended straggler: waited out
                # sender's deadline fires on an alive-but-useless relay
                self._record("straggler", "detection", relay)
                res.rep_reports.append(relay)
            ev = RepairEvent(job.index, s, direction, relay)
            res.events.append(ev)
            job.retries += 1
            decision = ("fail",)
            if job.retries <= self.max_retries:
                mbv = _MBView(job)
                mbv.direction = direction
                frm = job.chain[s] if direction == "fwd" else job.chain[s + 2]
                decision = self.policy.recover(self._view, mbv, frm,
                                               relay, now)
            # discovery penalty: the sender's timeout window, half a
            # stage slot on the normalized clock
            job.penalty += 0.5 / (2 * self.net.num_stages)
            now = min(1.0, t + job.penalty)
            if decision[0] == "substitute":
                sub = decision[1]
                if not self._dead_at(sub, now):
                    job.chain[s + 1] = sub
                    ev.substitute = sub
                    res.rerouted += 1
                    self._count_recompute(direction, res)
                    if stalled:
                        res.deadline_requeues += 1
                        self._record("straggler", "repair", relay)
                    relay = sub
                    continue
                relay = sub                       # substitute died too
                continue
            if decision[0] == "restart":
                # SWARM-style full restart is requeue-from-the-data-node
                # in the flush schedule; fall through to the requeue
                # search (which restarts on a live chain) so no policy
                # silently drops a saveable microbatch.
                pass
            nc = self._find_requeue_chain(job, s, direction, now)
            if nc is None:
                job.failed_stage, job.failed_dir = s, direction
                res.dropped += 1
                return False
            job.chain = list(nc)
            ev.substitute = job.chain[s + 1]
            ev.requeued = True
            res.rerouted += 1
            res.requeued += 1
            self._count_recompute(direction, res)
            if stalled:
                res.deadline_requeues += 1
                self._record("straggler", "repair", relay)
            relay = job.chain[s + 1]

    # ------------------------------------------------------------------
    # Lost-work dispatch (the numeric side of each recorded crash)
    # ------------------------------------------------------------------
    @staticmethod
    def replay_lost(stages, store, stage_params, res: Resolution,
                    s: int, direction: str, *, ids: Sequence[int],
                    cotangent=None, per: int = 0,
                    remat: bool = False) -> None:
        """Dispatch the dead replica's lost work for each crash recorded
        at stage ``s`` within the chunk ``ids``.

        * forward crash: one wasted stage forward from the stored
          boundary activation (``store.get``);
        * backward crash, fused mode: one wasted VJP replay **from the
          stored (possibly quantized) residuals** of the chunk — zero
          forward recomputes, the post-rework repair primitive;
        * backward crash, remat mode (or residuals already dropped):
          one wasted rematerialising VJP from the stored boundary
          activation, as before.

        Results are discarded — the substitute's (identical)
        computation lives in the batch — but the wall time and the
        dispatch counters are real, which is what the recovery
        benchmarks and tests measure.  A replay reads the cotangent and
        leaves it as it was (torch donates no buffer), so the real
        backward can use the same one.
        """
        ids = tuple(ids)
        for ev in res.events:
            if ev.stage != s or ev.direction != direction:
                continue
            if ev.job not in ids:
                continue    # dropped, or belongs to another chunk
            if direction == "fwd":
                try:
                    xin = store.get(s, ev.job)
                except KeyError:
                    continue
                with spans.span("replay", stage=s, direction=direction):
                    stages.forward(s, stage_params[s], xin)
                continue
            if cotangent is None:
                continue
            if not remat and store.has_residuals(s, ids):
                with spans.span("replay", stage=s, direction=direction):
                    stages.backward_from_residuals(
                        s, store.residuals(s, ids), cotangent)
                continue
            try:
                xin = store.get(s, ev.job)
            except KeyError:
                continue
            k = ids.index(ev.job)
            with spans.span("replay", stage=s, direction=direction):
                stages.backward(s, stage_params[s], xin,
                                cotangent[k * per:(k + 1) * per])

    @staticmethod
    def _count_recompute(direction: str, res: Resolution) -> None:
        if direction == "fwd":
            res.fwd_recomputes += 1
        else:
            res.bwd_replays += 1

    def _find_requeue_chain(self, job: Job, s: int, direction: str,
                            t: float) -> Optional[List[int]]:
        """Another planned complete-flow chain from the same data node
        whose relays for the *remaining* legs are expected alive at
        ``t`` — the stored stage-``s`` activation moves there and the
        microbatch continues instead of being dropped."""
        S = self.net.num_stages
        for chain in self._chains:
            # sharing a chain already carrying another microbatch is
            # fine: replicas are identical and the runtime does not
            # model slot capacity (the simulator answers "how long")
            if chain[0] != job.data_node or chain == job.chain:
                continue
            if direction == "fwd":
                remaining = chain[s + 1:S + 1]
            else:
                remaining = chain[1:s + 2]
            if all(self.net.nodes[r].alive and not self._dead_at(r, t)
                   and r not in self._blocked
                   for r in remaining):
                return chain
        return None
