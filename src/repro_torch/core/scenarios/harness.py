"""Cross-layer differential / metamorphic harness over scenario specs.

One `ScenarioSpec` drives every execution layer the repo has; the
harness checks that they *agree*:

* `check_flow_equivalence` — the three flow engines (batched
  `GWTFProtocol`, its ``strict_rng`` scalar mode, and the frozen
  `ReferenceGWTFProtocol`) produce bit-identical flows, total cost,
  annealing temperature and RNG stream on the scenario — including
  after a scripted crash/reclaim/repair/rejoin episode;
* `check_optimal_consistency` — the `MinCostFlow` dial (bucket-queue)
  and dense Dijkstra cores find the same optimum on the scenario's
  layered graph;
* `check_sim_runtime_consistency` — the event simulator and the
  real-compute runtime, given the same spec, plan identical chain
  sets every iteration and agree on reroute/requeue/recompute
  accounting for deterministic churn programs;
* metamorphic invariants — `check_capacity_monotonicity` (adding
  relay capacity never increases the optimal cost of the same flow
  volume), `check_zero_churn` (no churn ⇒ no wasted GPU, no reroutes,
  and the runtime's trajectory is bit-identical to
  `CentralizedTrainer`), `check_permutation_invariance` (relabeling
  node ids preserves the optimum);
* `check_hierarchy_gap` — the hierarchical geo-planner
  (`flow.hierarchy.solve_hierarchical`) emits feasible chains within
  the committed optimality-gap bound of the flat dial MCMF oracle;
* `check_codec_agreement` — on scenarios with a ``compression``
  clause, the flow planner's per-edge codec choices, the simulator's
  bytes-on-wire accounting and the runtime's per-boundary wire codecs
  all derive from the same codec-choice matrix, and an fp32-only menu
  is bit-identical to no clause at all on every layer;
* `fuzz` — seeded randomized spec generation under a wall-clock
  budget; a failing spec is shrunk (`minimize`) to a minimal
  reproducer and written into the committed corpus directory so it
  becomes a named regression scenario on the next run.  Two sampling
  regimes: `random_spec` (tiny shapes, every check) and
  `random_scale_spec` (1000+ relays, the restricted `scale_checks`
  regime — no reference engine, no real compute).

Failures raise `ScenarioDiscrepancy` carrying the spec (as JSON) so a
reproducer is always one ``ScenarioSpec.from_json`` away.

Port of ``repro.core.scenarios.harness``.  Every check that runs only the
numpy layers (flow engines, oracle, simulator, serving engine), the spec
samplers, `minimize` and `fuzz` are the reference's text with its
``repro.`` imports rewritten, which ``tests/test_torch_harness.py``
holds function by function.  The checks that run real compute
(`check_sim_runtime_consistency`, `check_fault_timeline`,
`check_detection_precision_recall`, `check_zero_churn`,
`check_codec_agreement`, `check_serving_consistency`) build the port's
trainers on ``device``, ``"cuda"`` unless the caller asks for the CPU (a
missing GPU is an error), and `run_checks` passes its ``device`` to them.
`check_zero_churn`'s bit-equalities need deterministic algorithms, which
it turns on around its runtime leg; on a CUDA device they also need
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (or ``:16:8``) set before CUDA
starts, which the check requires and does not set.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.scenarios import generate
from repro_torch.core.scenarios.spec import ADVERSARIAL_CLAUSES, ScenarioSpec


class ScenarioDiscrepancy(AssertionError):
    """Two layers (or two engines) disagreed on the same scenario."""

    def __init__(self, spec: ScenarioSpec, check: str, detail: str):
        self.spec = spec
        self.check = check
        self.detail = detail
        super().__init__(
            f"[{check}] {detail}\n--- failing spec ---\n{spec.to_json()}")


def _require(cond: bool, spec: ScenarioSpec, check: str, detail: str) -> None:
    if not cond:
        raise ScenarioDiscrepancy(spec, check, detail)


# ---------------------------------------------------------------------------
# Flow-layer differential: batched vs strict vs reference, bit-equal
# ---------------------------------------------------------------------------

def check_flow_equivalence(spec: ScenarioSpec, max_rounds: int = 120,
                           churn_episode: bool = True) -> Dict[str, Any]:
    """All three flow engines agree bit-for-bit on the scenario."""
    runs = {eng: generate.run_flow(spec, eng, max_rounds=max_rounds)
            for eng in generate.FLOW_ENGINES}
    ref = runs["reference"]
    for eng in ("batched", "strict"):
        r = runs[eng]
        _require(r.flows == ref.flows, spec, "flow-equivalence",
                 f"{eng}: flows diverged from reference "
                 f"({len(r.flows)} vs {len(ref.flows)} chains)")
        _require(r.total_cost == ref.total_cost, spec, "flow-equivalence",
                 f"{eng}: total cost {r.total_cost!r} != "
                 f"reference {ref.total_cost!r}")
        _require(r.temperature == ref.temperature, spec, "flow-equivalence",
                 f"{eng}: annealing temperature diverged")
        _require(r.rng_state == ref.rng_state, spec, "flow-equivalence",
                 f"{eng}: RNG stream diverged from reference")
    episode = None
    if churn_episode and ref.flows:
        episode = _flow_churn_episode(spec, runs)
    return {"flows": len(ref.flows), "total_cost": ref.total_cost,
            "rounds": ref.rounds, "churn_episode": episode}


def _flow_churn_episode(spec: ScenarioSpec, runs) -> Dict[str, Any]:
    """Crash the same deterministically-chosen relays in every engine,
    repair, rejoin, and re-check bit-equality (exercises remove_node /
    reclaim / add_node index maintenance on the scenario topology)."""
    flows = runs["reference"].flows
    victims = sorted({flows[0][1]} |
                     ({flows[-1][2]} if spec.num_stages > 1 else set()))
    for phase in ("crash", "rejoin"):
        for r in runs.values():
            for v in victims:
                if phase == "crash":
                    r.net.kill_node(v)
                    r.protocol.remove_node(v)
                else:
                    r.net.nodes[v].alive = True
                    r.protocol.add_node(r.net.nodes[v])
            r.protocol.reclaim_sink_slots()
            r.protocol.run(40, quiet_rounds=5)
        ref = runs["reference"].protocol
        for eng in ("batched", "strict"):
            p = runs[eng].protocol
            _require(p.complete_flows() == ref.complete_flows(), spec,
                     "flow-equivalence",
                     f"{eng}: flows diverged after {phase} of {victims}")
            _require(p.total_cost() == ref.total_cost(), spec,
                     "flow-equivalence",
                     f"{eng}: cost diverged after {phase} of {victims}")
            _require(p.rng.bit_generator.state ==
                     ref.rng.bit_generator.state, spec, "flow-equivalence",
                     f"{eng}: RNG stream diverged after {phase}")
    return {"victims": victims,
            "flows_after": len(ref.complete_flows())}


# ---------------------------------------------------------------------------
# Oracle differential: dial vs dense Dijkstra cores
# ---------------------------------------------------------------------------

def check_optimal_consistency(spec: ScenarioSpec) -> Dict[str, Any]:
    """`MinCostFlow` dial and dense cores agree on the scenario's
    layered graph (exact on the synthetic integer-cost topologies)."""
    net, cm = generate.build_network(spec)
    dense = generate.solve_optimal(spec, "dense", net=net, cost_matrix=cm)
    if spec.topology == "synthetic":
        net2, cm2 = generate.build_network(spec)
        dial = generate.solve_optimal(spec, "dial", net=net2,
                                      cost_matrix=cm2)
        _require(dial.flow == dense.flow, spec, "optimal-consistency",
                 f"dial flow {dial.flow} != dense flow {dense.flow}")
        _require(abs(dial.cost - dense.cost) <= 1e-6 * max(1.0, dense.cost),
                 spec, "optimal-consistency",
                 f"dial cost {dial.cost!r} != dense cost {dense.cost!r}")
        return {"flow": dense.flow, "cost": dense.cost, "methods": 2}
    return {"flow": dense.flow, "cost": dense.cost, "methods": 1}


# ---------------------------------------------------------------------------
# Sim vs runtime: plans and fault accounting
# ---------------------------------------------------------------------------

class RecordingPolicy:
    """Transparent `RoutingPolicy` wrapper recording per-iteration
    plans and recover() decisions without touching any RNG stream."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self.plans: List[List[List[int]]] = []
        self.recover_calls: int = 0

    @property
    def protocol(self):
        return getattr(self.inner, "protocol", None)

    def plan(self):
        paths = self.inner.plan()
        self.plans.append([list(p) for p in paths])
        return paths

    def recover(self, view, mb, frm, dead, t):
        self.recover_calls += 1
        return self.inner.recover(view, mb, frm, dead, t)

    def on_rejoin(self, node):
        self.inner.on_rejoin(node)

    def on_crash(self, nid):
        self.inner.on_crash(nid)


def check_sim_runtime_consistency(spec: ScenarioSpec,
                                  iterations: Optional[int] = None,
                                  device="cuda") -> Dict[str, Any]:
    """The simulator and the real-compute runtime, driven by the same
    spec, must agree on what was *planned* and on the shape of what
    went wrong.

    Checked every iteration:

    * identical planned chain sets (GWTF recovery draws no RNG, so the
      policy streams stay aligned across layers);
    * runtime conservation: ``completed + dropped == launched`` and
      ``fwd_recomputes + bwd_replays == rerouted``;
    * with a *deterministic* churn program: iterations whose crash set
      is empty are clean on both layers (no reroutes, no wasted GPU,
      no drops), and iterations where a planned relay crashes before
      mid-sweep produce repair activity on both layers.
    """
    its = iterations if iterations is not None else spec.iterations
    sim_rec: Dict[str, RecordingPolicy] = {}

    def wrap_sim(p):
        sim_rec["p"] = RecordingPolicy(p)
        return sim_rec["p"]

    sim = generate.build_sim(spec, policy_wrapper=wrap_sim)
    sim_metrics = sim.run(its)

    rt_rec: Dict[str, RecordingPolicy] = {}

    def wrap_rt(p):
        rt_rec["p"] = RecordingPolicy(p)
        return rt_rec["p"]

    trainer, batches = generate.build_runtime(spec, policy_wrapper=wrap_rt,
                                              device=device)
    rt_results = [trainer.iteration(batches) for _ in range(its)]

    sim_plans = sim_rec["p"].plans
    rt_plans = rt_rec["p"].plans
    _require(len(sim_plans) == len(rt_plans) == its, spec,
             "sim-runtime", "per-iteration plan counts diverged")
    if spec.scheduler == "gwtf":
        # SWARM's backward recovery replans with RNG draws, so its
        # streams legitimately diverge after the first fault; GWTF's
        # recovery is RNG-free and must stay in lock-step.
        for i, (a, b) in enumerate(zip(sim_plans, rt_plans)):
            _require(a == b, spec, "sim-runtime",
                     f"iteration {i}: planned chain sets diverged "
                     f"(sim {len(a)} chains vs runtime {len(b)})")

    for i, (m, r) in enumerate(zip(sim_metrics, rt_results)):
        _require(r.completed + r.dropped == r.launched, spec, "sim-runtime",
                 f"iteration {i}: runtime conservation violated "
                 f"({r.completed} + {r.dropped} != {r.launched})")
        _require(r.fwd_recomputes + r.bwd_replays == r.rerouted, spec,
                 "sim-runtime",
                 f"iteration {i}: runtime recompute accounting violated "
                 f"({r.fwd_recomputes} + {r.bwd_replays} != {r.rerouted})")
        _require(r.requeued <= r.rerouted, spec, "sim-runtime",
                 f"iteration {i}: requeued > rerouted")
        _require(r.deadline_requeues <= r.rerouted, spec, "sim-runtime",
                 f"iteration {i}: deadline_requeues "
                 f"{r.deadline_requeues} > rerouted {r.rerouted}")
        _require(m.completed <= m.launched, spec, "sim-runtime",
                 f"iteration {i}: sim completed > launched")
        _require(m.retries <= m.timeouts, spec, "sim-runtime",
                 f"iteration {i}: sim retries {m.retries} > fired "
                 f"deadline checks {m.timeouts}")
        if spec.microbatches >= spec.data_capacity:
            _require(r.launched == m.launched, spec, "sim-runtime",
                     f"iteration {i}: launch counts diverged "
                     f"(sim {m.launched} vs runtime {r.launched})")

    if spec.deterministic_churn:
        crash_plan = generate.iteration_crash_plan(spec)
        adv_plans = generate.iteration_adversarial_plan(spec)
        for i, (m, r) in enumerate(zip(sim_metrics, rt_results)):
            crashes = crash_plan.get(i, [])
            planned = {nid for chain in rt_plans[i] for nid in chain}
            on_plan_early = [nid for nid, when in crashes
                             if nid in planned and when <= 0.5]
            if not crashes and i in adv_plans:
                # adversarial faults legitimately cause reroutes, wasted
                # compute and drops without any crash; the fault-timeline
                # check pins their exact accounting instead
                continue
            if not crashes:
                _require(m.reroutes == 0 and m.wasted_gpu == 0.0, spec,
                         "sim-runtime",
                         f"iteration {i}: sim reports faults "
                         f"(reroutes={m.reroutes}, "
                         f"wasted={m.wasted_gpu}) on a crash-free "
                         f"iteration")
                _require(r.rerouted == 0 and r.dropped == 0, spec,
                         "sim-runtime",
                         f"iteration {i}: runtime reports faults on a "
                         f"crash-free iteration")
            elif on_plan_early and spec.scheduler == "gwtf":
                sim_saw = (m.reroutes > 0 or m.completed < m.launched
                           or m.wasted_gpu > 0.0)
                rt_saw = r.rerouted > 0 or r.dropped > 0
                _require(sim_saw, spec, "sim-runtime",
                         f"iteration {i}: relays {on_plan_early} crashed "
                         f"on-plan but the simulator saw no fault")
                _require(rt_saw, spec, "sim-runtime",
                         f"iteration {i}: relays {on_plan_early} crashed "
                         f"on-plan but the runtime saw no fault")
    return {
        "iterations": its,
        "sim_launched": [m.launched for m in sim_metrics],
        "runtime_launched": [r.launched for r in rt_results],
        "runtime_rerouted": sum(r.rerouted for r in rt_results),
        "sim_reroutes": sum(m.reroutes for m in sim_metrics),
    }


# ---------------------------------------------------------------------------
# Fault timeline: the shared beyond-fail-stop record
# ---------------------------------------------------------------------------

def _adversarial_kinds(spec: ScenarioSpec) -> set:
    return {c["kind"] for c in spec.churn if c["kind"] in ADVERSARIAL_CLAUSES}


def check_fault_timeline(spec: ScenarioSpec,
                         iterations: Optional[int] = None,
                         device="cuda") -> Dict[str, Any]:
    """The simulator and the runtime, driven by the same deterministic
    adversarial churn program, must produce *identical* fault
    timelines where the faults are cross-layer:

    * per-iteration injection counts for every fault class equal the
      static `iteration_adversarial_plan` view on both layers (the
      layers can't even disagree by both being wrong the same way);
    * per-iteration detection and repair counts agree exactly between
      the layers for the cross-layer fault classes (straggler,
      corrupt_gradient) — the deadline defense and the gradient screen
      fire the same number of times at the same iterations whether the
      training step is simulated or real.

    Flaky-link detection/repair is engine-local (the runtime performs
    no physical transfer legs) and is excluded by
    ``FaultTimeline.comparable_counts``; its injections still compare.
    """
    from repro_torch.core.sim.timeline import CROSS_LAYER_FAULTS

    check = "fault-timeline"
    if not spec.deterministic_churn:
        raise ValueError(f"{spec.name}: check_fault_timeline needs a "
                         f"deterministic churn program")
    if not _adversarial_kinds(spec):
        raise ValueError(f"{spec.name}: check_fault_timeline needs at "
                         f"least one adversarial churn clause")
    its = iterations if iterations is not None else spec.iterations
    adv_plans = generate.iteration_adversarial_plan(spec)

    sim = generate.build_sim(spec)
    sim.run(its)
    sim_tl = sim.engine.timeline
    trainer, batches = generate.build_runtime(spec, device=device)
    for _ in range(its):
        trainer.iteration(batches)
    rt_tl = trainer.timeline

    # ---- injections vs the static plan, on both layers ----------------
    for layer, tl in (("sim", sim_tl), ("runtime", rt_tl)):
        counts = tl.counts()
        for it in range(its):
            plan = adv_plans.get(it)
            expect = {
                "straggler": (len(set(plan.slow) | set(plan.hung))
                              if plan else 0),
                "corrupt_gradient": len(plan.corrupt) if plan else 0,
                "flaky_link": plan.flaky_episodes if plan else 0,
            }
            for fault, want in expect.items():
                got = counts.get((it, fault, "injection"), 0)
                _require(got == want, spec, check,
                         f"{layer} iteration {it}: {fault} injections "
                         f"{got} != planned {want}")

    # ---- cross-layer detection / repair equality ----------------------
    sim_cmp = sim_tl.comparable_counts()
    rt_cmp = rt_tl.comparable_counts()
    if sim_cmp != rt_cmp:
        diff = {k: (sim_cmp.get(k, 0), rt_cmp.get(k, 0))
                for k in sorted(set(sim_cmp) | set(rt_cmp))
                if sim_cmp.get(k, 0) != rt_cmp.get(k, 0)}
        _require(False, spec, check,
                 f"fault timelines diverged (key -> (sim, runtime)): "
                 f"{diff}")
    detections = sum(v for (it, fault, kind), v in sim_cmp.items()
                     if kind == "detection" and fault in CROSS_LAYER_FAULTS)
    return {"iterations": its, "records": (len(sim_tl), len(rt_tl)),
            "cross_layer_detections": detections}


def check_detection_precision_recall(spec: ScenarioSpec,
                                     iterations: Optional[int] = None,
                                     device="cuda") -> Dict[str, Any]:
    """The runtime gradient screen, on a deterministic corrupt-gradient
    program with a certainly-detectable mode ("perturb"/"zero"), has

    * recall 1.0 — every completed contribution whose final chain
      crossed a corrupt relay is detected (ground truth re-derived
      from the recorded per-iteration plans and the static adversarial
      plan, not from the screen's own bookkeeping);
    * precision 1.0 on attribution — every detection record names a
      relay the churn program actually corrupted that iteration.

    Sign-flip corruption is excluded by construction: near
    initialization honest per-microbatch gradients are close to
    orthogonal, so a flipped sign is statistically invisible — the
    corpus pins the detectable modes and documents the regime split.
    """
    check = "detection-precision-recall"
    corrupt_clauses = [c for c in spec.churn
                       if c["kind"] == "corrupt_gradient"]
    if not corrupt_clauses:
        raise ValueError(f"{spec.name}: needs a corrupt_gradient clause")
    undetectable = [c for c in corrupt_clauses
                    if c.get("mode", "perturb") not in ("perturb", "zero")]
    if undetectable:
        raise ValueError(f"{spec.name}: precision/recall is only exact "
                         f"for certainly-detectable modes, got "
                         f"{[c.get('mode') for c in undetectable]}")
    its = iterations if iterations is not None else spec.iterations
    adv_plans = generate.iteration_adversarial_plan(spec)

    rec: Dict[str, RecordingPolicy] = {}

    def wrap(p):
        rec["p"] = RecordingPolicy(p)
        return rec["p"]

    trainer, batches = generate.build_runtime(spec, policy_wrapper=wrap,
                                              device=device)
    results = [trainer.iteration(batches) for _ in range(its)]
    counts = trainer.timeline.counts()

    truths: List[int] = []
    detected: List[int] = []
    for it in range(its):
        plan = adv_plans.get(it)
        corrupt = set(plan.corrupt) if plan else set()
        # ground truth: planned chains crossing a corrupt relay, one
        # detection record per (contribution, corrupt stage hop); with
        # no crash clauses the final chain is the planned chain
        truth = sum(1 for chain in rec["p"].plans[it]
                    for nid in chain[1:-1] if nid in corrupt)
        got = counts.get((it, "corrupt_gradient", "detection"), 0)
        truths.append(truth)
        detected.append(got)
        _require(got == truth, spec, check,
                 f"iteration {it}: screen detected {got} corrupt "
                 f"contributions, ground truth {truth} (recall/precision "
                 f"broken)")
        _require(results[it].grads_flagged >= got, spec, check,
                 f"iteration {it}: {got} detections but only "
                 f"{results[it].grads_flagged} contributions excluded")
        for r_it, fault, kind, node in [
                (r.iteration, r.fault, r.kind, r.node)
                for r in trainer.timeline.records]:
            if r_it == it and fault == "corrupt_gradient" \
                    and kind == "detection":
                _require(node in corrupt, spec, check,
                         f"iteration {it}: detection accused node "
                         f"{node}, not a corrupt relay {sorted(corrupt)}")
    return {"iterations": its, "ground_truth": truths,
            "detected": detected}


# ---------------------------------------------------------------------------
# Metamorphic invariants
# ---------------------------------------------------------------------------

def check_capacity_monotonicity(spec: ScenarioSpec,
                                bumps: int = 3) -> Dict[str, Any]:
    """Adding relay capacity never increases the optimal cost of
    routing the *same* flow volume."""
    net, cm = generate.build_network(spec)
    base = generate.solve_optimal(spec, "dense", net=net, cost_matrix=cm)
    if base.flow <= 0:
        return {"flow": 0.0, "skipped": True}
    relays = [n for n in net.nodes.values() if not n.is_data]
    for k in range(min(bumps, len(relays))):
        relays[(k * 7919) % len(relays)].capacity += 1
    grown = generate.solve_optimal(spec, "dense", net=net, cost_matrix=cm,
                                   max_flow=base.flow)
    _require(grown.flow == base.flow, spec, "capacity-monotonicity",
             f"flow changed under a flow cap ({grown.flow} != {base.flow})")
    tol = 1e-9 * max(1.0, abs(base.cost))
    _require(grown.cost <= base.cost + tol, spec, "capacity-monotonicity",
             f"adding capacity increased optimal cost "
             f"({base.cost!r} -> {grown.cost!r})")
    return {"flow": base.flow, "cost": base.cost, "grown_cost": grown.cost}


#: the ``CUBLAS_WORKSPACE_CONFIG`` values under which cuBLAS is deterministic
DETERMINISTIC_CUBLAS = (":4096:8", ":16:8")


@contextlib.contextmanager
def deterministic(device):
    """Deterministic algorithms inside the block: without them the
    embedding's backward sums in no fixed order, on a multi-threaded CPU
    and on the GPU, and the runtime's bit-equalities do not hold.  On a
    CUDA device cuBLAS is deterministic only with
    ``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts, which a running
    process cannot do for itself: the block raises if it is not set."""
    if torch.device(device).type == "cuda" and os.environ.get(
            "CUBLAS_WORKSPACE_CONFIG") not in DETERMINISTIC_CUBLAS:
        raise RuntimeError(
            "the zero-churn bit-equalities on a CUDA device need "
            "CUBLAS_WORKSPACE_CONFIG=:4096:8 (or :16:8) in the environment "
            "before CUDA starts")
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def check_zero_churn(spec: ScenarioSpec,
                     iterations: Optional[int] = None,
                     runtime: bool = True, device="cuda") -> Dict[str, Any]:
    """Zero churn ⇒ a perfectly clean simulation (no wasted GPU, no
    reroutes, nothing truncated) and — for single-data-node scenarios —
    a runtime loss trajectory bit-identical to `CentralizedTrainer`
    on the same completed microbatch prefix.  The runtime leg runs under
    `deterministic` (on a CUDA device it needs ``CUBLAS_WORKSPACE_CONFIG``
    set before CUDA starts)."""
    if spec.churn:
        raise ValueError(f"{spec.name}: check_zero_churn needs an empty "
                         f"churn program")
    its = iterations if iterations is not None else spec.iterations
    metrics = generate.run_sim(spec, iterations=its)
    for i, m in enumerate(metrics):
        _require(m.wasted_gpu == 0.0, spec, "zero-churn",
                 f"iteration {i}: wasted_gpu={m.wasted_gpu} without churn")
        _require(m.reroutes == 0, spec, "zero-churn",
                 f"iteration {i}: reroutes={m.reroutes} without churn")
        _require(not m.truncated, spec, "zero-churn",
                 f"iteration {i}: truncated without churn")
        _require(m.completed == m.launched > 0, spec, "zero-churn",
                 f"iteration {i}: {m.completed}/{m.launched} completed")
        _require(m.timeouts == 0 and m.retries == 0, spec, "zero-churn",
                 f"iteration {i}: deadline fired without churn "
                 f"(timeouts={m.timeouts}, retries={m.retries})")
    result = {"iterations": its, "sim_completed":
              [m.completed for m in metrics]}
    if runtime and spec.num_data_nodes == 1:
        with deterministic(device):
            result.update(_zero_churn_runtime(spec, its, device))
    return result


def _zero_churn_runtime(spec: ScenarioSpec, its: int,
                        device) -> Dict[str, Any]:
    """`check_zero_churn`'s runtime leg: churn 0 against
    `CentralizedTrainer` and fused against remat, loss for loss."""
    from repro_torch.core.runtime.trainer import CentralizedTrainer

    trainer, batches = generate.build_runtime(spec, device=device)
    oracle, _ = generate.build_runtime(spec, remat=True, device=device)
    dn = next(iter(batches))
    cen = CentralizedTrainer(generate.model_config(spec),
                             spec.num_stages, lr=3e-3, seed=spec.seed,
                             device=device)
    rt_its = min(its, 3)       # real compute: keep the check cheap
    for i in range(rt_its):
        r = trainer.iteration(batches)
        _require(r.dropped == 0 and r.rerouted == 0, spec, "zero-churn",
                 f"iteration {i}: runtime repaired/dropped without "
                 f"churn")
        cl = cen.iteration(batches[dn][:r.completed])
        _require(r.loss == cl, spec, "zero-churn",
                 f"iteration {i}: decentralized loss {r.loss!r} != "
                 f"centralized {cl!r} (bit-equality broken)")
        # fused vs remat: the in-engine equality oracle (same
        # compiled programs, composed) must agree bitwise too
        ro = oracle.iteration(batches)
        _require(r.loss == ro.loss, spec, "zero-churn",
                 f"iteration {i}: fused loss {r.loss!r} != remat "
                 f"oracle {ro.loss!r} (bit-equality broken)")
    _require(trainer.stages.remat_recompute_count == 0, spec,
             "zero-churn", "fused path recomputed a forward")
    return {"runtime_iterations": rt_its,
            "store_peak_bytes": trainer.last_store_peak_bytes}


def permuted_network(net, perm: Dict[int, int]):
    """Relabel node ids by ``perm`` (a bijection over all ids), keeping
    every attribute and permuting the link matrices accordingly."""
    from repro_torch.core.flow.graph import FlowNetwork, Node

    n = net.latency.shape[0]
    inv = np.empty(n, np.int64)
    for old, new in perm.items():
        inv[new] = old
    nodes = {}
    for old, node in net.nodes.items():
        new = perm[old]
        nodes[new] = Node(new, node.stage, node.capacity, node.compute_cost,
                          is_data=node.is_data, alive=node.alive,
                          location=node.location)
    return FlowNetwork(nodes=nodes, num_stages=net.num_stages,
                       latency=net.latency[np.ix_(inv, inv)].copy(),
                       bandwidth=net.bandwidth[np.ix_(inv, inv)].copy(),
                       activation_size=net.activation_size,
                       codec_menu=net.codec_menu,
                       fidelity_budget=net.fidelity_budget,
                       fidelity_weight=net.fidelity_weight)


def check_permutation_invariance(spec: ScenarioSpec) -> Dict[str, Any]:
    """Relabeling node ids (data nodes fixed, relays permuted) must not
    change the centralized optimum."""
    net, cm = generate.build_network(spec)
    base = generate.solve_optimal(spec, "dense", net=net, cost_matrix=cm)
    n = net.latency.shape[0]
    relay_ids = [nid for nid, node in net.nodes.items() if not node.is_data]
    shuffled = list(relay_ids)
    rng = np.random.default_rng([spec.seed, 17])
    rng.shuffle(shuffled)
    perm = {nid: nid for nid in net.nodes}
    perm.update(dict(zip(relay_ids, shuffled)))
    pnet = permuted_network(net, perm)
    pcm = None
    if cm is not None:
        inv = np.empty(n, np.int64)
        for old, new in perm.items():
            inv[new] = old
        pcm = np.asarray(cm)[np.ix_(inv, inv)].copy()
    from repro_torch.core.flow.mincost import solve_training_flow
    permuted = solve_training_flow(pnet, cost_matrix=pcm, method="dense")
    _require(permuted.flow == base.flow, spec, "permutation-invariance",
             f"optimal flow changed under relabeling "
             f"({base.flow} -> {permuted.flow})")
    exact = spec.topology == "synthetic"
    tol = 0.0 if exact else 1e-9 * max(1.0, abs(base.cost))
    _require(abs(permuted.cost - base.cost) <= tol, spec,
             "permutation-invariance",
             f"optimal cost changed under relabeling "
             f"({base.cost!r} -> {permuted.cost!r})")
    return {"flow": base.flow, "cost": base.cost}


#: committed hierarchical-vs-oracle optimality-gap bound.  The same
#: bound gates `benchmarks/bench_scale.py --smoke` and is recorded in
#: BENCH_scale.json meta (``hier_gap_bound``); measured gaps on the
#: bench topology sit at 1.03-1.10.
HIER_GAP_BOUND = 1.15


def check_hierarchy_gap(spec: ScenarioSpec,
                        gap_bound: float = HIER_GAP_BOUND) -> Dict[str, Any]:
    """`solve_hierarchical` produces a *feasible* plan (stage-ordered
    closed chains, relay and source capacities respected) whose total
    cost is within the committed gap bound of the flat dial MCMF
    oracle routing the same flow volume.  Geo-abstract topologies only
    — the gap bound is calibrated for per-location-pair base costs
    plus bounded node jitter, not arbitrary cost structure."""
    from repro_torch.core.flow.hierarchy import solve_hierarchical

    net, cm = generate.build_network(spec)
    h = solve_hierarchical(net, cost_matrix=cm)
    S = net.num_stages
    used: Dict[int, int] = {}
    for path in h.paths:
        _require(len(path) == S + 2, spec, "hierarchy-gap",
                 f"chain has {len(path)} hops, expected {S + 2}")
        _require(path[0] == path[-1] and net.nodes[path[0]].is_data,
                 spec, "hierarchy-gap",
                 f"chain does not close at a data node: {path[0]} ... "
                 f"{path[-1]}")
        for hop in path[:-1]:      # origin once per chain + each relay
            used[hop] = used.get(hop, 0) + 1
        for s, nid in enumerate(path[1:-1]):
            node = net.nodes[nid]
            _require(not node.is_data and node.alive and node.stage == s,
                     spec, "hierarchy-gap",
                     f"hop {nid} at position {s} is not an alive "
                     f"stage-{s} relay")
    for nid, cnt in used.items():
        _require(cnt <= net.nodes[nid].capacity, spec, "hierarchy-gap",
                 f"node {nid} carries {cnt} chains over capacity "
                 f"{net.nodes[nid].capacity}")
    net2, cm2 = generate.build_network(spec)
    flat = generate.solve_optimal(spec, "dial", net=net2, cost_matrix=cm2,
                                  max_flow=h.flow)
    _require(flat.flow == h.flow, spec, "hierarchy-gap",
             f"flat oracle routed {flat.flow} units vs hierarchical "
             f"{h.flow}")
    gap = None
    if flat.cost > 0:
        gap = h.cost / flat.cost
        _require(gap <= gap_bound, spec, "hierarchy-gap",
                 f"optimality gap {gap:.4f} exceeds committed bound "
                 f"{gap_bound} (hier {h.cost!r} vs oracle {flat.cost!r})")
    return {"flow": h.flow, "hier_cost": h.cost, "oracle_cost": flat.cost,
            "gap": gap, "regions": h.num_regions}


def check_sim_invariants(spec: ScenarioSpec,
                         iterations: Optional[int] = None) -> Dict[str, Any]:
    """Cheap engine-level invariants that hold under *any* churn
    program — this is the fuzz check that actually samples the spec's
    churn clauses through the full event engine: conservation
    (completed <= launched), non-negative accounting, no event-budget
    runaway, and bit-determinism of a seeded rerun."""
    from repro_torch.core.sim.metrics import summarize

    its = min(iterations if iterations is not None else spec.iterations, 3)
    first = generate.run_sim(spec, iterations=its)
    for i, m in enumerate(first):
        _require(0 <= m.completed <= m.launched, spec, "sim-invariants",
                 f"iteration {i}: completed {m.completed} out of "
                 f"[0, launched={m.launched}]")
        _require(m.wasted_gpu >= 0.0 and m.comm_time >= 0.0
                 and m.duration >= 0.0, spec, "sim-invariants",
                 f"iteration {i}: negative accounting "
                 f"(wasted={m.wasted_gpu}, comm={m.comm_time}, "
                 f"duration={m.duration})")
        _require(m.reroutes >= 0 and m.queue_depth_peak >= 0, spec,
                 "sim-invariants",
                 f"iteration {i}: negative reroute/queue accounting")
        _require(not m.truncated, spec, "sim-invariants",
                 f"iteration {i}: event budget exhausted on a tiny "
                 f"scenario (runaway event loop)")
    second = generate.run_sim(spec, iterations=its)
    _require(summarize(first) == summarize(second), spec, "sim-invariants",
             "seeded rerun diverged — simulator lost determinism")
    return {"iterations": its,
            "completed": [m.completed for m in first]}


def check_codec_agreement(spec: ScenarioSpec,
                          iterations: Optional[int] = None,
                          device="cuda") -> Dict[str, Any]:
    """Compression clauses price consistently across every layer.

    * fp32-menu oracle: a spec whose menu is ``["fp32"]`` produces flows,
      total cost, annealing temperature, RNG stream and simulator
      summary *bit-identical* to the same spec with no compression
      clause at all (the codec machinery has a zero-cost off switch);
    * flow layer: every codec the protocol records per flow edge is on
      the spec's menu, admissible under the budget, and is the true
      per-edge price argmin (re-derived scalar-wise from the raw
      latency/bandwidth matrices, first-min tie-breaking);
    * sim layer: the chosen-codec histogram only names admissible
      codecs and ``bytes_on_wire`` equals the histogram folded against
      the codec ratios at the profile's activation size;
    * runtime layer: the per-boundary wire codecs the trainer applied
      are the modal choice over its planned chains in the *same*
      codec-choice matrix the flow layer exposes, and a non-trivial
      wire moves a positive number of encoded bytes.
    """
    from repro_torch.core.flow.graph import WIRE_CODECS
    from repro_torch.core.sim.metrics import summarize

    check = "codec-agreement"
    if spec.compression is None:
        raise ValueError(f"{spec.name}: check_codec_agreement needs a "
                         f"compression clause")

    # ---- fp32-menu oracle vs no clause at all -------------------------
    base = spec.replace(compression=None)
    fp32 = spec.replace(compression={"menu": ["fp32"]})
    rb = generate.run_flow(base)
    rf = generate.run_flow(fp32)
    _require(rf.flows == rb.flows and rf.total_cost == rb.total_cost,
             spec, check,
             f"fp32-only menu perturbed the flow outcome "
             f"({len(rf.flows)} chains / {rf.total_cost!r} vs "
             f"{len(rb.flows)} / {rb.total_cost!r})")
    _require(rf.temperature == rb.temperature
             and rf.rng_state == rb.rng_state, spec, check,
             "fp32-only menu perturbed the annealing/RNG stream")
    _require(summarize(generate.run_sim(fp32))
             == summarize(generate.run_sim(base)), spec, check,
             "fp32-only menu perturbed the simulator summary")

    # ---- flow layer: per-edge argmin ----------------------------------
    flow = generate.run_flow(spec)
    net = flow.net
    names = net.wire_codec_names()
    adm = net.admissible_codecs()
    budget = float(spec.compression.get("fidelity_budget", 0.0))
    menu = set(spec.compression["menu"])
    lat_avg = 0.5 * (net.latency + net.latency.T)
    bw_sum = net.bandwidth + net.bandwidth.T
    fw, size = net.fidelity_weight, net.activation_size
    hist: Dict[str, int] = {}
    for chain, chain_codecs in zip(flow.flows,
                                   flow.protocol.flow_codecs()):
        for (a, b), cname in zip(zip(chain, chain[1:]), chain_codecs):
            _require(cname in menu, spec, check,
                     f"edge ({a},{b}) chose {cname!r}, not on the menu")
            _require(cname == "fp32"
                     or WIRE_CODECS[cname].fidelity_penalty <= budget,
                     spec, check,
                     f"edge ({a},{b}) chose {cname!r} over the fidelity "
                     f"budget {budget}")
            prices = [lat_avg[a, b] + 2.0 * (c.ratio * size) / bw_sum[a, b]
                      + c.coder_rate * size + fw * c.fidelity_penalty
                      for c in adm]
            want = names[int(np.argmin(prices))]   # first-min, like argmin
            _require(cname == want, spec, check,
                     f"edge ({a},{b}) chose {cname!r} but the price "
                     f"argmin is {want!r}")
            hist[cname] = hist.get(cname, 0) + 1

    # ---- sim layer: histogram + bytes accounting ----------------------
    its = min(iterations if iterations is not None else spec.iterations, 3)
    sim = generate.build_sim(spec)
    act = sim.profile.activation_bytes
    ratio = {c.name: c.ratio for c in adm}
    for i, m in enumerate(sim.run(its)):
        legs = m.codec_legs or {}
        _require(set(legs) <= set(names), spec, check,
                 f"iteration {i}: sim histogram names inadmissible "
                 f"codecs {sorted(set(legs) - set(names))}")
        if legs:
            expect = sum(cnt * ratio[n] * act for n, cnt in legs.items())
            _require(abs(m.bytes_on_wire - expect)
                     <= 1e-6 * max(1.0, expect), spec, check,
                     f"iteration {i}: bytes_on_wire {m.bytes_on_wire!r} "
                     f"!= histogram fold {expect!r}")

    # ---- runtime layer: modal per-boundary choice ---------------------
    trainer, batches = generate.build_runtime(spec, device=device)
    r = trainer.iteration(batches)
    rt_names = list(r.wire_codecs)
    _require(all(n in menu for n in rt_names), spec, check,
             f"runtime applied off-menu codecs {rt_names}")
    tnet = trainer.net
    choice = tnet.wire_codec_matrix()
    tmenu = tnet.wire_codec_names()
    S = tnet.num_stages
    expected: List[str] = []
    for s in range(S - 1):
        votes: Dict[int, int] = {}
        for chain in trainer.last_chains:
            k = int(choice[chain[s + 1], chain[s + 2]])
            votes[k] = votes.get(k, 0) + 1
        expected.append(tmenu[min(votes, key=lambda k: (-votes[k], k))]
                        if votes else "fp32")
    if all(n == "fp32" for n in expected):
        expected = []
    _require(rt_names == expected, spec, check,
             f"runtime wire codecs {rt_names} != modal planner choice "
             f"{expected}")
    _require((r.wire_bytes > 0) == bool(rt_names), spec, check,
             f"runtime wire bytes {r.wire_bytes} inconsistent with "
             f"codecs {rt_names}")
    return {"flow_codec_hist": hist, "runtime_codecs": rt_names,
            "runtime_wire_bytes": r.wire_bytes}


# ---------------------------------------------------------------------------
# Serving plane: invariants + the sim<->runtime serving differential
# ---------------------------------------------------------------------------

def check_serving_invariants(spec: ScenarioSpec,
                             iterations: Optional[int] = None
                             ) -> Dict[str, Any]:
    """Numpy-only serving invariants (the serve-fuzz loop's check).

    * exact request conservation after every iteration:
      ``sum(admitted) == sum(completed) + sum(dropped) + in_flight``;
    * every admitted arrival is accounted for (admissions equal the
      compiled arrival program's request count);
    * latency sanity: TTFT/TPOT non-negative, first token after
      arrival, completion after first token;
    * seeded-rerun determinism: a second engine on the same spec
      reproduces the summary row and the chain plans exactly;
    * KV-residency triviality: with ``kv_weight == 0`` the network's
      residency state must never materialize (the serving-free
      bit-identity guarantee).
    """
    from repro_torch.core.sim.metrics import summarize_serving

    check = "serving-invariants"
    its = iterations if iterations is not None else spec.iterations
    eng = generate.build_serving_sim(spec)
    ms = eng.run(its)
    cum_adm = cum_done = cum_drop = 0
    for i, m in enumerate(ms):
        cum_adm += m.admitted
        cum_done += m.completed
        cum_drop += m.dropped
        _require(cum_adm == cum_done + cum_drop + m.in_flight, spec, check,
                 f"iteration {i}: conservation violated ({cum_adm} != "
                 f"{cum_done} + {cum_drop} + {m.in_flight})")
        _require(m.queued <= m.in_flight, spec, check,
                 f"iteration {i}: queued {m.queued} > in_flight "
                 f"{m.in_flight}")
        _require(all(t >= 0.0 for t in m.ttfts)
                 and all(t >= 0.0 for t in m.tpots), spec, check,
                 f"iteration {i}: negative TTFT/TPOT")
    expected = sum(len(p) for p in generate.compile_arrivals(spec)[:its])
    _require(cum_adm == expected, spec, check,
             f"admissions {cum_adm} != compiled arrivals {expected}")
    for rid, rec in eng.requests.items():
        if rec.first_token is not None:
            _require(rec.first_token >= rec.arrival, spec, check,
                     f"request {rid}: first token before arrival")
        if rec.completion is not None:
            _require(rec.first_token is not None
                     and rec.completion >= rec.first_token, spec, check,
                     f"request {rid}: completion before first token")
    eng2 = generate.build_serving_sim(spec)
    ms2 = eng2.run(its)
    _require(summarize_serving(ms) == summarize_serving(ms2), spec, check,
             "seeded rerun changed the serving summary")
    _require(eng.chain_plans == eng2.chain_plans, spec, check,
             "seeded rerun changed the serving chain plans")
    if spec.kv_weight == 0.0:
        _require(not eng.net.kv_active(), spec, check,
                 "kv_weight == 0 but residency state materialized on "
                 "the network")
    return {"iterations": its, "admitted": cum_adm,
            "completed": cum_done, "dropped": cum_drop,
            "summary": summarize_serving(ms)}


def check_serving_consistency(spec: ScenarioSpec,
                              iterations: Optional[int] = None,
                              device="cuda") -> Dict[str, Any]:
    """The serving simulator and the real-compute decode executor,
    driven by the same spec, must agree *exactly*.

    * identical per-iteration planned chain sets (both the recorded
      ``policy.plan()`` output and the engines' deduplicated serving
      chains) — decode requests ride the same flow plans on both
      layers;
    * bit-identical per-iteration serving ledgers and TTFT/TPOT lists
      (the executor adds no timing of its own, so any divergence is a
      scheduling bug);
    * identical fault timelines (serving crashes recorded verbatim);
    * every request the engine marks completed holds a full
      ``gen_tokens`` decoded stream in the executor;
    * zero-churn specs: the executor's token streams are bit-identical
      to the standalone ``launch/serve.py``-style sequential decode on
      the same reduced config and seed (text architectures).
    """
    from repro_torch.core.sim.metrics import summarize_serving

    check = "serving-consistency"
    its = iterations if iterations is not None else spec.iterations

    sim_rec: Dict[str, RecordingPolicy] = {}

    def wrap_sim(p):
        sim_rec["p"] = RecordingPolicy(p)
        return sim_rec["p"]

    eng = generate.build_serving_sim(spec, policy_wrapper=wrap_sim)
    sim_ms = eng.run(its)

    rt_rec: Dict[str, RecordingPolicy] = {}

    def wrap_rt(p):
        rt_rec["p"] = RecordingPolicy(p)
        return rt_rec["p"]

    tr = generate.build_serving_runtime(spec, policy_wrapper=wrap_rt,
                                        device=device)
    rt_ms = tr.run(its)

    if spec.scheduler == "gwtf":
        for i, (a, b) in enumerate(zip(sim_rec["p"].plans,
                                       rt_rec["p"].plans)):
            _require(a == b, spec, check,
                     f"iteration {i}: planned chain sets diverged "
                     f"(sim {len(a)} vs runtime {len(b)})")
        _require(eng.chain_plans == tr.engine.chain_plans, spec, check,
                 "serving chain plans diverged between layers")
    for i, (a, b) in enumerate(zip(sim_ms, rt_ms)):
        _require(a == b, spec, check,
                 f"iteration {i}: serving ledgers diverged "
                 f"(sim {a} vs runtime {b})")
    _require(summarize_serving(sim_ms) == summarize_serving(rt_ms), spec,
             check, "serving summaries diverged")
    _require(eng.timeline.records == tr.engine.timeline.records, spec,
             check, "serving fault timelines diverged")
    for rid, rec in tr.engine.requests.items():
        if rec.completion is not None:
            got = len(tr.token_stream(rid))
            _require(got == spec.gen_tokens, spec, check,
                     f"request {rid}: completed with {got} of "
                     f"{spec.gen_tokens} tokens decoded")
    streams_checked = 0
    if not spec.churn:
        done = sorted(rid for rid, rec in tr.engine.requests.items()
                      if rec.completion is not None
                      and rid < tr.max_requests)[:2]
        for rid, toks in _standalone_streams(spec, tr.max_requests, done,
                                             device).items():
            _require(toks == tr.token_stream(rid), spec, check,
                     f"request {rid}: zero-churn stream diverged from "
                     f"the standalone decode path")
            streams_checked += 1
    return {"iterations": its, "summary": summarize_serving(sim_ms),
            "prefill_calls": tr.prefill_calls,
            "decode_dispatches": tr.decode_dispatches,
            "stacked_rows": tr.stacked_rows,
            "replay_steps": tr.replay_steps,
            "streams_checked": streams_checked}


@torch.inference_mode()
def _standalone_streams(spec: ScenarioSpec, batch: int, rids: List[int],
                        device) -> Dict[int, List[int]]:
    """Greedy streams of requests ``rids`` decoded one at a time, as
    ``launch/serve.py`` decodes: the model and prompts `serving_inputs`
    draws for the spec, a batch-1 prefill, then ``gen_tokens - 1``
    ``decode_step`` calls on a cache each call writes in place."""
    from repro_torch.core.runtime.serving import serving_inputs
    from repro_torch.models.transformer import (decode_step, init_cache,
                                                prefill)

    cfg = generate.model_config(spec)
    params, prompt, _ = serving_inputs(cfg, seed=spec.seed, batch=batch,
                                       prompt_len=spec.prompt_len,
                                       device=device)
    streams: Dict[int, List[int]] = {}
    for rid in rids:
        cache = init_cache(cfg, 1, spec.prompt_len + spec.gen_tokens,
                           dtype=torch.float32, device=prompt.device)
        logits, cache = prefill(params, cfg, tokens=prompt[rid:rid + 1],
                                cache=cache)
        toks = [int(logits.argmax(-1)[0])]
        for j in range(spec.gen_tokens - 1):
            tok = torch.tensor([[toks[-1]]], dtype=torch.long,
                               device=prompt.device)
            logits, cache = decode_step(params, cfg, tokens=tok, cache=cache,
                                        index=spec.prompt_len + j)
            toks.append(int(logits.argmax(-1)[0]))
        streams[rid] = toks
    return streams


# ---------------------------------------------------------------------------
# Check registry / corpus sweep
# ---------------------------------------------------------------------------

#: name -> (callable, applicability predicate)
CHECKS: Dict[str, Tuple[Callable[[ScenarioSpec], Dict], Callable]] = {
    "flow-equivalence": (check_flow_equivalence, lambda s: True),
    "optimal-consistency": (check_optimal_consistency, lambda s: True),
    "capacity-monotonicity": (check_capacity_monotonicity, lambda s: True),
    "permutation-invariance": (check_permutation_invariance,
                               lambda s: True),
    "zero-churn": (check_zero_churn, lambda s: not s.churn),
    "sim-invariants": (check_sim_invariants, lambda s: True),
    "sim-runtime": (check_sim_runtime_consistency,
                    lambda s: s.scheduler == "gwtf"),
    "fault-timeline": (check_fault_timeline,
                       lambda s: (s.scheduler == "gwtf"
                                  and s.deterministic_churn
                                  and bool(_adversarial_kinds(s)))),
    "detection-precision-recall": (
        check_detection_precision_recall,
        lambda s: (s.scheduler == "gwtf" and s.deterministic_churn
                   and all(c["kind"] in ADVERSARIAL_CLAUSES
                           for c in s.churn)
                   and any(c["kind"] == "corrupt_gradient"
                           and c.get("mode", "perturb") in ("perturb",
                                                            "zero")
                           for c in s.churn)
                   and not any(c["kind"] == "corrupt_gradient"
                               and c.get("mode", "perturb") not in
                               ("perturb", "zero")
                               for c in s.churn))),
    "hierarchy-gap": (check_hierarchy_gap,
                      lambda s: s.topology == "geo-abstract"),
    "codec-agreement": (check_codec_agreement,
                        lambda s: s.compression is not None),
    "serving-invariants": (check_serving_invariants,
                           lambda s: s.has_arrivals),
    "serving-consistency": (check_serving_consistency,
                            lambda s: (s.has_arrivals
                                       and s.scheduler == "gwtf")),
}

#: checks cheap enough for the fuzz loop (no real JAX compute).
#: sim-invariants is what exercises the generated churn programs — the
#: flow/oracle checks never sample them.
FUZZ_CHECKS = ("flow-equivalence", "optimal-consistency",
               "capacity-monotonicity", "permutation-invariance",
               "sim-invariants")

#: checks for the randomized scale-tier fuzz loop (1000+ relays):
#: everything quadratic-in-nodes or running the frozen reference
#: engine is out; the event engine + hierarchical planner are in.
SCALE_FUZZ_CHECKS = ("sim-invariants", "hierarchy-gap")


def scale_checks(spec: ScenarioSpec) -> Tuple[str, ...]:
    """The check set a ``tier="scale"`` corpus spec is swept with.

    The engine-vs-reference bit-equality differential (including its
    crash→repair→rejoin episode) runs only up to ~600 nodes — the
    frozen reference engine is O(N²) per round and exists to be an
    oracle, not to scale.  `sim-invariants` (full event engine +
    planner under the spec's churn program, determinism via seeded
    rerun) runs everywhere; `hierarchy-gap` wherever the hierarchical
    planner applies.  The real-compute `sim-runtime` differential is
    never part of the scale tier."""
    names: List[str] = []
    if spec.base_nodes <= 600:
        names.append("flow-equivalence")
    names.append("sim-invariants")
    if spec.topology == "geo-abstract":
        names.append("hierarchy-gap")
    return tuple(names)


#: the checks that run real compute: `run_checks` gives them its ``device``
REAL_COMPUTE = ("zero-churn", "sim-runtime", "fault-timeline",
                "detection-precision-recall", "codec-agreement",
                "serving-consistency")


def run_checks(spec: ScenarioSpec,
               checks: Optional[Sequence[str]] = None,
               device="cuda") -> Dict[str, Any]:
    """Run the named (or all applicable) checks; raises on the first
    discrepancy, returns per-check summaries otherwise.  The real-compute
    checks run on ``device``."""
    names = checks if checks is not None else list(CHECKS)
    out: Dict[str, Any] = {}
    for name in names:
        fn, applicable = CHECKS[name]
        if not applicable(spec):
            out[name] = {"skipped": True}
            continue
        kw = {"device": device} if name in REAL_COMPUTE else {}
        out[name] = fn(spec, **kw)
    return out


# ---------------------------------------------------------------------------
# Fuzzing with shrinking
# ---------------------------------------------------------------------------

def random_spec(rng: np.random.Generator, index: int) -> ScenarioSpec:
    """One random small scenario (kept tiny: the fuzz loop's value is
    breadth of shapes, not node count)."""
    topology = "geo" if rng.uniform() < 0.5 else "synthetic"
    num_stages = int(rng.integers(2, 5))
    spec = ScenarioSpec(
        name=f"fuzz-{index}",
        seed=int(rng.integers(0, 2 ** 16)),
        topology=topology,
        num_stages=num_stages,
        relays_per_stage=int(rng.integers(2, 5)),
        num_data_nodes=int(rng.integers(1, 3)),
        data_capacity=int(rng.integers(2, 5)),
        capacity_range=(1, int(rng.integers(2, 5))),
        cost_range=(1, int(rng.integers(3, 21))),
        source_capacity=int(rng.integers(2, 5)),
        num_locations=int(rng.integers(2, 11)),
        compute_jitter=float(rng.uniform(0.0, 0.4)),
        iterations=2,
        objective="sum" if rng.uniform() < 0.5 else "minmax",
    )
    clauses: List[Dict[str, Any]] = []
    if topology == "geo" and rng.uniform() < 0.5:
        clauses.append({"kind": "regional_blackout",
                        "location": int(rng.integers(0, spec.num_locations)),
                        "at_iteration": 0,
                        "duration": 1,
                        "when": float(rng.uniform(0.1, 0.9))})
    if rng.uniform() < 0.5:
        clauses.append({"kind": "bernoulli",
                        "p": float(rng.uniform(0.0, 0.3))})
    if topology == "geo" and rng.uniform() < 0.3:
        clauses.append({"kind": "link_degradation", "at_iteration": 0,
                        "factor": float(rng.uniform(1.5, 8.0)),
                        "duration": 1})
    spec = spec.replace(churn=clauses)
    if topology == "geo" and rng.uniform() < 0.3:
        spare = int(rng.integers(1, 4))
        spec = spec.replace(spare_nodes=spare, churn=spec.churn + [
            {"kind": "flash_crowd", "at_iteration": 1, "nodes": spare}])
    if topology == "geo" and rng.uniform() < 0.3:
        # a random codec-menu prefix under a random budget: exercises
        # codec-aware pricing through flow-equivalence + sim-invariants
        # (check_codec_agreement itself stays out of the fuzz set — its
        # runtime leg runs real JAX compute)
        menu = ["fp32", "bf16", "int8", "top-k"]
        spec = spec.replace(compression={
            "menu": menu[:int(rng.integers(2, 5))],
            "fidelity_budget": float(rng.choice([0.004, 0.02, 0.1])),
            "fidelity_weight": float(rng.uniform(0.1, 2.0))})
    return spec


#: checks for the adversarial fuzz loop: `sim-invariants` pushes the
#: sampled straggler/corrupt/flaky programs through the full event
#: engine (deadline checks, hedged re-dispatch, modelled screen,
#: reputation) including the seeded-rerun determinism gate.  The
#: real-compute cross-layer checks stay out — they run JAX per case.
ADVERSARIAL_FUZZ_CHECKS = ("sim-invariants",)


def random_adversarial_spec(rng: np.random.Generator,
                            index: int) -> ScenarioSpec:
    """One random small scenario whose churn program samples the
    beyond-fail-stop fault classes (optionally mixed with crashes)."""
    topology = "geo" if rng.uniform() < 0.5 else "synthetic"
    spec = ScenarioSpec(
        name=f"adv-fuzz-{index}",
        seed=int(rng.integers(0, 2 ** 16)),
        topology=topology,
        num_stages=int(rng.integers(2, 4)),
        relays_per_stage=int(rng.integers(2, 5)),
        num_data_nodes=1,
        data_capacity=int(rng.integers(2, 5)),
        capacity_range=(1, int(rng.integers(2, 5))),
        iterations=2,
        objective="sum" if rng.uniform() < 0.5 else "minmax",
    )
    first_relay = spec.num_data_nodes
    relays = list(range(first_relay, first_relay + spec.num_relays))
    clauses: List[Dict[str, Any]] = []
    if rng.uniform() < 0.7:
        k = int(rng.integers(1, max(2, len(relays) // 3)))
        nodes = sorted(int(n) for n in
                       rng.choice(relays, size=k, replace=False))
        clauses.append({"kind": "straggler", "nodes": nodes,
                        "factor": float(rng.uniform(1.5, 30.0)),
                        "hang": bool(rng.uniform() < 0.4),
                        "at_iteration": int(rng.integers(0, 2)),
                        "duration": int(rng.integers(0, 3))})
    if rng.uniform() < 0.6:
        k = int(rng.integers(1, max(2, len(relays) // 4)))
        nodes = sorted(int(n) for n in
                       rng.choice(relays, size=k, replace=False))
        clauses.append({"kind": "corrupt_gradient", "nodes": nodes,
                        "mode": ["perturb", "zero",
                                 "sign_flip"][int(rng.integers(0, 3))],
                        "scale": float(rng.uniform(0.5, 4.0)),
                        "seed": int(rng.integers(0, 2 ** 16)),
                        "at_iteration": int(rng.integers(0, 2)),
                        "duration": int(rng.integers(0, 3))})
    if rng.uniform() < 0.5:
        clauses.append({"kind": "flaky_link",
                        "p": float(rng.uniform(0.0, 0.4)),
                        "seed": int(rng.integers(0, 2 ** 16))})
    if rng.uniform() < 0.3:
        clauses.append({"kind": "bernoulli",
                        "p": float(rng.uniform(0.0, 0.2))})
    if not clauses:
        clauses.append({"kind": "flaky_link", "p": 0.2,
                        "seed": int(rng.integers(0, 2 ** 16))})
    return spec.replace(churn=clauses)


#: checks for the serving fuzz loop: `serving-invariants` pushes the
#: sampled arrival programs + churn through the ServingEngine
#: (conservation, latency sanity, seeded-rerun determinism) without
#: real compute.  `serving-consistency` stays out — it decodes real
#: tokens per case.
SERVE_FUZZ_CHECKS = ("serving-invariants",)


def random_serving_spec(rng: np.random.Generator,
                        index: int) -> ScenarioSpec:
    """One random small serving scenario: an arrival program (always at
    least a Poisson clause, optionally spike/diurnal), a decode shape,
    sometimes KV-residency pricing, sometimes churn hitting mid-run."""
    topology = "geo" if rng.uniform() < 0.6 else "synthetic"
    spec = ScenarioSpec(
        name=f"serve-fuzz-{index}",
        seed=int(rng.integers(0, 2 ** 16)),
        topology=topology,
        num_stages=int(rng.integers(2, 4)),
        relays_per_stage=int(rng.integers(2, 5)),
        num_data_nodes=1,
        data_capacity=int(rng.integers(2, 5)),
        iterations=2,
        prompt_len=int(rng.integers(4, 17)),
        gen_tokens=int(rng.integers(2, 33)),
        serve_batch=int(rng.integers(1, 5)),
        kv_weight=float(rng.choice([0.0, 0.0, 0.5, 2.0])),
    )
    arrivals: List[Dict[str, Any]] = [
        {"kind": "poisson", "rate": float(rng.uniform(0.5, 4.0)),
         "seed": int(rng.integers(0, 2 ** 16))}]
    if rng.uniform() < 0.4:
        arrivals.append({"kind": "spike",
                         "at_iteration": int(rng.integers(0, 2)),
                         "requests": int(rng.integers(1, 9)),
                         "when": float(rng.uniform(0.05, 1.0))})
    if rng.uniform() < 0.3:
        arrivals.append({"kind": "diurnal",
                         "rate": float(rng.uniform(1.0, 4.0)),
                         "period": int(rng.integers(1, 5)),
                         "low_scale": float(rng.uniform(0.0, 1.0)),
                         "seed": int(rng.integers(0, 2 ** 16))})
    clauses: List[Dict[str, Any]] = []
    if rng.uniform() < 0.6:
        clauses.append({"kind": "bernoulli",
                        "p": float(rng.uniform(0.0, 0.3))})
    if rng.uniform() < 0.3:
        relay = int(rng.integers(spec.num_data_nodes,
                                 spec.num_data_nodes + spec.num_relays))
        clauses.append({"kind": "trace", "events": [
            (int(rng.integers(0, 2)), "crash", relay,
             float(rng.uniform(0.1, 0.9)))]})
    return spec.replace(arrivals=arrivals, churn=clauses)


def random_scale_spec(rng: np.random.Generator, index: int) -> ScenarioSpec:
    """One random *internet-scale* scenario (1000+ relays, mostly
    geo-abstract) for the scale-tier fuzz loop.  Cost ranges stay in
    the bench_scale regime (per-location-pair base + bounded node
    jitter) — that is the structure the hierarchical planner's gap
    bound is calibrated for."""
    topology = "geo-abstract" if rng.uniform() < 0.75 else "synthetic"
    num_stages = int(rng.choice([5, 8, 10]))
    relays_per_stage = int(rng.integers(1000, 1801)) // num_stages
    num_data_nodes = int(rng.integers(1, 3))
    relays = num_stages * relays_per_stage
    spec = ScenarioSpec(
        name=f"scale-fuzz-{index}",
        seed=int(rng.integers(0, 2 ** 16)),
        tier="scale",
        topology=topology,
        num_stages=num_stages,
        relays_per_stage=relays_per_stage,
        num_data_nodes=num_data_nodes,
        data_capacity=4,
        capacity_range=(1, int(rng.integers(3, 5))),
        cost_range=(int(rng.integers(3, 6)), int(rng.integers(18, 25))),
        source_capacity=max(4, relays // (20 * num_data_nodes)),
        num_locations=int(rng.integers(8, 13)),
        iterations=2,
        objective="sum",
    )
    clauses: List[Dict[str, Any]] = []
    if rng.uniform() < 0.6:
        clauses.append({"kind": "bernoulli",
                        "p": float(rng.uniform(0.0, 0.2))})
    if topology == "geo-abstract" and rng.uniform() < 0.4:
        clauses.append({"kind": "regional_blackout",
                        "location": int(rng.integers(0, spec.num_locations)),
                        "at_iteration": 0, "duration": 1,
                        "when": float(rng.uniform(0.1, 0.9))})
    return spec.replace(churn=clauses)


def _fails(spec: ScenarioSpec, checks: Sequence[str]
           ) -> Optional[ScenarioDiscrepancy]:
    try:
        run_checks(spec, checks)
        return None
    except ScenarioDiscrepancy as e:
        return e
    except Exception as e:                       # noqa: BLE001
        # a crash-class bug (IndexError deep in an engine, a numerical
        # blow-up in the oracle, ...) is exactly what differential
        # fuzzing is for: wrap it so the shrink+commit pipeline runs on
        # it instead of aborting the session with a spec-less traceback
        return ScenarioDiscrepancy(
            spec, f"crash:{type(e).__name__}", repr(e))


_SHRINK_PASSES: Tuple[Tuple[str, Callable[[ScenarioSpec], Dict]], ...] = (
    ("drop-compression", lambda s: {"compression": None}),
    ("drop-arrivals", lambda s: {"arrivals": s.arrivals[:-1]}),
    ("fewer-gen-tokens", lambda s: {"gen_tokens":
                                    max(1, s.gen_tokens // 2)}),
    ("drop-adversarial", lambda s: {
        "churn": [c for c in s.churn
                  if c["kind"] not in ADVERSARIAL_CLAUSES]}),
    ("drop-churn", lambda s: {"churn": s.churn[:-1],
                              "spare_nodes": 0
                              if not any(c["kind"] == "flash_crowd"
                                         for c in s.churn[:-1])
                              else s.spare_nodes}),
    ("fewer-relays", lambda s: {"relays_per_stage": s.relays_per_stage - 1}),
    ("fewer-stages", lambda s: {"num_stages": s.num_stages - 1}),
    ("one-source", lambda s: {"num_data_nodes": 1}),
    ("no-jitter", lambda s: {"compute_jitter": 0.0}),
    ("tight-caps", lambda s: {"capacity_range": (1, 2)}),
    ("tight-costs", lambda s: {"cost_range": (1, 3)}),
    ("fewer-iterations", lambda s: {"iterations": 1}),
)


def minimize(spec: ScenarioSpec, checks: Sequence[str],
             max_attempts: int = 64) -> ScenarioSpec:
    """Greedy shrink: repeatedly try simplifying edits, keeping any
    that still reproduce a discrepancy.  Deterministic (no RNG)."""
    current = spec
    attempts = 0
    improved = True
    while improved and attempts < max_attempts:
        improved = False
        for tag, edit in _SHRINK_PASSES:
            attempts += 1
            if attempts >= max_attempts:
                break
            try:
                candidate = current.replace(**edit(current))
            except (ValueError, TypeError):
                continue                     # edit made the spec invalid
            if candidate == current:
                continue
            if _fails(candidate, checks) is not None:
                current = candidate
                improved = True
    return current


@dataclass
class FuzzFailure:
    spec: ScenarioSpec
    minimized: ScenarioSpec
    check: str
    detail: str
    written_to: Optional[str] = None


@dataclass
class FuzzReport:
    seed: int
    budget_seconds: float
    cases: int = 0
    elapsed: float = 0.0
    failures: List[FuzzFailure] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures


def fuzz(seed: int = 0, budget_seconds: float = 10.0,
         corpus_dir: Optional[str] = None,
         checks: Sequence[str] = FUZZ_CHECKS,
         max_cases: Optional[int] = None,
         spec_factory: Callable[[np.random.Generator, int],
                                ScenarioSpec] = random_spec,
         shrink: bool = True) -> FuzzReport:
    """Seeded randomized differential testing under a wall-clock budget.

    Each failing case is shrunk with `minimize` and (when
    ``corpus_dir`` is given — defaulting it to the committed corpus
    directory is the caller's choice) written as
    ``shrunk-<check>-<seed>.json`` so it permanently joins the corpus.

    ``spec_factory`` picks the sampling regime: `random_spec` (tiny
    shapes, the default) or `random_scale_spec` (1000+ relays swept
    with `SCALE_FUZZ_CHECKS`).  Pass ``shrink=False`` at scale —
    `minimize` steps one relay at a time, which is useless against
    thousand-relay specs; the unshrunk reproducer is still committed.
    """
    rng = np.random.default_rng(seed)
    report = FuzzReport(seed=seed, budget_seconds=budget_seconds)
    t0 = time.monotonic()
    while time.monotonic() - t0 < budget_seconds:
        if max_cases is not None and report.cases >= max_cases:
            break
        spec = spec_factory(rng, report.cases)
        report.cases += 1
        err = _fails(spec, checks)
        if err is None:
            continue
        small = minimize(spec, checks) if shrink else spec
        small_err = _fails(small, checks) or err
        failure = FuzzFailure(spec=spec, minimized=small,
                              check=small_err.check,
                              detail=small_err.detail)
        if corpus_dir:
            os.makedirs(corpus_dir, exist_ok=True)
            named = small.replace(
                name=f"shrunk-{small_err.check}-{spec.seed}")
            path = os.path.join(corpus_dir, f"{named.name}.json")
            with open(path, "w") as fh:
                fh.write(named.to_json() + "\n")
            failure.written_to = path
        report.failures.append(failure)
    report.elapsed = time.monotonic() - t0
    return report
