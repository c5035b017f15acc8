"""Materialize one `ScenarioSpec` as each of the three execution layers.

The same spec deterministically becomes:

* a `FlowNetwork` + GWTF flow problem — solvable by the batched
  `GWTFProtocol`, its ``strict_rng`` scalar mode, the frozen
  `ReferenceGWTFProtocol`, and the centralized `MinCostFlow` oracle
  (`build_network`, `build_flow`, `solve_optimal`);
* a discrete-event simulator run — `TrainingSimulator` with the spec's
  scheduler, model profile and composed churn program (`build_sim`,
  `run_sim`);
* a reduced real-compute run — `RuntimeTrainer` over the staged JAX
  runtime with the *same* churn program and the same policy seeding
  (`build_runtime`, `run_runtime`).

Determinism discipline
----------------------
Every random draw is keyed on ``default_rng([spec.seed, salt])`` with a
fixed per-purpose salt (`_SALT_*`), so layers never perturb each
other's streams: the topology draw is identical for all three layers,
and the *policy* stream is identical between the simulator and the
runtime — both construct their routing policy and sample churn in the
same order, which is what makes the cross-layer plan-equality check in
`scenarios.harness` possible at all.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.flow.graph import (FlowNetwork, Node,
                                   geo_distributed_network,
                                   synthetic_network)
from repro_torch.core.scenarios.spec import ScenarioSpec
from repro_torch.core.sim.faults import (AdversarialPlan, BernoulliChurn,
                                   ChurnModel, ComposedChurn,
                                   CorruptGradientChurn, FlakyLinkChurn,
                                   LinkDegradationChurn, RegionalOutageChurn,
                                   StragglerChurn, TraceChurn,
                                   adversarial_plan)
from repro_torch.core.sim.metrics import IterationMetrics, ModelProfile
from repro_torch.core.sim.policies import make_policy

# fixed per-purpose RNG salts (never reuse across purposes)
_SALT_CAPS = 1        # relay capacity draw
_SALT_NET = 2         # topology link/jitter draw
_SALT_SPARE = 3       # spare-node (flash crowd) attribute draw
_SALT_FLOW = 4        # flow-protocol annealing stream
_SALT_POLICY = 5      # sim/runtime policy + churn stream (shared!)
_SALT_ARRIVALS = 6    # serving request-arrival program compilation


def _rng(spec: ScenarioSpec, salt: int) -> np.random.Generator:
    return np.random.default_rng([spec.seed, salt])


# ---------------------------------------------------------------------------
# Topology
# ---------------------------------------------------------------------------

def relay_capacities(spec: ScenarioSpec) -> List[int]:
    lo, hi = spec.capacity_range
    rng = _rng(spec, _SALT_CAPS)
    return [int(rng.uniform(lo, hi)) for _ in range(spec.num_relays)]


def build_network(spec: ScenarioSpec
                  ) -> Tuple[FlowNetwork, Optional[np.ndarray]]:
    """Materialize the spec's topology.

    Returns ``(net, cost_matrix)`` — ``cost_matrix`` is the directly
    drawn integer d_ij for the synthetic topology (passed through to
    the flow engines, as in the paper's Table IV/V experiments) and
    for geo-abstract (integer per-location-pair base + node jitter,
    ``Node.location`` stamped — the bench_scale internet-scale shape),
    and ``None`` for geo (Eq. 1 costs from the network's own caches).
    """
    spec.validate()
    if spec.topology == "geo-abstract":
        return _geo_abstract_network(spec)
    if spec.topology == "synthetic":
        lo, hi = spec.cost_range
        clo, chi = spec.capacity_range
        net, cost = synthetic_network(
            num_stages=spec.num_stages,
            relays_per_stage=spec.relays_per_stage,
            capacities=lambda r: int(r.uniform(clo, chi)),
            link_costs=lambda r: float(int(r.uniform(lo, hi))),
            num_sources=spec.num_data_nodes,
            source_capacity=spec.source_capacity,
            rng=_rng(spec, _SALT_NET))
        return net, cost

    net = geo_distributed_network(
        num_stages=spec.num_stages,
        relay_capacities=relay_capacities(spec),
        num_data_nodes=spec.num_data_nodes,
        data_capacity=spec.data_capacity,
        num_locations=spec.num_locations,
        min_bandwidth=spec.min_bandwidth,
        max_bandwidth=spec.max_bandwidth,
        compute_cost=spec.compute_cost,
        compute_jitter=spec.compute_jitter,
        rng=_rng(spec, _SALT_NET))
    _apply_region_heterogeneity(spec, net)
    _add_spare_nodes(spec, net)
    _apply_compression(spec, net)
    return net, None


def _apply_compression(spec: ScenarioSpec, net: FlowNetwork) -> None:
    """Install the spec's ``compression`` clause on the network: the
    per-link codec menu and the scenario-level fidelity budget/weight
    that gate and price it.  RNG-free, so it never perturbs the
    topology or policy streams."""
    if spec.compression is None:
        return
    net.codec_menu = tuple(spec.compression["menu"])
    net.fidelity_budget = float(
        spec.compression.get("fidelity_budget", 0.0))
    net.fidelity_weight = float(
        spec.compression.get("fidelity_weight", 1.0))


def _geo_abstract_network(spec: ScenarioSpec
                          ) -> Tuple[FlowNetwork, np.ndarray]:
    """The bench_scale internet-scale topology as a spec: integer
    per-location-pair base cost ~U{cost_range} (intra-location
    ~U{1..4}) plus symmetric per-node-pair jitter ~U{0..2}, relays
    round-robin over stages, ``Node.location`` stamped so the
    hierarchical planner and location-keyed churn clauses apply.

    Capacities come from the shared `relay_capacities` draw
    (``_SALT_CAPS``) like geo; link structure from ``_SALT_NET``.
    """
    caps = relay_capacities(spec)
    rng = _rng(spec, _SALT_NET)
    N = spec.base_nodes
    L = spec.num_locations
    nodes: Dict[int, Node] = {}
    loc = np.empty(N, np.int64)
    for d in range(spec.num_data_nodes):
        nodes[d] = Node(d, -1, spec.source_capacity, 0.0, is_data=True)
        loc[d] = int(rng.integers(0, L))
    for i in range(spec.num_relays):
        nid = spec.num_data_nodes + i
        nodes[nid] = Node(nid, i % spec.num_stages, caps[i], 0.0,
                          location=int(rng.integers(0, L)))
        loc[nid] = nodes[nid].location
    lo, hi = spec.cost_range
    base = rng.integers(lo, hi, (L, L)).astype(float)
    base = np.maximum(base, base.T)
    np.fill_diagonal(base, 0.0)
    base += np.diag(rng.integers(1, 5, L).astype(float))
    jitter = rng.integers(0, 3, (N, N)).astype(float)
    cm = base[np.ix_(loc, loc)] + np.maximum(jitter, jitter.T)
    np.fill_diagonal(cm, 0.0)
    net = FlowNetwork(nodes=nodes, num_stages=spec.num_stages,
                      latency=cm, bandwidth=np.full((N, N), np.inf),
                      activation_size=0.0)
    return net, cm


def _apply_region_heterogeneity(spec: ScenarioSpec, net: FlowNetwork) -> None:
    """Per-region compute/bandwidth multipliers on top of the base draw
    (the heterogeneous-compute axis of Tables II/III)."""
    if spec.region_compute_scale is None \
            and spec.region_bandwidth_scale is None:
        return
    n = net.latency.shape[0]
    loc = np.zeros(n, np.int64)
    for nid, node in net.nodes.items():
        loc[nid] = max(0, node.location)
    if spec.region_compute_scale is not None:
        cs = np.asarray(spec.region_compute_scale, float)
        for node in net.nodes.values():
            if not node.is_data:
                node.compute_cost *= float(cs[max(0, node.location)])
    if spec.region_bandwidth_scale is not None:
        bs = np.asarray(spec.region_bandwidth_scale, float)
        # a link is as good as its worse endpoint region
        link_scale = np.minimum(bs[loc][:, None], bs[loc][None, :])
        net.bandwidth *= link_scale
    net.invalidate_costs()


def _add_spare_nodes(spec: ScenarioSpec, net: FlowNetwork) -> None:
    """Provision the flash-crowd pool: ``spare_nodes`` relays created
    *dead* (alive=False), round-robin over stages, with links drawn
    from the same intra/inter-location distributions as the base
    topology.  A ``flash_crowd`` churn clause revives them mid-run,
    which exercises protocol `add_node` + policy `on_rejoin` on every
    layer."""
    if not spec.spare_nodes:
        return
    rng = _rng(spec, _SALT_SPARE)
    lo, hi = spec.capacity_range
    for k in range(spec.spare_nodes):
        nid = spec.base_nodes + k
        stage = k % spec.num_stages
        cap = int(rng.uniform(lo, hi))
        c = spec.compute_cost * (
            1.0 + spec.compute_jitter * rng.standard_normal())
        loc = int(rng.integers(0, spec.num_locations))
        n_existing = nid
        same = np.array([net.nodes[i].location == loc
                         for i in range(n_existing)])
        lat_row = np.where(same, rng.uniform(0.001, 0.005, n_existing),
                           rng.uniform(0.02, 0.15, n_existing))
        lat_col = np.where(same, rng.uniform(0.001, 0.005, n_existing),
                           rng.uniform(0.02, 0.15, n_existing))
        bw_row = np.where(same, spec.max_bandwidth,
                          rng.uniform(spec.min_bandwidth,
                                      spec.max_bandwidth, n_existing))
        bw_col = np.where(same, spec.max_bandwidth,
                          rng.uniform(spec.min_bandwidth,
                                      spec.max_bandwidth, n_existing))
        node = Node(nid, stage, cap, max(0.5, c), alive=False, location=loc)
        net.add_node(node, latency_row=lat_row, latency_col=lat_col,
                     bandwidth_row=bw_row, bandwidth_col=bw_col)


def spare_node_ids(spec: ScenarioSpec) -> List[int]:
    return list(range(spec.base_nodes, spec.base_nodes + spec.spare_nodes))


# ---------------------------------------------------------------------------
# Churn program
# ---------------------------------------------------------------------------

def _blackout_location(net: FlowNetwork, location: int) -> int:
    """Resolve a spec's blackout location against the built topology.

    A spec draws its location before relay placement is known, so an
    index that happens to land on an empty region wraps onto the
    sorted populated locations deterministically (identity whenever
    the drawn location already has relays — committed scenarios are
    unaffected).  `TraceChurn.regional_blackout` itself stays strict:
    direct callers name locations on a topology they can inspect.
    """
    populated = sorted({n.location for n in net.nodes.values()
                        if not n.is_data and n.location >= 0})
    if location in populated or not populated:
        return location
    return populated[location % len(populated)]


def build_churn_model(spec: ScenarioSpec, net: FlowNetwork) -> ChurnModel:
    """Compose the spec's churn clauses into one `ChurnModel`.

    An empty program compiles to an (RNG-free) empty trace so zero-churn
    scenarios consume no fault-layer randomness.
    """
    models: List[ChurnModel] = []
    spare_cursor = spec.base_nodes
    for clause in spec.churn:
        kind = clause["kind"]
        if kind == "bernoulli":
            models.append(BernoulliChurn(clause["p"]))
        elif kind == "trace":
            models.append(TraceChurn(clause["events"]))
        elif kind == "regional_blackout":
            models.append(TraceChurn.regional_blackout(
                net, location=_blackout_location(net, clause["location"]),
                at_iteration=clause["at_iteration"],
                duration=clause.get("duration", 2),
                when=clause.get("when", 0.25)))
        elif kind == "regional_outage":
            models.append(RegionalOutageChurn(
                clause["outage_prob"],
                severity=clause.get("severity", 1.0),
                rejoin_prob=clause.get("rejoin_prob", 0.5)))
        elif kind == "flash_crowd":
            k = int(clause["nodes"])
            ids = list(range(spare_cursor, spare_cursor + k))
            spare_cursor += k
            models.append(TraceChurn(
                [(clause["at_iteration"], "rejoin", nid) for nid in ids]))
        elif kind == "link_degradation":
            models.append(LinkDegradationChurn(
                clause["at_iteration"], clause["factor"],
                duration=clause.get("duration", 0),
                inter_region_only=clause.get("inter_region_only", True)))
        elif kind == "straggler":
            nodes = [int(n) for n in clause["nodes"]]
            hang = bool(clause.get("hang", False))
            factor = float(clause.get("factor", 4.0))
            models.append(StragglerChurn(
                None if hang else {n: factor for n in nodes},
                hangs=nodes if hang else (),
                at_iteration=int(clause.get("at_iteration", 0)),
                duration=int(clause.get("duration", 0)),
                known_ids=net.nodes.keys()))
        elif kind == "corrupt_gradient":
            models.append(CorruptGradientChurn(
                [int(n) for n in clause["nodes"]],
                mode=clause.get("mode", "perturb"),
                scale=float(clause.get("scale", 1.0)),
                seed=int(clause.get("seed", 0)),
                at_iteration=int(clause.get("at_iteration", 0)),
                duration=int(clause.get("duration", 0)),
                known_ids=net.nodes.keys()))
        elif kind == "flaky_link":
            models.append(FlakyLinkChurn(
                float(clause["p"]),
                seed=int(clause.get("seed", 0)),
                at_iteration=int(clause.get("at_iteration", 0)),
                duration=int(clause.get("duration", 0))))
        else:  # pragma: no cover - validate() rejects unknown kinds
            raise ValueError(f"unknown churn clause kind {kind!r}")
    if not models:
        return TraceChurn([])
    if len(models) == 1:
        return models[0]
    return ComposedChurn(models)


def iteration_crash_plan(spec: ScenarioSpec) -> Dict[int, List[Tuple[int, float]]]:
    """Static view of a *deterministic* churn program: per-iteration
    ``[(node_id, when_fraction), ...]`` crash lists, resolved against a
    throwaway materialization of the topology (blackout clauses need
    node locations).  Raises if the program draws randomness."""
    if not spec.deterministic_churn:
        raise ValueError(f"{spec.name}: churn program is not deterministic")
    net, _ = build_network(spec)
    plan: Dict[int, List[Tuple[int, float]]] = {}
    for clause in spec.churn:
        kind = clause["kind"]
        if kind == "trace":
            for ev in clause["events"]:
                if str(ev[1]) == "crash":
                    when = float(ev[3]) if len(ev) > 3 else 0.5
                    plan.setdefault(int(ev[0]), []).append(
                        (int(ev[2]), when))
        elif kind == "regional_blackout":
            loc = _blackout_location(net, clause["location"])
            nids = [n.id for n in net.nodes.values()
                    if not n.is_data and n.location == loc]
            when = clause.get("when", 0.25)
            for nid in nids:
                plan.setdefault(int(clause["at_iteration"]), []).append(
                    (nid, when))
        # flash_crowd / link_degradation / adversarial clauses crash
        # nobody (stragglers, corrupters and flaky links stay alive)
    return plan


def iteration_adversarial_plan(spec: ScenarioSpec
                               ) -> Dict[int, AdversarialPlan]:
    """Static per-iteration `AdversarialPlan` view of a deterministic
    churn program: what the beyond-fail-stop clauses inject at each
    iteration, resolved without running either execution layer.  The
    harness uses it to pin expected injection counts against both
    layers' fault timelines.  Raises if the program draws randomness."""
    if not spec.deterministic_churn:
        raise ValueError(f"{spec.name}: churn program is not deterministic")
    net, _ = build_network(spec)
    model = build_churn_model(spec, net)
    out: Dict[int, AdversarialPlan] = {}
    for it in range(spec.iterations):
        plan = adversarial_plan(model, it)
        if plan is not None and not plan.is_empty():
            out[it] = plan
    return out


# ---------------------------------------------------------------------------
# Layer (a): flow engines + optimal oracle
# ---------------------------------------------------------------------------

FLOW_ENGINES = ("batched", "strict", "reference")


def build_flow(spec: ScenarioSpec, engine: str = "batched",
               net: Optional[FlowNetwork] = None,
               cost_matrix: Optional[np.ndarray] = None):
    """A GWTF protocol instance over the spec's topology.

    ``engine``: ``"batched"`` (default optimized scans), ``"strict"``
    (optimized engine, scalar-scan compatibility mode) or
    ``"reference"`` (the frozen pre-optimization implementation).
    Passing ``net``/``cost_matrix`` reuses an existing materialization
    (the differential harness builds one per engine).
    """
    from repro_torch.core.flow.decentralized import GWTFProtocol
    from repro_torch.core.flow.reference import ReferenceGWTFProtocol

    if net is None:
        net, cost_matrix = build_network(spec)
    rng = _rng(spec, _SALT_FLOW)
    if engine == "reference":
        return ReferenceGWTFProtocol(net, cost_matrix=cost_matrix,
                                     objective=spec.objective, rng=rng)
    if engine not in ("batched", "strict"):
        raise ValueError(f"unknown flow engine {engine!r} "
                         f"(expected one of {FLOW_ENGINES})")
    return GWTFProtocol(net, cost_matrix=cost_matrix,
                        objective=spec.objective,
                        strict_rng=(engine == "strict"), rng=rng)


@dataclass
class FlowResult:
    engine: str
    flows: List[List[int]]
    total_cost: float
    temperature: float
    rounds: int
    rng_state: dict
    protocol: Any = field(repr=False, default=None)
    net: FlowNetwork = field(repr=False, default=None)


def run_flow(spec: ScenarioSpec, engine: str = "batched",
             max_rounds: int = 120) -> FlowResult:
    net, cm = build_network(spec)
    proto = build_flow(spec, engine, net=net, cost_matrix=cm)
    rounds = proto.run(max_rounds=max_rounds)
    return FlowResult(engine=engine, flows=proto.complete_flows(),
                      total_cost=proto.total_cost(), temperature=proto.T,
                      rounds=rounds,
                      rng_state=proto.rng.bit_generator.state,
                      protocol=proto, net=net)


def solve_optimal(spec: ScenarioSpec, method: str = "auto",
                  max_flow: Optional[float] = None,
                  net: Optional[FlowNetwork] = None,
                  cost_matrix: Optional[np.ndarray] = None):
    """Centralized `MinCostFlow` optimum over the spec's layered graph."""
    from repro_torch.core.flow.mincost import solve_training_flow

    if net is None:
        net, cost_matrix = build_network(spec)
    return solve_training_flow(net, cost_matrix=cost_matrix,
                               max_flow=max_flow, method=method)


# ---------------------------------------------------------------------------
# Layer (b): event simulator
# ---------------------------------------------------------------------------

def model_config(spec: ScenarioSpec):
    """The reduced model family shared by the profile and the runtime."""
    from repro_torch.configs import get_config

    cfg = get_config(spec.model).reduced(num_layers=spec.model_layers,
                                         d_model=spec.model_d)
    return dataclasses.replace(cfg, vocab_size=spec.model_vocab)


def model_profile(spec: ScenarioSpec) -> ModelProfile:
    return ModelProfile.from_config(model_config(spec),
                                    num_stages=spec.num_stages,
                                    microbatch=spec.microbatch_size,
                                    seq_len=spec.seq_len)


def build_sim(spec: ScenarioSpec,
              policy_wrapper=None, **sim_kw):
    """`TrainingSimulator` over the spec; ``policy_wrapper`` (if given)
    wraps the routing policy before the engine sees it — the harness
    uses it to record per-iteration plans without perturbing the RNG
    stream.  Extra keywords (``deadline_defense``, ``corrupt_screen``)
    reach the engine — the benches use them for the undefended
    baselines."""
    from repro_torch.core.sim.facade import TrainingSimulator

    net, _ = build_network(spec)
    rng = _rng(spec, _SALT_POLICY)
    policy = make_policy(spec.scheduler, net, rng=rng)
    if policy_wrapper is not None:
        policy = policy_wrapper(policy)
    return TrainingSimulator(
        net, profile=model_profile(spec),
        churn_model=build_churn_model(spec, net), policy=policy, rng=rng,
        **sim_kw)


def run_sim(spec: ScenarioSpec,
            iterations: Optional[int] = None) -> List[IterationMetrics]:
    sim = build_sim(spec)
    return sim.run(iterations if iterations is not None else spec.iterations)


# ---------------------------------------------------------------------------
# Layer (c): real-compute runtime
# ---------------------------------------------------------------------------

def runtime_batches(spec: ScenarioSpec, net: FlowNetwork
                    ) -> Dict[int, List[dict]]:
    """Per-data-node microbatches (one fixed batch reused every
    iteration, like the runtime tests — keeps loss trajectories
    comparable across layers and runs)."""
    from repro_torch.data.pipeline import DataConfig, DataNodeShard

    cfg = model_config(spec)
    dns = [n.id for n in net.data_nodes()]
    out: Dict[int, List[dict]] = {}
    for i, dn in enumerate(dns):
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=spec.seq_len,
                        batch_size=spec.microbatches * spec.microbatch_size,
                        microbatch_size=spec.microbatch_size,
                        seed=spec.seed)
        out[dn] = DataNodeShard(dc, i, len(dns)).microbatches()
    return out


def build_runtime(spec: ScenarioSpec, *, lr: float = 3e-3,
                  policy_wrapper=None, **trainer_kw):
    """`(RuntimeTrainer, batches)` over the spec — same topology draw,
    same churn program, and the *same* policy/churn RNG stream as
    `build_sim` (construction order mirrored), so the two layers plan
    identical chain sets on rng-free churn programs."""
    from repro_torch.core.runtime.trainer import RuntimeTrainer

    net, _ = build_network(spec)
    rng = _rng(spec, _SALT_POLICY)
    policy = make_policy(spec.scheduler, net, rng=rng)
    if policy_wrapper is not None:
        policy = policy_wrapper(policy)
    if spec.compression is not None:
        # non-trivial menu: boundary transfers follow the planner's
        # per-link codec choices unless the caller forces a codec
        trainer_kw.setdefault("wire_codec", "planner")
    trainer = RuntimeTrainer(
        model_config(spec), net, lr=lr, seed=spec.seed, rng=rng,
        policy=policy, churn_model=build_churn_model(spec, net),
        **trainer_kw)
    return trainer, runtime_batches(spec, net)


def run_runtime(spec: ScenarioSpec, iterations: Optional[int] = None,
                **kw) -> List[Any]:
    trainer, batches = build_runtime(spec, **kw)
    its = iterations if iterations is not None else spec.iterations
    return [trainer.iteration(batches) for _ in range(its)]


# ---------------------------------------------------------------------------
# Serving plane: arrival programs + the serving sim/runtime builders
# ---------------------------------------------------------------------------

def _arrivals_rng(spec: ScenarioSpec, clause_seed: int, clause_idx: int,
                  iteration: int) -> np.random.Generator:
    """Counter-based generator for one (clause, iteration) cell — the
    flaky-link seeding pattern, so arrival programs are a pure function
    of the spec with no cross-iteration or cross-clause stream
    coupling (clauses can be added/removed without reshuffling the
    others' draws)."""
    return np.random.default_rng(
        [spec.seed, _SALT_ARRIVALS, clause_seed, clause_idx, iteration])


def _clause_active(clause: Dict[str, Any], it: int) -> bool:
    at = int(clause.get("at_iteration", 0))
    dur = int(clause.get("duration", 0))
    return it >= at and (dur == 0 or it < at + dur)


def compile_arrivals(spec: ScenarioSpec) -> List[List[float]]:
    """Compile the spec's ``arrivals`` clauses into the open-loop
    request program: per-iteration sorted lists of arrival offsets in
    ``[0, 1)`` (fractions of the iteration horizon).

    ``poisson`` draws ``Poisson(rate)`` arrivals per active iteration
    at sorted-uniform offsets; ``diurnal`` modulates the rate with a
    raised cosine (trough at ``low_scale * rate``, period in
    iterations); ``spike`` lands ``requests`` simultaneous arrivals at
    fraction ``when`` of one iteration (the flash-crowd shape).  An
    empty program compiles to empty lists (RNG-free).
    """
    program: List[List[float]] = []
    for it in range(spec.iterations):
        offs: List[float] = []
        for idx, clause in enumerate(spec.arrivals):
            kind = clause["kind"]
            if not _clause_active(clause, it):
                continue
            if kind == "poisson":
                rng = _arrivals_rng(spec, int(clause.get("seed", 0)),
                                    idx, it)
                n = int(rng.poisson(float(clause["rate"])))
                offs.extend(float(u) for u in np.sort(rng.uniform(0, 1, n)))
            elif kind == "diurnal":
                low = float(clause.get("low_scale", 0.25))
                period = int(clause["period"])
                phase = (it - int(clause.get("at_iteration", 0))) % period
                scale = low + (1.0 - low) * 0.5 * (
                    1.0 + np.cos(2.0 * np.pi * phase / period))
                rng = _arrivals_rng(spec, int(clause.get("seed", 0)),
                                    idx, it)
                n = int(rng.poisson(float(clause["rate"]) * scale))
                offs.extend(float(u) for u in np.sort(rng.uniform(0, 1, n)))
            elif kind == "spike":
                if it == int(clause["at_iteration"]):
                    offs.extend([float(clause.get("when", 0.25))]
                                * int(clause["requests"]))
            else:  # pragma: no cover - validate() rejects unknown kinds
                raise ValueError(f"unknown arrival clause kind {kind!r}")
        offs.sort()
        program.append(offs)
    return program


def build_serving_sim(spec: ScenarioSpec, policy_wrapper=None, **kw):
    """`ServingEngine` over the spec: same topology draw, same policy +
    churn RNG stream as `build_sim`/`build_runtime` (construction order
    mirrored), decode requests from the compiled arrival program.  The
    spec's ``kv_weight`` lands on the network so residency feedback
    prices the next plan; ``kw`` reaches the engine (the bench uses
    ``reroute=False`` for the drop-and-retry baseline)."""
    from repro_torch.core.sim.engine import ServingEngine

    net, _ = build_network(spec)
    net.kv_weight = spec.kv_weight
    rng = _rng(spec, _SALT_POLICY)
    policy = make_policy(spec.scheduler, net, rng=rng)
    if policy_wrapper is not None:
        policy = policy_wrapper(policy)
    return ServingEngine(
        net, policy, arrival_program=compile_arrivals(spec),
        churn_model=build_churn_model(spec, net),
        profile=model_profile(spec),
        prompt_len=spec.prompt_len, gen_tokens=spec.gen_tokens,
        serve_batch=spec.serve_batch,
        tokens_per_mb=spec.microbatch_size * spec.seq_len,
        rng=rng, **kw)


def run_serving_sim(spec: ScenarioSpec,
                    iterations: Optional[int] = None) -> List[Any]:
    eng = build_serving_sim(spec)
    return eng.run(iterations if iterations is not None else spec.iterations)


def build_serving_runtime(spec: ScenarioSpec, policy_wrapper=None, **kw):
    """`ServeTrainer` over the spec — real decode compute following the
    embedded engine's schedule, constructed with the *same* RNG stream
    discipline as `build_serving_sim` so the serving differential
    check can pin chain plans and TTFT/TPOT to exact equality."""
    from repro_torch.core.runtime.serving import ServeTrainer

    net, _ = build_network(spec)
    net.kv_weight = spec.kv_weight
    rng = _rng(spec, _SALT_POLICY)
    policy = make_policy(spec.scheduler, net, rng=rng)
    if policy_wrapper is not None:
        policy = policy_wrapper(policy)
    return ServeTrainer(
        model_config(spec), net, policy=policy,
        arrival_program=compile_arrivals(spec),
        churn_model=build_churn_model(spec, net),
        profile=model_profile(spec),
        prompt_len=spec.prompt_len, gen_tokens=spec.gen_tokens,
        serve_batch=spec.serve_batch,
        tokens_per_mb=spec.microbatch_size * spec.seq_len,
        rng=rng, seed=spec.seed, **kw)
