"""The committed scenario corpus (paper Table II/III regimes + beyond).

~12 named `ScenarioSpec`s covering the paper's evaluation axes — the
10-location geo topology, 5-20% Bernoulli churn, heterogeneous
capacities and compute — plus the failure modes the related systems
literature calls under-evaluated: scripted regional blackouts,
correlated regional outages, flash-crowd joins, link degradation, and
the abstract Table IV/V flow settings.

`load_corpus()` also picks up any ``*.json`` spec dropped into
``corpus/`` next to this module — that directory is where the fuzz
harness (`scenarios.harness.fuzz`) writes minimized failing specs, so
a shrunk reproducer automatically becomes a named regression scenario
on the next corpus sweep.

Golden metrics (`golden.json`) pin the flow-layer outcome (chain
count, total cost — bit-stable by the engines' equivalence guarantee)
and the simulator's Table II/III `summarize` columns for every corpus
scenario.  Regenerate after an intentional behavior change with::

    PYTHONPATH=src python -m repro.core.scenarios.corpus --regen-golden
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.core.scenarios import generate
from repro_torch.core.scenarios.spec import ScenarioSpec

_HERE = os.path.dirname(os.path.abspath(__file__))
CORPUS_DIR = os.path.join(_HERE, "corpus")
GOLDEN_PATH = os.path.join(_HERE, "golden.json")

#: scenarios whose sim `summarize` columns the golden regression test
#: pins tolerance-free (GWTF runs are bit-deterministic per seed)
GOLDEN_PINNED = ("table2-het-churn10", "geo-regional-blackout",
                 "adversarial-straggler", "adversarial-flaky",
                 "serve-steady-poisson", "serve-churn-under-load")


def _corpus() -> List[ScenarioSpec]:
    geo = dict(topology="geo", num_stages=4, relays_per_stage=4,
               num_data_nodes=2, data_capacity=4, num_locations=10,
               iterations=6)
    specs = [
        # ---- paper Table II/III regimes (geo, 10 locations) ----------
        ScenarioSpec(name="table2-hom-churn10", seed=11,
                     capacity_range=(4, 5),
                     churn=[{"kind": "bernoulli", "p": 0.10}], **geo),
        ScenarioSpec(name="table2-het-churn10", seed=12,
                     capacity_range=(1, 4),
                     churn=[{"kind": "bernoulli", "p": 0.10}], **geo),
        ScenarioSpec(name="table3-het-churn20", seed=13,
                     capacity_range=(1, 4),
                     churn=[{"kind": "bernoulli", "p": 0.20}], **geo),
        ScenarioSpec(name="geo-churn5", seed=14, capacity_range=(1, 4),
                     churn=[{"kind": "bernoulli", "p": 0.05}], **geo),
        ScenarioSpec(name="geo-zero-churn", seed=15, capacity_range=(2, 4),
                     topology="geo", num_stages=2, relays_per_stage=3,
                     num_data_nodes=1, data_capacity=4, num_locations=10,
                     iterations=6, churn=[]),
        # ---- geo failure modes beyond Bernoulli ----------------------
        ScenarioSpec(name="geo-regional-blackout", seed=16,
                     capacity_range=(1, 4),
                     churn=[{"kind": "regional_blackout", "location": 3,
                             "at_iteration": 2, "duration": 2,
                             "when": 0.25}], **geo),
        ScenarioSpec(name="geo-correlated-outages", seed=17,
                     capacity_range=(1, 4),
                     churn=[{"kind": "regional_outage", "outage_prob": 0.4,
                             "severity": 0.8, "rejoin_prob": 0.5}], **geo),
        ScenarioSpec(name="geo-flash-crowd", seed=18,
                     capacity_range=(1, 4), spare_nodes=4,
                     churn=[{"kind": "flash_crowd", "at_iteration": 2,
                             "nodes": 4},
                            {"kind": "bernoulli", "p": 0.05}], **geo),
        ScenarioSpec(name="geo-link-degradation", seed=19,
                     capacity_range=(1, 4),
                     churn=[{"kind": "link_degradation", "at_iteration": 2,
                             "factor": 6.0, "duration": 2},
                            {"kind": "bernoulli", "p": 0.05}], **geo),
        ScenarioSpec(name="geo-hetero-compute", seed=20,
                     capacity_range=(1, 4),
                     region_compute_scale=[1.0, 4.0, 1.5, 2.0, 1.0,
                                           3.0, 1.0, 2.5, 1.0, 2.0],
                     region_bandwidth_scale=[1.0, 0.25, 1.0, 0.5, 1.0,
                                             0.5, 1.0, 1.0, 0.3, 1.0],
                     churn=[{"kind": "bernoulli", "p": 0.10}], **geo),
        # ---- compression-aware WAN planning --------------------------
        # full codec menu under a budget admitting everything up to
        # top-k; per-link choices and bytes-on-wire are pinned by the
        # golden table and cross-checked by harness.check_codec_agreement
        ScenarioSpec(name="geo-wan-compress", seed=24,
                     capacity_range=(1, 4),
                     compression={"menu": ["fp32", "bf16", "int8",
                                           "top-k"],
                                  "fidelity_budget": 0.1,
                                  "fidelity_weight": 1.0},
                     churn=[{"kind": "bernoulli", "p": 0.10}], **geo),
        ScenarioSpec(name="trace-crash-rejoin", seed=21,
                     capacity_range=(2, 4),
                     churn=[{"kind": "trace",
                             "events": [[1, "crash", 3, 0.3],
                                        [1, "crash", 7, 0.6],
                                        [3, "rejoin", 3],
                                        [4, "rejoin", 7],
                                        [4, "crash", 11, 0.2]]}], **geo),
        # ---- beyond fail-stop: adversarial fault classes ---
        # corrupt relay 3 carries 2 of the 4 planned chains at seed 25;
        # the runtime gradient screen catches both poisoned
        # contributions at iteration 0 (mode "perturb" is certainly
        # detectable — sign_flip is regime-dependent near init and
        # deliberately not pinned), reputation quarantines the relay
        # and the planner reroutes off it from iteration 1.  Swept by
        # check_fault_timeline + check_detection_precision_recall.
        ScenarioSpec(name="adversarial-corrupt", seed=25,
                     topology="geo", num_stages=2, relays_per_stage=3,
                     num_data_nodes=1, data_capacity=4,
                     capacity_range=(2, 3), iterations=4, microbatches=4,
                     model_layers=2, model_d=32, model_vocab=256,
                     seq_len=16, microbatch_size=1,
                     churn=[{"kind": "corrupt_gradient", "nodes": [3],
                             "mode": "perturb", "scale": 1.0, "seed": 7}]),
        # stage-1 relay 4 hangs for iterations 1-2 (deadline-catchable
        # on both layers: only a timeout ever completes it) while relay
        # 5 runs 1.5x slow (deliberately *below* both layers' catch
        # thresholds — injected and timed, never detected); the shared
        # fault timeline pins identical detection/repair counts
        ScenarioSpec(name="adversarial-straggler", seed=25,
                     topology="geo", num_stages=2, relays_per_stage=3,
                     num_data_nodes=1, data_capacity=4,
                     capacity_range=(2, 3), iterations=4, microbatches=4,
                     model_layers=2, model_d=32, model_vocab=256,
                     seq_len=16, microbatch_size=1,
                     churn=[{"kind": "straggler", "nodes": [4],
                             "hang": True, "at_iteration": 1,
                             "duration": 2},
                            {"kind": "straggler", "nodes": [5],
                             "factor": 1.5, "at_iteration": 1,
                             "duration": 2}]),
        # per-leg Bernoulli delivery failure: detection/repair is
        # engine-local (the runtime performs no transfer legs), so only
        # the injections cross-compare; sim retries/timeouts are pinned
        # by the golden table
        ScenarioSpec(name="adversarial-flaky", seed=25,
                     topology="geo", num_stages=2, relays_per_stage=3,
                     num_data_nodes=1, data_capacity=4,
                     capacity_range=(2, 3), iterations=4, microbatches=4,
                     model_layers=2, model_d=32, model_vocab=256,
                     seq_len=16, microbatch_size=1,
                     churn=[{"kind": "flaky_link", "p": 0.15,
                             "seed": 3}]),
        # ---- serving plane: decode traffic over the flow engine ------
        # steady open-loop Poisson load, zero churn, KV-residency
        # pricing on: the baseline serving regime whose TTFT/TPOT row
        # the golden table pins and whose zero-churn decode must be
        # bit-identical to the standalone launch/serve.py path
        # (harness.check_serving_consistency)
        ScenarioSpec(name="serve-steady-poisson", seed=26,
                     topology="geo", num_stages=3, relays_per_stage=3,
                     num_data_nodes=1, data_capacity=4,
                     capacity_range=(2, 4), iterations=4, microbatches=4,
                     model_layers=2, model_d=32, model_vocab=128,
                     seq_len=16, microbatch_size=1,
                     prompt_len=8, gen_tokens=8, serve_batch=4,
                     kv_weight=0.5,
                     arrivals=[{"kind": "poisson", "rate": 2.0}]),
        # the geo-flash-crowd shape reused as a serving spike: spare
        # relays rejoin exactly when the request flash crowd lands, so
        # admission pressure and fresh capacity hit the planner in the
        # same iteration
        ScenarioSpec(name="serve-flash-spike", seed=27,
                     topology="geo", num_stages=3, relays_per_stage=3,
                     num_data_nodes=1, data_capacity=4,
                     capacity_range=(2, 4), iterations=4, microbatches=4,
                     model_layers=2, model_d=32, model_vocab=128,
                     seq_len=16, microbatch_size=1, spare_nodes=2,
                     prompt_len=8, gen_tokens=8, serve_batch=2,
                     arrivals=[{"kind": "poisson", "rate": 1.0},
                               {"kind": "spike", "at_iteration": 1,
                                "requests": 6, "when": 0.3}],
                     churn=[{"kind": "flash_crowd", "at_iteration": 1,
                             "nodes": 2}]),
        # deterministic crash while decodes are in flight: the
        # requeue-instead-of-drop path (KV migration + crashed-stage
        # re-prefill) pinned by the golden table and replayed with real
        # compute by the serving differential
        ScenarioSpec(name="serve-churn-under-load", seed=28,
                     topology="geo", num_stages=3, relays_per_stage=3,
                     num_data_nodes=1, data_capacity=4,
                     capacity_range=(2, 4), iterations=4, microbatches=4,
                     model_layers=2, model_d=32, model_vocab=128,
                     seq_len=16, microbatch_size=1,
                     prompt_len=8, gen_tokens=48, serve_batch=4,
                     arrivals=[{"kind": "spike", "at_iteration": 1,
                                "requests": 4, "when": 0.2},
                               {"kind": "poisson", "rate": 1.0}],
                     churn=[{"kind": "trace",
                             "events": [[1, "crash", 5, 0.4]]}]),
        # ---- abstract flow settings (paper Tables IV/V) --------------
        ScenarioSpec(name="flow-tableV-1", seed=22, topology="synthetic",
                     num_stages=8, relays_per_stage=5, num_data_nodes=1,
                     source_capacity=4, capacity_range=(1, 3),
                     cost_range=(1, 20), iterations=2),
        ScenarioSpec(name="flow-tableV-multisource", seed=23,
                     topology="synthetic", num_stages=8,
                     relays_per_stage=10, num_data_nodes=4,
                     source_capacity=3, capacity_range=(1, 3),
                     cost_range=(1, 20), iterations=2),
    ]
    for s in specs:
        s.validate()
    return specs


def _scale_corpus() -> List[ScenarioSpec]:
    """The ``--scale`` tier: bench_scale-style topologies at 500-2000
    relays under churn.  Swept by the scenario-corpus CI job with the
    restricted `harness.scale_checks` set (the real-compute and
    reference-engine differentials stay bounded; nothing here runs
    JAX), never part of the golden corpus."""
    specs = [
        # engine-vs-reference bit-equality through the harness'
        # crash -> repair -> rejoin episode at >= 500 relays
        ScenarioSpec(name="scale-flow-500", seed=41, tier="scale",
                     topology="synthetic", num_stages=10,
                     relays_per_stage=50, num_data_nodes=2,
                     source_capacity=25, capacity_range=(1, 4),
                     cost_range=(1, 20), iterations=2, objective="sum"),
        # 1000-relay geo-abstract swarm under Bernoulli churn: event
        # engine + planner at scale (sim-invariants, hierarchy gap)
        ScenarioSpec(name="scale-geo-1000-churn10", seed=42, tier="scale",
                     topology="geo-abstract", num_stages=10,
                     relays_per_stage=100, num_data_nodes=2,
                     source_capacity=50, capacity_range=(1, 4),
                     cost_range=(4, 21), num_locations=10,
                     iterations=2, objective="sum",
                     churn=[{"kind": "bernoulli", "p": 0.10}]),
        # regional blackout at scale: location-keyed churn on the
        # geo-abstract topology + hierarchical-vs-oracle gap bound
        ScenarioSpec(name="scale-geo-2000-blackout", seed=43, tier="scale",
                     topology="geo-abstract", num_stages=10,
                     relays_per_stage=200, num_data_nodes=2,
                     source_capacity=100, capacity_range=(1, 4),
                     cost_range=(4, 21), num_locations=10,
                     iterations=2, objective="sum",
                     churn=[{"kind": "regional_blackout", "location": 2,
                             "at_iteration": 0, "duration": 1}]),
    ]
    for s in specs:
        s.validate()
    return specs


def load_corpus(include_shrunk: bool = True,
                tier: str = "standard") -> List[ScenarioSpec]:
    """Committed scenarios of one tier (or ``"all"``): the named set
    plus — for the standard tier — any fuzz-minimized ``corpus/*.json``
    regression specs."""
    if tier not in ("standard", "scale", "all"):
        raise ValueError(f"unknown corpus tier {tier!r}")
    specs: List[ScenarioSpec] = _corpus() + _scale_corpus()
    if include_shrunk and os.path.isdir(CORPUS_DIR):
        for path in sorted(glob.glob(os.path.join(CORPUS_DIR, "*.json"))):
            with open(path) as fh:
                specs.append(ScenarioSpec.from_json(fh.read()))
    if tier != "all":
        specs = [s for s in specs if s.tier == tier]
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate scenario names in corpus: {dupes}")
    return specs


def get_scenario(name: str) -> ScenarioSpec:
    for spec in load_corpus(tier="all"):
        if spec.name == name:
            return spec
    raise KeyError(f"unknown scenario {name!r}; corpus has "
                   f"{[s.name for s in load_corpus(tier='all')]}")


# ---------------------------------------------------------------------------
# Golden metrics
# ---------------------------------------------------------------------------

def compute_golden(spec: ScenarioSpec) -> Dict:
    """The pinned observables for one scenario: flow-layer outcome,
    the simulator's summarize() table, and — for specs with an arrival
    program — the serving plane's summarize_serving() row (request
    counters + p50/p99 TTFT/TPOT, bit-deterministic per seed)."""
    from repro_torch.core.sim.metrics import summarize, summarize_serving

    flow = generate.run_flow(spec, "batched")
    table = summarize(generate.run_sim(spec), warmup=1)
    out = {
        "flow": {"chains": len(flow.flows),
                 "total_cost": flow.total_cost,
                 "rounds": flow.rounds},
        "sim": {k: list(v) for k, v in table.items()},
    }
    if spec.has_arrivals:
        out["serving"] = summarize_serving(generate.run_serving_sim(spec))
    return out


def load_golden() -> Dict[str, Dict]:
    with open(GOLDEN_PATH) as fh:
        return json.load(fh)


def regen_golden(path: Optional[str] = None) -> Dict[str, Dict]:
    golden = {spec.name: compute_golden(spec)
              for spec in load_corpus(include_shrunk=False)}
    with open(path or GOLDEN_PATH, "w") as fh:
        json.dump(golden, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return golden


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--regen-golden", action="store_true",
                    help="rerun every corpus scenario and rewrite "
                         "golden.json")
    ap.add_argument("--list", action="store_true",
                    help="print the corpus table")
    ap.add_argument("--scale", action="store_true",
                    help="also list the scale tier (1000+ relay specs "
                         "swept by harness.scale_checks)")
    args = ap.parse_args(argv)
    if args.regen_golden:
        golden = regen_golden()
        print(f"wrote {GOLDEN_PATH} ({len(golden)} scenarios)")
    if args.list or args.scale or not args.regen_golden:
        print(f"{'name':28s} {'tier':8s} {'topology':12s} {'nodes':>5s} "
              f"{'stages':>6s} churn")
        tier = "all" if args.scale else "standard"
        for spec in load_corpus(tier=tier):
            kinds = ",".join(c["kind"] for c in spec.churn) or "-"
            print(f"{spec.name:28s} {spec.tier:8s} {spec.topology:12s} "
                  f"{spec.base_nodes + spec.spare_nodes:5d} "
                  f"{spec.num_stages:6d} {kinds}")


if __name__ == "__main__":
    main()
