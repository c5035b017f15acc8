"""Churn-tolerance demo: GWTF vs SWARM under crash-heavy conditions.

Reproduces the paper's core claim interactively: with 20% of relays
crashing/rejoining each iteration, GWTF's flow repair keeps wasted GPU
time near zero while SWARM's full-pipeline recomputes burn compute.

Beyond the paper's Bernoulli churn, the layered fault model runs two
harder scenarios (FusionLLM-style geo-distributed failure modes):

* ``regional`` — correlated regional outages: one of the 10 geographic
  locations goes dark and every relay there crashes at the same
  moment, with gradual rejoins;
* ``trace``  — deterministic trace replay: a scripted blackout of one
  location mid-run (plus background Bernoulli churn) so both
  schedulers face the *identical* fault sequence.

Two beyond-fail-stop scenarios demo the adversarial fault models and
the detect–quarantine–reroute layer (these compare the GWTF engine
*defended vs undefended* instead of GWTF vs SWARM):

* ``straggler`` — pathologically slow and hung relays: the deadline
  defense hedges at the healthy-estimate deadline and reroutes, the
  undefended engine waits the slowdown out;
* ``byzantine`` — corrupt-gradient relays: the detection screen feeds
  the reputation layer, which quarantines the corrupt relay and plans
  around it (the simulator carries no real gradients, so this shows
  the detection/quarantine plumbing; the real gradient math lives in
  the runtime trainer and `BENCH_exec.json`'s byzantine record).

    PYTHONPATH=src python examples/torch_churn_recovery.py               # all
    PYTHONPATH=src python examples/torch_churn_recovery.py bernoulli
    PYTHONPATH=src python examples/torch_churn_recovery.py straggler byzantine
"""
import sys

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.flow.graph import geo_distributed_network
from repro_torch.core.simulator import (ComposedChurn, BernoulliChurn,
                                  CorruptGradientChurn, ModelProfile,
                                  RegionalOutageChurn, StragglerChurn,
                                  TraceChurn, TrainingSimulator, summarize)


def make_setup(seed: int = 0):
    cfg = get_config("gwtf-llama-300m")
    prof = ModelProfile.from_config(cfg, num_stages=6)
    rng = np.random.default_rng(seed)
    caps = [int(rng.uniform(1, 4)) for _ in range(16)]
    net = geo_distributed_network(num_stages=4, relay_capacities=caps,
                                  num_data_nodes=2, data_capacity=4,
                                  compute_cost=prof.fwd_compute,
                                  activation_size=prof.activation_bytes,
                                  rng=np.random.default_rng(seed))
    return net, prof


def run(scheduler: str, *, churn: float = 0.0, churn_model=None,
        seed: int = 0, iterations: int = 15, warmup: int = 3):
    net, prof = make_setup(seed)
    if callable(churn_model):                  # needs the topology
        churn_model = churn_model(net)
    sim = TrainingSimulator(net, scheduler=scheduler, profile=prof,
                            churn=churn, churn_model=churn_model,
                            rng=np.random.default_rng(seed + 7))
    table = summarize(sim.run(iterations), warmup=warmup)
    return {
        "time/mb (min)": table["time_per_mb"][0] / 60,
        "throughput": table["throughput"][0],
        "comm (min)": table["comm_time"][0] / 60,
        "wasted gpu (min)": table["wasted_gpu"][0] / 60,
        "reroutes": table["reroutes"][0],
        "queue depth (peak)": table["queue_depth_peak"][0],
    }


def compare(title: str, **kwargs):
    print(f"\n=== {title} ===")
    g = run("gwtf", **kwargs)
    s = run("swarm", **kwargs)
    for k in g:
        better = "GWTF" if g[k] <= s[k] else "SWARM"
        if k == "throughput":
            better = "GWTF" if g[k] >= s[k] else "SWARM"
        print(f"  {k:18s} GWTF={g[k]:6.2f}  SWARM={s[k]:6.2f}  [{better}]")
    s_t, g_t = s["time/mb (min)"], g["time/mb (min)"]
    if s_t:
        print(f"  GWTF training-time reduction: {(s_t - g_t) / s_t:+.0%} "
              f"(paper: up to 45%)")


def scenario_bernoulli():
    for churn in (0.0, 0.1, 0.2):
        compare(f"churn {int(churn * 100)}% (heterogeneous capacities)",
                churn=churn)


def scenario_regional():
    # every ~3rd iteration one of the 10 locations blacks out entirely;
    # dead relays come back with p=0.5 per iteration
    compare("correlated regional outages (30% per iteration, full region)",
            churn_model=lambda net: RegionalOutageChurn(
                0.3, severity=1.0, rejoin_prob=0.5))


def scenario_trace():
    # scripted blackout of one location at iteration 5 (rejoining at 8),
    # on top of 5% background Bernoulli churn — both schedulers replay
    # the identical scripted fault sequence
    def model(net):
        loc = net.stage_nodes(0)[0].location
        return ComposedChurn([
            TraceChurn.regional_blackout(net, location=loc, at_iteration=5,
                                         duration=3, when=0.25),
            BernoulliChurn(0.05),
        ])
    compare("trace replay: scripted location blackout @ iter 5 "
            "+ 5% background churn", churn_model=model)


def _run_defense(model_factory, *, seed: int = 0, iterations: int = 10,
                 **sim_kw):
    net, prof = make_setup(seed)
    sim = TrainingSimulator(net, scheduler="gwtf", profile=prof,
                            churn_model=model_factory(net),
                            rng=np.random.default_rng(seed + 7), **sim_kw)
    ms = sim.run(iterations)
    detections = sum(c for (_, _f, kind), c
                     in sim.engine.timeline.counts().items()
                     if kind == "detection")
    return {
        "duration (min)": sum(m.duration for m in ms) / 60,
        "throughput": (sum(m.completed for m in ms)
                       / max(1e-9, sum(m.duration for m in ms))),
        "timeouts": sum(m.timeouts for m in ms),
        "reroutes": sum(m.reroutes for m in ms),
        "detections": detections,
    }, net


def _compare_defense(title: str, model_factory, defended_kw, undefended_kw):
    print(f"\n=== {title} ===")
    d, d_net = _run_defense(model_factory, **defended_kw)
    u, _ = _run_defense(model_factory, **undefended_kw)
    for k in d:
        print(f"  {k:18s} defended={d[k]:8.2f}  undefended={u[k]:8.2f}")
    if u["throughput"]:
        print(f"  deadline/quarantine defense throughput gain: "
              f"{d['throughput'] / u['throughput']:.1f}x")
    return d, u, d_net


def scenario_straggler():
    # one hung relay plus one pathological slowdown, sized from the
    # profile so the slowed compute blows the healthy-estimate deadline
    # (timeout 30s) — i.e. both are deadline-catchable
    def model(net):
        relays = [n.id for n in net.nodes.values() if not n.is_data]
        factor = 2.0 * (30.0 / max(1e-6, min(
            net.nodes[r].compute_cost for r in relays)) + 1.0)
        return StragglerChurn({relays[1]: factor}, hangs=[relays[0]],
                              known_ids=net.nodes.keys())
    _compare_defense(
        "stragglers: 1 hung + 1 pathologically slow relay",
        model, dict(deadline_defense=True), dict(deadline_defense=False))


def scenario_byzantine():
    # one corrupt relay; the (simulated) screen detects contributions
    # whose chains cross it, reports drop its reputation below the
    # quarantine threshold, and the next plan routes around it
    def model(net):
        victim = net.stage_nodes(1)[0].id
        return CorruptGradientChurn([victim], mode="perturb", scale=1.0,
                                    seed=7, known_ids=net.nodes.keys())
    d, u, net = _compare_defense(
        "byzantine: 1 corrupt-gradient relay (perturb x1.0)",
        model, dict(corrupt_screen=True), dict(corrupt_screen=False))
    victim = net.stage_nodes(1)[0].id
    print(f"  corrupt relay {victim}: reputation "
          f"{net.reputation(victim):.3f}"
          f"{'  [quarantined]' if net.quarantined(victim) else ''}")


SCENARIOS = {
    "bernoulli": scenario_bernoulli,
    "regional": scenario_regional,
    "trace": scenario_trace,
    "straggler": scenario_straggler,
    "byzantine": scenario_byzantine,
}


def main(argv=None):
    names = (argv if argv else None) or list(SCENARIOS)
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        raise SystemExit(f"unknown scenario(s) {unknown}; "
                         f"pick from {sorted(SCENARIOS)}")
    for name in names:
        SCENARIOS[name]()


if __name__ == "__main__":
    main(sys.argv[1:])
