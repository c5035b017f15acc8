"""One scenario, three engines: tour of the cross-layer harness.

The PyTorch port's counterpart of ``examples/scenario_tour.py``.  Picks a
named scenario from the port's copy of the corpus and drives it through
every execution layer, printing what each one saw and the differential
checks tying them together:

1. **flow layer** — the batched `GWTFProtocol`, its strict scalar
   mode and the frozen reference engine build the same plan
   bit-for-bit; the `MinCostFlow` oracle prices the optimum;
2. **simulator** — the discrete-event engine times the scenario's
   iterations under the spec's churn program (Table II/III columns);
3. **real compute** (``--runtime``) — the port's staged runtime trains a
   reduced model through the *same* churn program on ``--device`` (the
   GPU unless ``--device cpu`` is given), and the harness checks its
   plans and fault accounting against the simulator's.

The first two layers are numpy and run anywhere; only ``--runtime``
touches the device.

    PYTHONPATH=src python examples/torch_scenario_tour.py
    PYTHONPATH=src python examples/torch_scenario_tour.py geo-regional-blackout
    PYTHONPATH=src python examples/torch_scenario_tour.py trace-crash-rejoin --runtime
    PYTHONPATH=src python examples/torch_scenario_tour.py --list
"""
import argparse
import sys

from repro_torch import resolve_device
from repro_torch.core.scenarios import generate
from repro_torch.core.scenarios.corpus import load_corpus
from repro_torch.core.scenarios.harness import (check_flow_equivalence,
                                                check_optimal_consistency,
                                                check_sim_runtime_consistency)
from repro_torch.core.sim.metrics import summarize


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("name", nargs="?", default="table2-het-churn10")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--runtime", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the device --runtime trains on: cuda (the default; "
                         "a missing GPU is an error) or cpu")
    args = ap.parse_args(argv)
    if args.list:
        for spec in load_corpus():
            kinds = ",".join(c["kind"] for c in spec.churn) or "no churn"
            print(f"{spec.name:28s} {spec.topology:9s} {kinds}")
        return
    device = resolve_device(args.device) if args.runtime else None
    spec = next(s for s in load_corpus() if s.name == args.name)
    print(f"=== scenario {spec.name!r} ===")
    print(f"  {spec.topology} topology, {spec.num_stages} stages x "
          f"{spec.relays_per_stage} relays, {spec.num_data_nodes} data "
          f"node(s), churn program: "
          f"{[c['kind'] for c in spec.churn] or 'none'}")

    print("\n[flow] batched vs strict vs reference (bit-equality gate)")
    rep = check_flow_equivalence(spec)
    print(f"  all three engines agree: {rep['flows']} chains, "
          f"total cost {rep['total_cost']:.2f} "
          f"(+ crash/rejoin episode on {rep['churn_episode']})")
    opt = check_optimal_consistency(spec)
    print(f"  centralized optimum: flow {opt['flow']:.0f}, "
          f"cost {opt['cost']:.2f}")

    print("\n[sim] discrete-event run")
    table = summarize(generate.run_sim(spec), warmup=1)
    for col in ("time_per_mb", "throughput", "wasted_gpu", "reroutes"):
        mean, std = table[col]
        print(f"  {col:14s} {mean:10.3f} +- {std:.3f}")

    if args.runtime:
        print("\n[runtime] real-compute differential vs the simulator")
        rep = check_sim_runtime_consistency(
            spec.replace(iterations=min(spec.iterations, 3)), device=device)
        print(f"  plans identical across layers for "
              f"{rep['iterations']} iterations; "
              f"runtime repaired {rep['runtime_rerouted']} microbatches "
              f"(sim rerouted {rep['sim_reroutes']})")
    else:
        print("\n(pass --runtime for the real-compute differential; "
              "needs PyTorch)")


if __name__ == "__main__":
    main(sys.argv[1:])
