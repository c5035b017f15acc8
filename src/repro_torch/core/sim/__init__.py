"""Layered discrete-event simulation engine (paper Sec. VI).

Layers, each its own module:

* `engine` — the fast event core (`SimulationEngine`): typed event
  records on an array-backed calendar, batched cost lookups resolved
  against `FlowNetwork`'s cached Eq. 1 matrices, per-iteration event
  accounting;
* `policies` — the scheduler layer (`RoutingPolicy`): plan paths,
  reroute on forward faults, recover backward faults; GWTF, SWARM and
  fixed-schedule implementations;
* `faults` — the fault layer (`ChurnModel`): Bernoulli coin-flips,
  trace replay, correlated regional outages, and compositions;
* `metrics` — Table II/III columns plus queue-depth / reroute /
  event-accounting series (`IterationMetrics`, `summarize`);
* `facade` — the drop-in `TrainingSimulator` wrapper the rest of the
  repo imports (also re-exported by `repro.core.simulator`);
* `reference` — the pre-refactor monolithic loop, frozen for
  `benchmarks/bench_sim.py` events/sec comparisons.
"""
from repro_torch.core.sim.engine import SimulationEngine
from repro_torch.core.sim.facade import TrainingSimulator
from repro_torch.core.sim.faults import (AdversarialPlan, BernoulliChurn,
                                   ChurnContext, ChurnModel, ComposedChurn,
                                   CorruptGradientChurn, FlakyLinkChurn,
                                   LinkDegradationChurn, RegionalOutageChurn,
                                   StragglerChurn, TraceChurn,
                                   adversarial_plan)
from repro_torch.core.sim.metrics import IterationMetrics, ModelProfile, summarize
from repro_torch.core.sim.policies import (FixedPolicy, GWTFPolicy, RoutingPolicy,
                                     SwarmPolicy, make_policy)
from repro_torch.core.sim.timeline import (FaultRecord, FaultTimeline,
                                     record_injections)

__all__ = [
    "SimulationEngine", "TrainingSimulator",
    "AdversarialPlan", "BernoulliChurn", "ChurnContext", "ChurnModel",
    "ComposedChurn", "CorruptGradientChurn", "FlakyLinkChurn",
    "LinkDegradationChurn", "RegionalOutageChurn", "StragglerChurn",
    "TraceChurn", "adversarial_plan",
    "FaultRecord", "FaultTimeline", "record_injections",
    "IterationMetrics", "ModelProfile", "summarize",
    "FixedPolicy", "GWTFPolicy", "RoutingPolicy", "SwarmPolicy",
    "make_policy",
]
