"""Discrete-event simulator of decentralized training (paper Sec. VI).

Compatibility shim: the monolithic simulator that used to live here was
refactored into the layered engine package `repro.core.sim` —

* `repro.core.sim.engine`   — fast event core (`SimulationEngine`);
* `repro.core.sim.policies` — pluggable schedulers (`RoutingPolicy`:
  GWTF / SWARM / fixed);
* `repro.core.sim.faults`   — composable churn models (Bernoulli,
  trace replay, correlated regional outages);
* `repro.core.sim.metrics`  — Table II/III columns + engine series;
* `repro.core.sim.facade`   — the `TrainingSimulator` wrapper re-exported
  below, drop-in for the pre-refactor class (seeded GWTF/fixed runs are
  RNG-stream and metric identical; SWARM differs only by the
  backward-restart slot-leak fix).

Import from `repro.core.sim` in new code; this module stays for the
existing callers (tests, benchmarks, examples).
"""
from repro_torch.core.sim import (BernoulliChurn, ComposedChurn,
                            CorruptGradientChurn, FaultTimeline,
                            FlakyLinkChurn, IterationMetrics,
                            LinkDegradationChurn, ModelProfile,
                            RegionalOutageChurn, SimulationEngine,
                            StragglerChurn, TraceChurn, TrainingSimulator,
                            summarize)

__all__ = [
    "TrainingSimulator", "SimulationEngine", "ModelProfile",
    "IterationMetrics", "BernoulliChurn", "TraceChurn",
    "RegionalOutageChurn", "ComposedChurn", "LinkDegradationChurn",
    "StragglerChurn", "CorruptGradientChurn", "FlakyLinkChurn",
    "FaultTimeline", "summarize",
]
