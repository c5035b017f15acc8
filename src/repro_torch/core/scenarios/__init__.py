"""Scenario corpus + cross-layer differential harness.

One declarative `ScenarioSpec` (spec) deterministically materializes
the same training scenario for every execution layer in the repo
(generate): the GWTF flow engines and the `MinCostFlow` oracle, the
discrete-event simulator, and the reduced real-compute runtime.  The
differential/metamorphic harness (harness) checks the layers against
each other, and the committed corpus (corpus) pins ~12 named
scenarios — the paper's Table II/III regimes plus geo failure modes —
with golden metrics.
"""
from repro_torch.core.scenarios.spec import (CHURN_CLAUSES,
                                       DETERMINISTIC_CLAUSES, ScenarioSpec)

__all__ = ["ScenarioSpec", "CHURN_CLAUSES", "DETERMINISTIC_CLAUSES"]
