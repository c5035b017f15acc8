"""Compatibility facade: the pre-refactor `TrainingSimulator` API.

Thin wrapper assembling the layered engine (`SimulationEngine` +
`RoutingPolicy` + `ChurnModel`) behind the constructor signature every
existing caller uses (`tests/test_simulator.py`, the crash benchmarks,
`examples/churn_recovery.py`).  Seeded runs reproduce the pre-refactor
implementation's RNG stream and metrics exactly on the GWTF and fixed
paths; SWARM differs only by the backward-restart slot-leak fix.

New capabilities are opt-in keyword arguments:

* ``churn_model=`` — any `repro.core.sim.faults.ChurnModel` (trace
  replay, correlated regional outages, compositions); overrides the
  Bernoulli model implied by ``churn=``;
* ``policy=`` — a pre-built `RoutingPolicy`, overriding ``scheduler=``;
* ``max_events=`` — the per-iteration event budget (exhaustion is now
  reported via `IterationMetrics.truncated` + a ``RuntimeWarning``);
* ``plan_overrun_factor=`` / ``plan_overrun_min_seconds=`` — the
  engine's planning-overrun guard: when ``policy.plan()`` wall time
  exceeds the event-loop wall time by the factor (and the absolute
  minimum), the iteration is flagged (`IterationMetrics.plan_overrun`),
  a ``RuntimeWarning`` fires, and the policy's ``throttle_planning()``
  hook (if any) caps further planning effort.

Conflicting keyword combinations used to be resolved by silently
ignoring one side (``churn=`` dropped when ``churn_model=`` was given,
``scheduler=``/``fixed_paths=`` dropped when ``policy=`` was given) —
a scenario spec that set both would run a *different* scenario than it
described.  They now raise ``ValueError``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core.flow.graph import FlowNetwork
from repro_torch.core.sim.engine import SimulationEngine
from repro_torch.core.sim.faults import BernoulliChurn, ChurnModel
from repro_torch.core.sim.metrics import IterationMetrics, ModelProfile
from repro_torch.core.sim.policies import (GWTFPolicy, RoutingPolicy, SwarmPolicy,
                                     make_policy)


class TrainingSimulator:
    def __init__(self, net: FlowNetwork, *,
                 scheduler: Optional[str] = None,
                 profile: Optional[ModelProfile] = None,
                 churn: float = 0.0, timeout: float = 30.0,
                 max_retries: int = 2, fixed_paths=None,
                 rng: Optional[np.random.Generator] = None,
                 churn_model: Optional[ChurnModel] = None,
                 policy: Optional[RoutingPolicy] = None,
                 max_events: int = 500_000,
                 plan_overrun_factor: float = 100.0,
                 plan_overrun_min_seconds: float = 0.5,
                 deadline_defense: bool = True,
                 corrupt_screen: bool = True):
        """scheduler: 'gwtf' (default) | 'swarm' | 'fixed' (preset paths
        — used for the DT-FM optimal-schedule baseline of Table VI)."""
        if churn and churn_model is not None:
            raise ValueError(
                f"churn={churn} and churn_model={churn_model!r} both "
                f"given — the Bernoulli rate would be silently ignored; "
                f"pass exactly one (compose with ComposedChurn instead)")
        if policy is not None:
            if scheduler is not None:
                raise ValueError(
                    f"scheduler={scheduler!r} and policy={policy!r} both "
                    f"given — the scheduler name would be silently "
                    f"ignored; pass exactly one")
            if fixed_paths:
                raise ValueError(
                    "fixed_paths given alongside policy= — they would be "
                    "silently ignored; build the FixedPolicy yourself")
        elif fixed_paths and scheduler != "fixed":
            raise ValueError(
                f"fixed_paths given but scheduler={scheduler!r} — preset "
                f"paths are only consumed by scheduler='fixed'")
        scheduler = scheduler or "gwtf"
        self.net = net
        self.profile = profile or ModelProfile(fwd_compute=2.0)
        self.churn = churn
        self.timeout = timeout
        self.max_retries = max_retries
        self.fixed_paths = fixed_paths or []
        self.rng = rng or np.random.default_rng(0)
        if policy is None:
            policy = make_policy(scheduler, net, rng=self.rng,
                                 fixed_paths=self.fixed_paths)
        self.policy = policy
        self.scheduler = getattr(policy, "name", scheduler)
        # legacy attribute surface
        self.protocol = policy.protocol if isinstance(policy, GWTFPolicy) else None
        self.router = policy.router if isinstance(policy, SwarmPolicy) else None
        self.engine = SimulationEngine(
            net, policy, churn_model=churn_model or BernoulliChurn(churn),
            profile=self.profile, timeout=timeout, max_retries=max_retries,
            rng=self.rng, max_events=max_events,
            plan_overrun_factor=plan_overrun_factor,
            plan_overrun_min_seconds=plan_overrun_min_seconds,
            deadline_defense=deadline_defense,
            corrupt_screen=corrupt_screen)

    def run_iteration(self) -> IterationMetrics:
        return self.engine.run_iteration()

    def run(self, iterations: int) -> List[IterationMetrics]:
        return self.engine.run(iterations)
