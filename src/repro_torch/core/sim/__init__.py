"""Fault and routing layers of the PyTorch port: copies of
``repro.core.sim``'s ``faults``, ``timeline`` and ``policies``.

The event engine (``engine``, ``metrics``, ``facade``) is not copied yet:
it waits for the flow-routed ``ServeTrainer`` (ROADMAP.md, Queue 1).
"""
from repro_torch.core.sim.faults import (AdversarialPlan, BernoulliChurn,
                                         ChurnContext, ChurnModel,
                                         ComposedChurn, CorruptGradientChurn,
                                         FlakyLinkChurn, LinkDegradationChurn,
                                         RegionalOutageChurn, StragglerChurn,
                                         TraceChurn, adversarial_plan)
from repro_torch.core.sim.policies import (FixedPolicy, GWTFPolicy,
                                           RoutingPolicy, SwarmPolicy,
                                           make_policy)
from repro_torch.core.sim.timeline import (FaultRecord, FaultTimeline,
                                           record_injections)

__all__ = [
    "AdversarialPlan", "BernoulliChurn", "ChurnContext", "ChurnModel",
    "ComposedChurn", "CorruptGradientChurn", "FlakyLinkChurn",
    "LinkDegradationChurn", "RegionalOutageChurn", "StragglerChurn",
    "TraceChurn", "adversarial_plan",
    "FaultRecord", "FaultTimeline", "record_injections",
    "FixedPolicy", "GWTFPolicy", "RoutingPolicy", "SwarmPolicy",
    "make_policy",
]
