"""Shared fault timeline: one deterministic record of every fault.

Both execution layers — the discrete-event simulator
(`sim/engine.py`) and the staged runtime (`runtime/recovery.py` via
`runtime/trainer.py`) — consume the same `ChurnModel` stream.  This
module gives them one vocabulary for what that stream *did*: a
`FaultTimeline` is an append-only list of `FaultRecord`s stamped with
the logical iteration index (never wall-clock — the simulator runs on
an event clock, the runtime on a normalized pipeline-flush clock, and
only the iteration index is shared).

Record kinds:

* ``injection`` — the fault model put a fault into the world
  (a crash scheduled, a node entering a straggler/hang window, a node
  marked gradient-corrupting, a flaky-link episode becoming active).
  Injections are recorded by `record_injections` from the model's own
  per-iteration outputs, so the two layers produce *identical*
  injection records by construction.
* ``detection`` — the defense layer noticed the fault (a deadline
  fired on a hung relay, the gradient screen flagged a contribution,
  a delivery failure was observed).
* ``repair`` — the response succeeded (the microbatch was re-sent to
  a substitute, the flagged contribution was excluded from the
  update, the flaky leg was retried to completion).

Cross-layer equality contract (enforced by
`scenarios.harness.check_fault_timeline` on deterministic programs):

* per-iteration **injection** counts match for *every* fault class;
* per-iteration **detection/repair** counts match for the
  iteration-granular adversarial classes (``straggler``,
  ``corrupt_gradient``) whose injection windows cover whole
  iterations — every microbatch routed through an afflicted node is
  affected in both layers, so the counts are a function of the
  (bit-equal) plans, not of event timing;
* ``crash`` and ``flaky_link`` detection/repair counts are recorded
  per layer but not cross-compared: they depend on intra-iteration
  event timing (a microbatch may clear a node before its crash time)
  and on per-leg traversal order, which the two clocks model
  differently.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

#: fault classes a record may carry
FAULT_CLASSES = ("crash", "straggler", "corrupt_gradient", "flaky_link")

#: record kinds
KINDS = ("injection", "detection", "repair")

#: fault classes whose detection/repair counts are comparable across
#: layers (iteration-granular injection windows; see module docstring)
CROSS_LAYER_FAULTS = ("straggler", "corrupt_gradient")


@dataclass(frozen=True)
class FaultRecord:
    """One stamped fault event.  ``node`` is -1 when the fault is not
    attributable to a single node (e.g. a link-level episode)."""
    iteration: int
    fault: str
    kind: str
    node: int = -1

    def __post_init__(self):
        if self.fault not in FAULT_CLASSES:
            raise ValueError(f"unknown fault class {self.fault!r}; "
                             f"expected one of {FAULT_CLASSES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown record kind {self.kind!r}; "
                             f"expected one of {KINDS}")


@dataclass
class FaultTimeline:
    """Append-only, deterministic fault record."""
    records: List[FaultRecord] = field(default_factory=list)

    def record(self, iteration: int, fault: str, kind: str,
               node: int = -1) -> None:
        self.records.append(FaultRecord(iteration, fault, kind, node))

    def counts(self, *, kinds: Optional[Iterable[str]] = None,
               faults: Optional[Iterable[str]] = None
               ) -> Dict[Tuple[int, str, str], int]:
        """Per-(iteration, fault, kind) counts, optionally filtered."""
        kinds = set(kinds) if kinds is not None else None
        faults = set(faults) if faults is not None else None
        out: Dict[Tuple[int, str, str], int] = {}
        for r in self.records:
            if kinds is not None and r.kind not in kinds:
                continue
            if faults is not None and r.fault not in faults:
                continue
            key = (r.iteration, r.fault, r.kind)
            out[key] = out.get(key, 0) + 1
        return out

    def comparable_counts(self) -> Dict[Tuple[int, str, str], int]:
        """The subset of counts the cross-layer contract pins: all
        injections, plus detection/repair for `CROSS_LAYER_FAULTS`."""
        out = self.counts(kinds=("injection",))
        out.update(self.counts(kinds=("detection", "repair"),
                               faults=CROSS_LAYER_FAULTS))
        return out

    def __len__(self) -> int:
        return len(self.records)


def record_injections(timeline: FaultTimeline, iteration: int,
                      crashes: Mapping[int, float],
                      plan) -> None:
    """Stamp this iteration's injections from the churn model outputs.

    Called by both the sim engine and the runtime trainer with the
    same ``crashes`` dict (from ``ChurnModel.sample``) and the same
    `AdversarialPlan` (from ``faults.adversarial_plan``), immediately
    after sampling — so the two layers' injection records are
    identical by construction.
    """
    for nid in sorted(crashes):
        timeline.record(iteration, "crash", "injection", nid)
    if plan is None or plan.is_empty():
        return
    for nid in sorted(set(plan.slow) | set(plan.hung)):
        timeline.record(iteration, "straggler", "injection", nid)
    for nid in sorted(plan.corrupt):
        timeline.record(iteration, "corrupt_gradient", "injection", nid)
    for _ in range(plan.flaky_episodes):
        timeline.record(iteration, "flaky_link", "injection", -1)
