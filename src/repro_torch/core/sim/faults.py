"""Fault layer: composable churn models for the simulation engine.

A `ChurnModel` decides, at each iteration boundary, which nodes crash
mid-iteration (and when) and which previously-dead nodes rejoin.  The
engine hands it a `ChurnContext` and receives `{node_id: crash_time}`;
rejoins are applied through `ctx.on_rejoin` so the routing policy can
re-admit the node (e.g. `GWTFProtocol.add_node`).

Models:

* `BernoulliChurn` — the paper's Sec. VI experiment: every alive relay
  independently crashes with probability `p` at a uniform time inside
  the iteration; every dead relay rejoins with probability `p`.  RNG
  draw order is kept identical to the pre-refactor simulator so seeded
  runs reproduce.
* `TraceChurn` — deterministic replay of a recorded (or hand-written)
  churn trace: `(iteration, "crash"|"rejoin", node_id[, when])`
  events, `when` given as a fraction of the estimated iteration span.
* `RegionalOutageChurn` — correlated failures keyed on the paper's 10
  geographic locations (`Node.location`): with probability
  `outage_prob` one region suffers an outage and all (or a `severity`
  fraction of) its alive relays crash at the *same* moment; dead
  relays independently rejoin with `rejoin_prob`.
* `ComposedChurn` — applies several models in sequence (union of
  crashes, earliest crash time wins), e.g. background Bernoulli churn
  plus rare regional outages.
* `LinkDegradationChurn` — deterministic link-quality fault: at a
  scripted iteration the (optionally inter-region-only) bandwidth
  matrix is divided by a factor and restored a fixed number of
  iterations later.  Crashes nobody; the fault propagates through the
  Eq. 1 cost caches instead.

Beyond fail-stop (adversarial models; Lu et al., "Exploring the
Robustness of Decentralized Training"):

* `StragglerChurn` — per-node compute slowdown multipliers and hard
  hangs (a hung node accepts work and never finishes it; only a
  deadline can catch it).  Crashes nobody.
* `CorruptGradientChurn` — Byzantine nodes whose backward results are
  sign-flipped / zeroed / perturbed.  Seeded and deterministic; the
  runtime applies the perturbation, the simulator models its
  detection.
* `FlakyLinkChurn` — per-leg Bernoulli delivery failure with a
  counter-based deterministic coin (`leg_ok`), so both execution
  layers see the same drop for the same logical (microbatch, leg,
  attempt) regardless of event ordering.

These return ``{}`` from ``sample`` (they crash nobody) and instead
publish an `AdversarialPlan` via ``adversarial_plan(iteration)`` —
a per-iteration side channel the engine, the runtime recovery sweep
and the trainer's gradient screen probe with
`adversarial_plan(model, iteration)` (duck-typed, so fail-stop models
and the bit-identical default paths are untouched).  All three are
iteration-granular (a fault window covers whole iterations) and draw
from their *own* seeds, never from ``ChurnContext.rng`` — the shared
policy RNG stream stays identical to the fail-stop runs and the
models qualify as deterministic clauses for the differential harness.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Protocol, Sequence, Set, Tuple)

import numpy as np

from repro_torch.core.flow.graph import FlowNetwork, Node


@dataclass
class ChurnContext:
    """What a churn model may observe when sampling one iteration."""
    net: FlowNetwork
    rng: np.random.Generator
    horizon: float                      # estimated iteration span (seconds)
    iteration: int                      # 0-based iteration index
    on_rejoin: Callable[[Node], None]   # notify the routing policy


class ChurnModel(Protocol):
    def sample(self, ctx: ChurnContext) -> Dict[int, float]:
        """Apply rejoins (via ``ctx.on_rejoin``) and return this
        iteration's mid-iteration crashes as {node_id: crash_time}."""
        ...


class BernoulliChurn:
    """Independent per-relay crash/rejoin coin flips (paper Sec. VI).

    Draw order matches the pre-refactor ``TrainingSimulator._apply_churn``
    exactly (one uniform per relay, a second for the crash time), so a
    seeded run through the facade reproduces the seed implementation's
    RNG stream bit-for-bit.
    """

    def __init__(self, p: float):
        self.p = p

    def sample(self, ctx: ChurnContext) -> Dict[int, float]:
        crash_times: Dict[int, float] = {}
        rng, p = ctx.rng, self.p
        for n in list(ctx.net.nodes.values()):
            if n.is_data:
                continue
            if n.alive and rng.uniform() < p:
                crash_times[n.id] = float(rng.uniform(0.0, ctx.horizon))
            elif not n.alive and rng.uniform() < p:
                n.alive = True                     # rejoin, usable this iter
                ctx.on_rejoin(n)
        return crash_times


class TraceChurn:
    """Deterministic replay of a churn trace.

    ``events`` is an iterable of ``(iteration, kind, node_id)`` or
    ``(iteration, kind, node_id, when)`` tuples with ``kind`` in
    {"crash", "rejoin"}; ``when`` is the crash time as a fraction of
    the engine's estimated iteration span (default 0.5).  Events for
    dead nodes ("crash") or alive nodes ("rejoin") are skipped, so a
    trace recorded on one topology replays safely on another.

    ``known_ids`` (when given) validates every event's node id at
    construction: a typo'd id raises ``ValueError`` naming the
    offender immediately instead of the event being silently skipped
    (or a ``KeyError`` surfacing mid-run from a downstream consumer).
    """

    def __init__(self, events: Iterable[Sequence], *,
                 known_ids: Optional[Iterable[int]] = None):
        known = set(known_ids) if known_ids is not None else None
        self._by_iter: Dict[int, List[Tuple[str, int, float]]] = {}
        for ev in events:
            it, kind, nid = int(ev[0]), str(ev[1]), int(ev[2])
            when = float(ev[3]) if len(ev) > 3 else 0.5
            if kind not in ("crash", "rejoin"):
                raise ValueError(f"unknown trace event kind {kind!r}")
            if known is not None and nid not in known:
                raise ValueError(
                    f"trace event {tuple(ev)!r} names unknown node "
                    f"{nid}; known ids are "
                    f"{sorted(known)[:20]}{'...' if len(known) > 20 else ''}")
            self._by_iter.setdefault(it, []).append((kind, nid, when))

    @classmethod
    def regional_blackout(cls, net: FlowNetwork, *, location: int,
                          at_iteration: int, duration: int = 2,
                          when: float = 0.25) -> "TraceChurn":
        """Convenience trace: every relay in ``location`` crashes at
        ``at_iteration`` and rejoins ``duration`` iterations later.

        The location must actually contain relays — a blackout of an
        empty (or misspelled-index) region would silently be a no-op,
        so it raises ``ValueError`` listing the populated locations.
        """
        nids = [n.id for n in net.nodes.values()
                if not n.is_data and n.location == location]
        if not nids:
            present = sorted({n.location for n in net.nodes.values()
                              if not n.is_data and n.location >= 0})
            raise ValueError(
                f"regional_blackout: no relays in location {location}; "
                f"populated locations are {present}")
        events: List[Tuple[int, str, int, float]] = []
        events += [(at_iteration, "crash", nid, when) for nid in nids]
        events += [(at_iteration + duration, "rejoin", nid, 0.0)
                   for nid in nids]
        return cls(events, known_ids=net.nodes.keys())

    def sample(self, ctx: ChurnContext) -> Dict[int, float]:
        crash_times: Dict[int, float] = {}
        for kind, nid, when in self._by_iter.get(ctx.iteration, ()):
            n = ctx.net.nodes.get(nid)
            if n is None or n.is_data:
                continue
            if kind == "crash" and n.alive:
                crash_times[nid] = when * ctx.horizon
            elif kind == "rejoin" and not n.alive:
                n.alive = True
                ctx.on_rejoin(n)
        return crash_times


class RegionalOutageChurn:
    """Correlated regional failures (FusionLLM-style geo outages).

    Each iteration, with probability ``outage_prob`` one geographic
    location (uniform over the locations present among relays) goes
    down: every alive relay there crashes at the *same* uniformly-drawn
    moment (``severity`` < 1 spares each relay independently with
    probability ``1 - severity``).  Dead relays rejoin independently
    with ``rejoin_prob`` per iteration, modelling region recovery.

    Requires ``Node.location`` >= 0 (set by ``geo_distributed_network``);
    relays with unknown location are never hit by outages.
    """

    def __init__(self, outage_prob: float, *, severity: float = 1.0,
                 rejoin_prob: float = 0.5):
        self.outage_prob = outage_prob
        self.severity = severity
        self.rejoin_prob = rejoin_prob

    def sample(self, ctx: ChurnContext) -> Dict[int, float]:
        rng = ctx.rng
        crash_times: Dict[int, float] = {}
        relays = [n for n in ctx.net.nodes.values() if not n.is_data]
        regions = sorted({n.location for n in relays if n.location >= 0})
        if regions and rng.uniform() < self.outage_prob:
            region = regions[int(rng.integers(0, len(regions)))]
            outage_at = float(rng.uniform(0.0, ctx.horizon))
            for n in relays:
                if n.location != region or not n.alive:
                    continue
                if self.severity >= 1.0 or rng.uniform() < self.severity:
                    crash_times[n.id] = outage_at
        if self.rejoin_prob > 0.0:
            for n in relays:
                if not n.alive and rng.uniform() < self.rejoin_prob:
                    n.alive = True
                    ctx.on_rejoin(n)
        return crash_times


class LinkDegradationChurn:
    """Scripted bandwidth degradation (no crashes).

    At ``at_iteration`` every link's bandwidth is divided by ``factor``
    (``inter_region_only=True`` restricts the cut to links whose
    endpoints live in different ``Node.location`` regions — the WAN
    legs of the paper's geo topology); ``duration`` iterations later
    the cut is undone by re-multiplying the degraded entries
    (0 = permanent).  The multiplicative undo composes correctly with
    other concurrent degradations (a snapshot restore would clobber
    them); it is bit-exact for power-of-two factors and within 1 ulp
    otherwise.  The mutation goes
    through ``FlowNetwork.invalidate_costs`` so every consumer of the
    Eq. 1 caches — the GWTF protocol's cost oracle, the engine's
    batched cost tables, the runtime's fault views — sees the change
    on its next query.
    """

    def __init__(self, at_iteration: int, factor: float, *,
                 duration: int = 0, inter_region_only: bool = True):
        if factor <= 0:
            raise ValueError("degradation factor must be positive")
        self.at_iteration = at_iteration
        self.factor = factor
        self.duration = duration
        self.inter_region_only = inter_region_only
        # (size, mask-or-None) of the entries this model degraded; the
        # restore *multiplies them back* rather than restoring a saved
        # matrix, so overlapping degradation windows (e.g. two models in
        # a ComposedChurn) compose and un-compose correctly instead of
        # one model's snapshot clobbering the other's active cut
        self._applied: Optional[Tuple[int, Optional[np.ndarray]]] = None

    def sample(self, ctx: ChurnContext) -> Dict[int, float]:
        net = ctx.net
        if ctx.iteration == self.at_iteration:
            bw = net.bandwidth
            n = bw.shape[0]
            if self.inter_region_only:
                loc = np.full(n, -1, np.int64)
                for nid, node in net.nodes.items():
                    if nid < n:
                        loc[nid] = node.location
                inter = loc[:, None] != loc[None, :]
                bw[inter] /= self.factor
                self._applied = (n, inter)
            else:
                bw /= self.factor
                self._applied = (n, None)
            net.invalidate_costs()
        elif (self.duration and self._applied is not None
              and ctx.iteration == self.at_iteration + self.duration):
            n, mask = self._applied
            # the network may have grown since (joins); undo only the
            # entries the degradation touched
            if mask is None:
                net.bandwidth[:n, :n] *= self.factor
            else:
                sub = net.bandwidth[:n, :n]
                sub[mask] *= self.factor
            self._applied = None
            net.invalidate_costs()
        return {}


# ---------------------------------------------------------------------------
# Adversarial (beyond fail-stop) fault models
# ---------------------------------------------------------------------------

def _check_window(at_iteration: int, duration: int) -> None:
    if at_iteration < 0:
        raise ValueError(f"at_iteration must be >= 0, got {at_iteration}")
    if duration < 0:
        raise ValueError(f"duration must be >= 0 (0 = forever), "
                         f"got {duration}")


def _check_known(ids: Iterable[int],
                 known_ids: Optional[Iterable[int]], what: str) -> None:
    if known_ids is None:
        return
    known = set(known_ids)
    for nid in ids:
        if nid not in known:
            raise ValueError(
                f"{what} names unknown node {nid}; known ids are "
                f"{sorted(known)[:20]}{'...' if len(known) > 20 else ''}")


@dataclass(frozen=True)
class AdversarialPlan:
    """One iteration's adversarial faults, published by a model's
    ``adversarial_plan(iteration)`` side channel.

    * ``slow`` — node id -> compute-time multiplier (> 1 is slower);
    * ``hung`` — nodes that accept work this iteration and never
      finish it (only a deadline catches them);
    * ``corrupt`` — node id -> ``(mode, scale, seed)`` gradient
      corruption spec (mode in {"sign_flip", "zero", "perturb"});
    * ``flaky`` — the `FlakyLinkChurn` models active this iteration;
      a logical leg delivers only if *every* model's ``leg_ok`` coin
      comes up heads.
    """
    slow: Mapping[int, float] = field(default_factory=dict)
    hung: frozenset = frozenset()
    corrupt: Mapping[int, Tuple[str, float, int]] = field(
        default_factory=dict)
    flaky: Tuple["FlakyLinkChurn", ...] = ()

    def is_empty(self) -> bool:
        return not (self.slow or self.hung or self.corrupt or self.flaky)

    @property
    def flaky_episodes(self) -> int:
        return len(self.flaky)

    def slow_factor(self, nid: int) -> float:
        return self.slow.get(nid, 1.0)

    def leg_ok(self, iteration: int, mb_id: int, direction: str,
               position: int, attempt: int) -> bool:
        """Deterministic delivery coin for one logical leg attempt —
        identical across execution layers for the same key."""
        return all(m.leg_ok(iteration, mb_id, direction, position, attempt)
                   for m in self.flaky)

    @staticmethod
    def merge(plans: Sequence[Optional["AdversarialPlan"]]
              ) -> Optional["AdversarialPlan"]:
        live = [p for p in plans if p is not None and not p.is_empty()]
        if not live:
            return None
        if len(live) == 1:
            return live[0]
        slow: Dict[int, float] = {}
        corrupt: Dict[int, Tuple[str, float, int]] = {}
        hung: Set[int] = set()
        flaky: List["FlakyLinkChurn"] = []
        for p in live:
            for nid, f in p.slow.items():
                slow[nid] = slow.get(nid, 1.0) * f   # slowdowns compound
            hung |= p.hung
            for nid, spec in p.corrupt.items():
                corrupt.setdefault(nid, spec)        # first model wins
            flaky.extend(p.flaky)
        return AdversarialPlan(slow=slow, hung=frozenset(hung),
                               corrupt=corrupt, flaky=tuple(flaky))


def adversarial_plan(model, iteration: int) -> Optional[AdversarialPlan]:
    """Probe a churn model's adversarial side channel.  Returns None
    for plain fail-stop models and for iterations outside every fault
    window — the engines fast-path on None and stay bit-identical."""
    probe = getattr(model, "adversarial_plan", None)
    if probe is None:
        return None
    plan = probe(iteration)
    if plan is not None and plan.is_empty():
        return None
    return plan


class _WindowedAdversary:
    """Shared iteration-window plumbing: a fault is active for whole
    iterations ``[at_iteration, at_iteration + duration)`` (duration
    0 = forever).  Iteration granularity is deliberate — it makes the
    affected-microbatch sets a pure function of the (bit-equal) plans,
    so the sim and runtime fault timelines agree exactly."""

    def __init__(self, at_iteration: int, duration: int):
        _check_window(at_iteration, duration)
        self.at_iteration = at_iteration
        self.duration = duration

    def active(self, iteration: int) -> bool:
        if iteration < self.at_iteration:
            return False
        return (self.duration == 0
                or iteration < self.at_iteration + self.duration)

    def sample(self, ctx: ChurnContext) -> Dict[int, float]:
        return {}          # crashes nobody, draws nothing from ctx.rng


class StragglerChurn(_WindowedAdversary):
    """Per-node compute slowdowns and hard hangs.

    ``slowdowns`` maps node id -> multiplier (>= 1) applied to the
    node's forward/backward compute time; ``hangs`` lists nodes that
    accept microbatches and never complete them.  Deadlines are
    stamped from the *healthy* compute estimate, so a hung (or
    pathologically slow) node is caught by the engine/runtime deadline
    defense while mild slowdowns pass undisturbed.
    """

    def __init__(self, slowdowns: Optional[Mapping[int, float]] = None,
                 *, hangs: Iterable[int] = (), at_iteration: int = 0,
                 duration: int = 0,
                 known_ids: Optional[Iterable[int]] = None):
        super().__init__(at_iteration, duration)
        self.slowdowns = {int(k): float(v)
                          for k, v in (slowdowns or {}).items()}
        for nid, f in self.slowdowns.items():
            if f < 1.0:
                raise ValueError(f"slowdown factor for node {nid} must "
                                 f"be >= 1, got {f}")
        self.hangs = frozenset(int(n) for n in hangs)
        _check_known(list(self.slowdowns) + list(self.hangs), known_ids,
                     "StragglerChurn")

    def adversarial_plan(self, iteration: int) -> Optional[AdversarialPlan]:
        if not self.active(iteration):
            return None
        return AdversarialPlan(slow=dict(self.slowdowns), hung=self.hangs)


class CorruptGradientChurn(_WindowedAdversary):
    """Byzantine nodes whose backward results are corrupted.

    ``mode``: "sign_flip" (gradient negated), "zero" (gradient
    dropped to zero), or "perturb" (seeded Gaussian noise of relative
    magnitude ``scale`` added).  The perturbation is applied by the
    runtime trainer to every contribution whose chain crosses a
    corrupt node; the simulator — which carries no gradients — models
    the *detection* of the same contributions, so the two layers'
    fault timelines agree.
    """

    MODES = ("sign_flip", "zero", "perturb")

    def __init__(self, nodes: Iterable[int], *, mode: str = "sign_flip",
                 scale: float = 1.0, seed: int = 0, at_iteration: int = 0,
                 duration: int = 0,
                 known_ids: Optional[Iterable[int]] = None):
        super().__init__(at_iteration, duration)
        if mode not in self.MODES:
            raise ValueError(f"unknown corruption mode {mode!r}; "
                             f"expected one of {self.MODES}")
        if scale <= 0:
            raise ValueError(f"corruption scale must be positive, "
                             f"got {scale}")
        self.nodes = frozenset(int(n) for n in nodes)
        if not self.nodes:
            raise ValueError("CorruptGradientChurn needs >= 1 node")
        self.mode = mode
        self.scale = float(scale)
        self.seed = int(seed)
        _check_known(self.nodes, known_ids, "CorruptGradientChurn")

    def adversarial_plan(self, iteration: int) -> Optional[AdversarialPlan]:
        if not self.active(iteration):
            return None
        spec = (self.mode, self.scale, self.seed)
        return AdversarialPlan(corrupt={nid: spec for nid in self.nodes})


class FlakyLinkChurn(_WindowedAdversary):
    """Per-leg Bernoulli delivery failure.

    Each logical leg attempt — keyed by (iteration, microbatch id,
    direction, chain position, attempt index) — independently fails
    with probability ``p``.  The coin is *counter-based*: a fresh
    generator is seeded from the key, so the decision for a given leg
    is independent of how many other legs either execution layer
    evaluated before it, and both layers see the same drops.
    """

    def __init__(self, p: float, *, seed: int = 0, at_iteration: int = 0,
                 duration: int = 0):
        super().__init__(at_iteration, duration)
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"delivery-failure probability must be in "
                             f"[0, 1], got {p}")
        self.p = float(p)
        self.seed = int(seed)

    def leg_ok(self, iteration: int, mb_id: int, direction: str,
               position: int, attempt: int) -> bool:
        if not self.active(iteration) or self.p <= 0.0:
            return True
        d = 0 if direction == "fwd" else 1
        coin = np.random.default_rng(
            [self.seed, iteration, mb_id, d, position, attempt])
        return float(coin.uniform()) >= self.p

    def adversarial_plan(self, iteration: int) -> Optional[AdversarialPlan]:
        if not self.active(iteration):
            return None
        return AdversarialPlan(flaky=(self,))


class ComposedChurn:
    """Union of several churn models, applied in order.

    Crash sets are merged with the earliest crash time winning; rejoins
    take effect immediately, so a later model sees (and may re-crash)
    nodes an earlier model just revived — matching how independent
    fault processes would interleave in the wild.

    Adversarial side channels compose too: slowdowns compound
    multiplicatively, hang/corrupt sets union, flaky links require
    every member's delivery coin to pass.
    """

    def __init__(self, models: Sequence[ChurnModel]):
        self.models = list(models)

    def sample(self, ctx: ChurnContext) -> Dict[int, float]:
        crash_times: Dict[int, float] = {}
        for model in self.models:
            for nid, t in model.sample(ctx).items():
                if nid not in crash_times or t < crash_times[nid]:
                    crash_times[nid] = t
        return crash_times

    def adversarial_plan(self, iteration: int) -> Optional[AdversarialPlan]:
        return AdversarialPlan.merge(
            [adversarial_plan(m, iteration) for m in self.models])
