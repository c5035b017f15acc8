"""Declarative scenario specification (the corpus' single source of truth).

A `ScenarioSpec` names everything the three execution layers need to
materialize *the same* training scenario deterministically:

* topology — geo-distributed (paper Sec. VI: 10 locations, 50-500 Mb/s
  links, heterogeneous compute), abstract synthetic (paper Tables
  IV/V: integer d_ij drawn directly), or geo-abstract (bench_scale's
  internet-scale shape: integer per-location-pair base costs + node
  jitter with ``Node.location`` stamped, so the hierarchical planner
  and location-keyed churn both apply at 1000+ relays), node counts,
  capacity ranges, per-region compute/bandwidth heterogeneity, and a
  pool of *spare* nodes (created dead) for flash-crowd joins;
* churn program — an ordered list of clauses composed into one
  `ChurnModel`: Bernoulli coin-flips, deterministic trace replay,
  scripted regional blackouts, correlated regional outages,
  flash-crowd joins, link degradation;
* model family and run shape — the reduced model config the
  real-compute runtime trains, the simulator profile derived from it,
  iterations and per-data-node microbatch provisioning;
* seed — every random draw in the generator is keyed on
  ``(spec.seed, fixed salt)`` so the same spec always materializes the
  same networks, plans and faults across the flow, sim, and runtime
  layers.

Specs round-trip through plain dicts/JSON (`to_dict` / `from_dict`);
`from_dict` rejects unknown fields and `validate()` rejects
out-of-range or cross-field-inconsistent values, so a corpus file that
drifts from the schema fails loudly instead of silently running a
different scenario.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

#: churn clause schema: kind -> (required fields, {optional: default}).
CHURN_CLAUSES: Dict[str, Tuple[Tuple[str, ...], Dict[str, Any]]] = {
    # independent per-relay crash/rejoin coin flips (paper Sec. VI)
    "bernoulli": (("p",), {}),
    # deterministic replay: events = [[iteration, "crash"|"rejoin",
    # node_id(, when)], ...]
    "trace": (("events",), {}),
    # scripted blackout: every relay in `location` crashes at
    # `at_iteration` (fraction `when` into it), rejoins `duration`
    # iterations later
    "regional_blackout": (("location", "at_iteration"),
                          {"duration": 2, "when": 0.25}),
    # correlated random outages keyed on Node.location
    "regional_outage": (("outage_prob",),
                        {"severity": 1.0, "rejoin_prob": 0.5}),
    # `nodes` spare relays (pre-created dead) join at `at_iteration`
    "flash_crowd": (("at_iteration", "nodes"), {}),
    # inter-region bandwidth divided by `factor` at `at_iteration`,
    # restored `duration` iterations later (0 = permanent)
    "link_degradation": (("at_iteration", "factor"),
                         {"duration": 0, "inter_region_only": True}),
    # beyond fail-stop (adversarial fault classes) -----------------
    # `nodes` stay alive but compute `factor`x slower (hang=True: stall
    # forever — only a sender-side deadline catches them) inside the
    # window [at_iteration, at_iteration+duration) (duration 0 = forever)
    "straggler": (("nodes",),
                  {"factor": 4.0, "hang": False,
                   "at_iteration": 0, "duration": 0}),
    # `nodes` complete backward on time but return perturbed gradients
    # (mode: "sign_flip" | "zero" | "perturb"; "perturb" adds
    # N(0, scale^2) noise seeded on (seed, iteration, microbatch, stage))
    "corrupt_gradient": (("nodes",),
                         {"mode": "perturb", "scale": 1.0, "seed": 0,
                          "at_iteration": 0, "duration": 0}),
    # every relay-to-relay transfer leg independently fails to arrive
    # with probability `p` (counter-based coin on (seed, iteration,
    # microbatch, leg), so replay is exact and no shared stream is read)
    "flaky_link": (("p",),
                   {"seed": 0, "at_iteration": 0, "duration": 0}),
}

#: clause kinds that draw no randomness (replayable / analyzable exactly)
#: — the adversarial clauses qualify because their noise/coins are
#: counter-based on their own embedded seeds, not the shared policy
#: stream
DETERMINISTIC_CLAUSES = frozenset(
    {"trace", "regional_blackout", "flash_crowd", "link_degradation",
     "straggler", "corrupt_gradient", "flaky_link"})

#: the beyond-fail-stop fault classes: clauses the defense
#: layer (deadline + gradient screen + reputation quarantine) targets
ADVERSARIAL_CLAUSES = frozenset(
    {"straggler", "corrupt_gradient", "flaky_link"})

#: clause kinds that need real link bandwidth (geo topology only)
GEO_ONLY_CLAUSES = frozenset({"link_degradation"})

#: clause kinds keyed on Node.location (any topology that stamps it)
LOCATION_CLAUSES = frozenset({"regional_blackout", "regional_outage"})

#: topologies whose nodes carry a real Node.location
LOCATED_TOPOLOGIES = frozenset({"geo", "geo-abstract"})

#: arrival clause schema: kind -> (required fields, {optional: default}).
#: Arrival programs describe the *open-loop* decode request traffic the
#: serving plane must absorb (the serving analogue of the churn
#: program).  Every clause is deterministic by construction: the random
#: kinds draw from ``np.random.default_rng([clause seed, iteration,
#: clause index])`` — counter-based, never the shared policy stream —
#: so the same spec always replays the same request trace across the
#: sim and runtime layers (the serving differential tier depends on
#: this).  ``at_iteration``/``duration`` window a clause the same way
#: the adversarial churn clauses are windowed (duration 0 = forever).
ARRIVAL_CLAUSES: Dict[str, Tuple[Tuple[str, ...], Dict[str, Any]]] = {
    # Poisson(rate) new requests per iteration, offsets ~ U[0, 1)
    "poisson": (("rate",),
                {"seed": 0, "at_iteration": 0, "duration": 0}),
    # diurnal load: Poisson whose rate swings sinusoidally between
    # `low_scale`*rate and rate with period `period` iterations
    "diurnal": (("rate", "period"),
                {"low_scale": 0.25, "seed": 0,
                 "at_iteration": 0, "duration": 0}),
    # flash-crowd spike: exactly `requests` arrivals at `at_iteration`,
    # evenly spread over the first `when` fraction of the iteration
    "spike": (("at_iteration", "requests"), {"when": 0.25}),
}


@dataclass
class ScenarioSpec:
    """One scenario, materializable as a flow problem, a simulated
    training run, and a reduced real-compute training run."""

    name: str
    seed: int = 0
    #: "standard" (default corpus) or "scale" — bench_scale-style
    #: topologies at 1000+ relays; swept with the restricted check set
    #: (harness.scale_checks), never the real-compute differentials
    tier: str = "standard"

    # ---- topology -----------------------------------------------------
    topology: str = "geo"        # "geo" | "synthetic" | "geo-abstract"
    num_stages: int = 4
    relays_per_stage: int = 4
    num_data_nodes: int = 2
    data_capacity: int = 4
    capacity_range: Tuple[int, int] = (1, 4)   # relay cap ~ int(U[lo, hi))
    num_locations: int = 10                     # geo only
    compute_cost: float = 6.0                   # geo: mean sec/microbatch
    compute_jitter: float = 0.3                 # geo: per-node jitter
    min_bandwidth: float = 50e6 / 8             # geo: inter-location floor
    max_bandwidth: float = 500e6 / 8            # geo: intra-location links
    region_compute_scale: Optional[List[float]] = None   # geo: c_i multiplier
    region_bandwidth_scale: Optional[List[float]] = None  # geo: bw multiplier
    cost_range: Tuple[int, int] = (1, 20)       # synthetic: integer d_ij
    source_capacity: int = 4                    # synthetic source capacity
    spare_nodes: int = 0                        # flash-crowd pool (geo)

    # ---- churn program ------------------------------------------------
    churn: List[Dict[str, Any]] = field(default_factory=list)

    # ---- compression clause (per-link wire-codec co-optimization) -----
    #: ``{"menu": [codec names], "fidelity_budget": float,
    #:   "fidelity_weight": float (optional)}`` — the wire-codec menu
    #: the planner prices per link (flow.graph.WIRE_CODECS names; must
    #: include "fp32" as the lossless fallback), the scenario-level
    #: fidelity budget gating admissibility, and the optional
    #: seconds-per-unit-distortion weight.  ``None`` = fp32 everywhere
    #: (bit-identical to the pre-codec stack).  Geo topology only: the
    #: abstract topologies store d_ij directly (infinite bandwidth), so
    #: codec pricing would be degenerate there.
    compression: Optional[Dict[str, Any]] = None

    # ---- serving plane (decode traffic routed through the flow engine)
    #: open-loop request-arrival program (see ARRIVAL_CLAUSES); an empty
    #: list means the spec has no serving plane and none of the serving
    #: layers/checks apply — bit-identical to the pre-serving stack.
    arrivals: List[Dict[str, Any]] = field(default_factory=list)
    prompt_len: int = 8            # tokens prefilled per request
    gen_tokens: int = 8            # tokens decoded per request
    serve_batch: int = 4           # continuous-batching width per chain
    #: Eq. 1 surcharge (seconds-equivalent) per KV-resident sequence on
    #: a destination node — prices loaded nodes out of new chain plans.
    #: 0.0 keeps the flow network's trivial (bit-identical) state.
    kv_weight: float = 0.0

    # ---- run shape ----------------------------------------------------
    iterations: int = 6
    scheduler: str = "gwtf"                     # "gwtf" | "swarm"
    objective: str = "minmax"                   # GWTF refinement objective

    # ---- model family (runtime + simulator profile) -------------------
    model: str = "gwtf-llama-300m"
    model_layers: int = 4
    model_d: int = 128
    model_vocab: int = 256
    seq_len: int = 64
    microbatch_size: int = 2
    microbatches: int = 4                       # per data node per iteration

    # ------------------------------------------------------------------
    @property
    def num_relays(self) -> int:
        return self.num_stages * self.relays_per_stage

    @property
    def base_nodes(self) -> int:
        """Node count before the spare (flash-crowd) pool."""
        return self.num_data_nodes + self.num_relays

    @property
    def deterministic_churn(self) -> bool:
        """True iff every churn clause replays without RNG draws."""
        return all(c.get("kind") in DETERMINISTIC_CLAUSES
                   for c in self.churn)

    @property
    def has_arrivals(self) -> bool:
        """True iff the spec carries a serving plane (arrival program)."""
        return bool(self.arrivals)

    # ------------------------------------------------------------------
    def validate(self) -> "ScenarioSpec":
        """Raise ``ValueError`` on any inconsistent field; returns self."""
        if not self.name or not isinstance(self.name, str):
            raise ValueError("scenario name must be a non-empty string")
        if self.topology not in ("geo", "synthetic", "geo-abstract"):
            raise ValueError(
                f"{self.name}: unknown topology {self.topology!r} "
                f"(expected 'geo' | 'synthetic' | 'geo-abstract')")
        if self.tier not in ("standard", "scale"):
            raise ValueError(f"{self.name}: unknown tier {self.tier!r} "
                             f"(expected 'standard' | 'scale')")
        if self.scheduler not in ("gwtf", "swarm"):
            raise ValueError(
                f"{self.name}: unknown scheduler {self.scheduler!r} "
                f"(expected 'gwtf' | 'swarm')")
        if self.objective not in ("minmax", "sum"):
            raise ValueError(f"{self.name}: unknown objective "
                             f"{self.objective!r}")
        for fld, lo in (("num_stages", 1), ("relays_per_stage", 1),
                        ("num_data_nodes", 1), ("data_capacity", 1),
                        ("num_locations", 1), ("iterations", 1),
                        ("microbatches", 1), ("microbatch_size", 1),
                        ("seq_len", 1), ("spare_nodes", 0),
                        ("prompt_len", 1), ("gen_tokens", 1),
                        ("serve_batch", 1)):
            v = getattr(self, fld)
            if not isinstance(v, int) or v < lo:
                raise ValueError(f"{self.name}: {fld}={v!r} must be an "
                                 f"int >= {lo}")
        for rng_fld in ("capacity_range", "cost_range"):
            lo, hi = getattr(self, rng_fld)
            if not (lo >= 1 and hi > lo):
                raise ValueError(f"{self.name}: {rng_fld}=({lo}, {hi}) "
                                 f"must satisfy 1 <= lo < hi")
        for scale_fld in ("region_compute_scale", "region_bandwidth_scale"):
            scale = getattr(self, scale_fld)
            if scale is None:
                continue
            if self.topology != "geo":
                raise ValueError(f"{self.name}: {scale_fld} requires the "
                                 f"geo topology")
            if len(scale) != self.num_locations:
                raise ValueError(
                    f"{self.name}: {scale_fld} has {len(scale)} entries "
                    f"for {self.num_locations} locations")
            if any(s <= 0 for s in scale):
                raise ValueError(f"{self.name}: {scale_fld} entries must "
                                 f"be positive")
        if self.spare_nodes and self.topology != "geo":
            raise ValueError(f"{self.name}: spare_nodes (flash crowd) "
                             f"requires the geo topology")
        if not isinstance(self.kv_weight, (int, float)) or self.kv_weight < 0:
            raise ValueError(f"{self.name}: kv_weight={self.kv_weight!r} "
                             f"must be a number >= 0")
        self._validate_compression()
        self._validate_churn()
        self._validate_arrivals()
        return self

    def _validate_compression(self) -> None:
        if self.compression is None:
            return
        from repro_torch.core.flow.graph import WIRE_CODECS
        c = self.compression
        if not isinstance(c, dict):
            raise ValueError(f"{self.name}: compression must be a dict")
        unknown = set(c) - {"menu", "fidelity_budget", "fidelity_weight"}
        if unknown:
            raise ValueError(f"{self.name}: compression has unknown "
                             f"field(s) {sorted(unknown)}")
        if self.topology != "geo":
            raise ValueError(f"{self.name}: compression requires the geo "
                             f"topology (abstract d_ij links have no "
                             f"bandwidth for a codec to save)")
        menu = c.get("menu")
        if not isinstance(menu, (list, tuple)) or not menu:
            raise ValueError(f"{self.name}: compression.menu must be a "
                             f"non-empty list of codec names")
        bad = [n for n in menu if n not in WIRE_CODECS]
        if bad:
            raise ValueError(f"{self.name}: compression.menu has unknown "
                             f"codec(s) {bad} (known: "
                             f"{sorted(WIRE_CODECS)})")
        if "fp32" not in menu:
            raise ValueError(f"{self.name}: compression.menu must include "
                             f"'fp32' (the lossless fallback)")
        budget = c.get("fidelity_budget", 0.0)
        if not isinstance(budget, (int, float)) or budget < 0:
            raise ValueError(f"{self.name}: compression.fidelity_budget="
                             f"{budget!r} must be a number >= 0")
        weight = c.get("fidelity_weight", 1.0)
        if not isinstance(weight, (int, float)) or weight < 0:
            raise ValueError(f"{self.name}: compression.fidelity_weight="
                             f"{weight!r} must be a number >= 0")

    def _validate_churn(self) -> None:
        flash_total = 0
        for i, clause in enumerate(self.churn):
            if not isinstance(clause, dict):
                raise ValueError(f"{self.name}: churn[{i}] must be a dict")
            kind = clause.get("kind")
            if kind not in CHURN_CLAUSES:
                raise ValueError(
                    f"{self.name}: churn[{i}] has unknown kind {kind!r} "
                    f"(expected one of {sorted(CHURN_CLAUSES)})")
            required, optional = CHURN_CLAUSES[kind]
            fields = set(clause) - {"kind"}
            missing = set(required) - fields
            unknown = fields - set(required) - set(optional)
            if missing:
                raise ValueError(f"{self.name}: churn[{i}] ({kind}) is "
                                 f"missing field(s) {sorted(missing)}")
            if unknown:
                raise ValueError(f"{self.name}: churn[{i}] ({kind}) has "
                                 f"unknown field(s) {sorted(unknown)}")
            if kind in GEO_ONLY_CLAUSES and self.topology != "geo":
                raise ValueError(f"{self.name}: churn[{i}] ({kind}) "
                                 f"requires the geo topology")
            if kind in LOCATION_CLAUSES \
                    and self.topology not in LOCATED_TOPOLOGIES:
                raise ValueError(f"{self.name}: churn[{i}] ({kind}) "
                                 f"requires a geo topology")
            if kind == "bernoulli" and not 0.0 <= clause["p"] <= 1.0:
                raise ValueError(f"{self.name}: churn[{i}] p={clause['p']} "
                                 f"out of [0, 1]")
            if kind == "flash_crowd":
                flash_total += int(clause["nodes"])
            if kind == "regional_blackout" and not (
                    0 <= clause["location"] < self.num_locations):
                raise ValueError(
                    f"{self.name}: churn[{i}] location={clause['location']} "
                    f"out of range for {self.num_locations} locations")
            if kind == "link_degradation" and clause["factor"] <= 0:
                raise ValueError(f"{self.name}: churn[{i}] factor must be "
                                 f"positive")
            if kind in ("straggler", "corrupt_gradient"):
                nodes = clause["nodes"]
                if (not isinstance(nodes, (list, tuple)) or not nodes
                        or not all(isinstance(n, int) and 0 <= n
                                   for n in nodes)):
                    raise ValueError(
                        f"{self.name}: churn[{i}] ({kind}) nodes must be a "
                        f"non-empty list of node ids (ints >= 0)")
                hi_id = self.base_nodes + self.spare_nodes
                bad = [n for n in nodes if n >= hi_id]
                if bad:
                    raise ValueError(
                        f"{self.name}: churn[{i}] ({kind}) names node(s) "
                        f"{bad} outside the topology's {hi_id} node ids")
            if kind in ADVERSARIAL_CLAUSES:
                at = clause.get("at_iteration", 0)
                dur = clause.get("duration", 0)
                if not isinstance(at, int) or at < 0:
                    raise ValueError(f"{self.name}: churn[{i}] ({kind}) "
                                     f"at_iteration={at!r} must be an "
                                     f"int >= 0")
                if not isinstance(dur, int) or dur < 0:
                    raise ValueError(f"{self.name}: churn[{i}] ({kind}) "
                                     f"duration={dur!r} must be an "
                                     f"int >= 0")
            if kind == "straggler":
                factor = clause.get("factor", 4.0)
                if not isinstance(factor, (int, float)) or factor < 1.0:
                    raise ValueError(f"{self.name}: churn[{i}] (straggler) "
                                     f"factor={factor!r} must be >= 1")
            if kind == "corrupt_gradient":
                from repro_torch.core.sim.faults import CorruptGradientChurn
                mode = clause.get("mode", "perturb")
                if mode not in CorruptGradientChurn.MODES:
                    raise ValueError(
                        f"{self.name}: churn[{i}] (corrupt_gradient) "
                        f"mode={mode!r} not in "
                        f"{sorted(CorruptGradientChurn.MODES)}")
                scale = clause.get("scale", 1.0)
                if not isinstance(scale, (int, float)) or scale <= 0:
                    raise ValueError(
                        f"{self.name}: churn[{i}] (corrupt_gradient) "
                        f"scale={scale!r} must be > 0")
            if kind == "flaky_link" and not 0.0 <= clause["p"] <= 1.0:
                raise ValueError(f"{self.name}: churn[{i}] p={clause['p']} "
                                 f"out of [0, 1]")
        if flash_total > self.spare_nodes:
            raise ValueError(
                f"{self.name}: flash_crowd clauses join {flash_total} nodes "
                f"but only spare_nodes={self.spare_nodes} are provisioned")

    def _validate_arrivals(self) -> None:
        for i, clause in enumerate(self.arrivals):
            if not isinstance(clause, dict):
                raise ValueError(f"{self.name}: arrivals[{i}] must be a "
                                 f"dict")
            kind = clause.get("kind")
            if kind not in ARRIVAL_CLAUSES:
                raise ValueError(
                    f"{self.name}: arrivals[{i}] has unknown kind {kind!r} "
                    f"(expected one of {sorted(ARRIVAL_CLAUSES)})")
            required, optional = ARRIVAL_CLAUSES[kind]
            fields = set(clause) - {"kind"}
            missing = set(required) - fields
            unknown = fields - set(required) - set(optional)
            if missing:
                raise ValueError(f"{self.name}: arrivals[{i}] ({kind}) is "
                                 f"missing field(s) {sorted(missing)}")
            if unknown:
                raise ValueError(f"{self.name}: arrivals[{i}] ({kind}) has "
                                 f"unknown field(s) {sorted(unknown)}")
            if kind in ("poisson", "diurnal"):
                rate = clause["rate"]
                if not isinstance(rate, (int, float)) or rate < 0:
                    raise ValueError(f"{self.name}: arrivals[{i}] ({kind}) "
                                     f"rate={rate!r} must be a number >= 0")
                at = clause.get("at_iteration", 0)
                dur = clause.get("duration", 0)
                for fld, v in (("at_iteration", at), ("duration", dur)):
                    if not isinstance(v, int) or v < 0:
                        raise ValueError(
                            f"{self.name}: arrivals[{i}] ({kind}) "
                            f"{fld}={v!r} must be an int >= 0")
            if kind == "diurnal":
                period = clause["period"]
                if not isinstance(period, int) or period < 1:
                    raise ValueError(f"{self.name}: arrivals[{i}] (diurnal) "
                                     f"period={period!r} must be an "
                                     f"int >= 1")
                low = clause.get("low_scale", 0.25)
                if not isinstance(low, (int, float)) or not 0 <= low <= 1:
                    raise ValueError(f"{self.name}: arrivals[{i}] (diurnal) "
                                     f"low_scale={low!r} out of [0, 1]")
            if kind == "spike":
                at = clause["at_iteration"]
                reqs = clause["requests"]
                if not isinstance(at, int) or at < 0:
                    raise ValueError(f"{self.name}: arrivals[{i}] (spike) "
                                     f"at_iteration={at!r} must be an "
                                     f"int >= 0")
                if not isinstance(reqs, int) or reqs < 1:
                    raise ValueError(f"{self.name}: arrivals[{i}] (spike) "
                                     f"requests={reqs!r} must be an "
                                     f"int >= 1")
                when = clause.get("when", 0.25)
                if not isinstance(when, (int, float)) or not 0 < when <= 1:
                    raise ValueError(f"{self.name}: arrivals[{i}] (spike) "
                                     f"when={when!r} out of (0, 1]")

    # ------------------------------------------------------------------
    # dict / JSON round-trip
    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["capacity_range"] = list(self.capacity_range)
        d["cost_range"] = list(self.cost_range)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ScenarioSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"scenario {d.get('name', '<unnamed>')!r}: unknown "
                f"field(s) {sorted(unknown)} — the spec schema is "
                f"documented in scenarios/README.md")
        kwargs = dict(d)
        for rng_fld in ("capacity_range", "cost_range"):
            if rng_fld in kwargs:
                kwargs[rng_fld] = tuple(kwargs[rng_fld])
        spec = cls(**kwargs)
        return spec.validate()

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ScenarioSpec":
        return cls.from_dict(json.loads(text))

    def replace(self, **changes) -> "ScenarioSpec":
        """Functional update (used by the fuzz shrinker); validates."""
        return dataclasses.replace(self, **changes).validate()
