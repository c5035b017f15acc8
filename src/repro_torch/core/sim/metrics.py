"""Metrics layer of the simulation engine (paper Tables II/III columns).

Shared by the fast event core (`repro.core.sim.engine`) and the
pre-refactor reference loop (`repro.core.sim.reference`) so benchmark
comparisons read the same records.

`IterationMetrics` carries the paper's per-iteration columns (duration,
time per microbatch, throughput, communication time, wasted GPU time,
aggregation time) plus the engine's observability fields: processed
event count, event-loop wall time, reroute count, peak/total relay
queue depth, and a `truncated` flag set when the event budget
(`max_events`) was exhausted before the calendar drained — a truncated
iteration reports a *lower bound* on duration, not a clean result.

The serving plane adds `RequestMetrics` (per-decode-request lifecycle:
arrival, first token, completion — TTFT/TPOT derive from these) and
`ServingIterationMetrics` (the per-iteration conservation ledger);
`summarize_serving` pools them into the p50/p99 TTFT/TPOT row the
serving bench and golden files pin.

`summarize` folds a run's iteration list into table-style mean/std
pairs — the Table II/III columns plus the queue-depth and
reroute-count series (used by `examples/churn_recovery.py`; the crash
benchmarks keep their own fold because their cells carry
per-repetition stds in paper units).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class ModelProfile:
    """Per-stage costs derived from a ModelConfig split into stages."""
    fwd_compute: float            # seconds per microbatch per stage (forward)
    bwd_mult: float = 2.0         # backward = bwd_mult * forward
    activation_bytes: float = 4 * 512 * 1024 * 2 * 32
    stage_param_bytes: float = 50e6 * 2

    @classmethod
    def from_config(cls, cfg, *, num_stages: int, microbatch: int = 4,
                    seq_len: int = 512, comm_scale: float = 32.0,
                    flops_per_sec: float = 2.0e13):
        layers_per_stage = max(1, cfg.num_layers // num_stages)
        # 6ND for train fwd+bwd; fwd alone is 2ND
        params_per_layer = (cfg.param_count() - 2 * cfg.vocab_size * cfg.d_model
                            ) / cfg.num_layers
        tokens = microbatch * seq_len
        fwd_flops = 2 * params_per_layer * layers_per_stage * tokens
        act = microbatch * seq_len * cfg.d_model * 2 * comm_scale
        return cls(fwd_compute=fwd_flops / flops_per_sec,
                   activation_bytes=act,
                   stage_param_bytes=params_per_layer * layers_per_stage * 2)


@dataclass
class IterationMetrics:
    duration: float = 0.0
    completed: int = 0
    launched: int = 0
    comm_time: float = 0.0
    wasted_gpu: float = 0.0
    aggregation_time: float = 0.0
    # --- engine observability (new in the layered engine) -------------
    events: int = 0               # calendar pops processed this iteration
    loop_seconds: float = 0.0     # wall time spent inside the event loop
    plan_seconds: float = 0.0     # wall time spent in policy.plan()
    #   (planning vs event-loop split: surfaced by bench_sim --profile)
    reroutes: int = 0             # successful fault reroutes/restarts
    queue_depth_peak: int = 0     # max concurrent queued microbatches
    queue_enqueues: int = 0       # total capacity-wait enqueues
    truncated: bool = False       # max_events exhausted before drain
    plan_overrun: bool = False    # plan_seconds blew past the engine's
    #   plan_overrun_factor x loop_seconds guard (policy was asked to
    #   throttle its planning effort)
    cost_ratio_vs_optimal: Optional[float] = None
    #   live optimality gap: (this iteration's planned-flow cost) /
    #   (dial MinCostFlow oracle cost on the same alive network); None
    #   unless the policy tracks it (GWTFPolicy(track_optimality=True))
    bytes_on_wire: float = 0.0    # encoded bytes actually moved by comm
    #   legs this iteration (= raw activation bytes x the chosen wire
    #   codec's ratio per leg; equals sends * activation_bytes when the
    #   network's codec menu is fp32-only)
    codec_legs: Optional[Dict[str, int]] = None
    #   chosen-codec histogram over comm legs ({codec name: leg count});
    #   None when the menu is trivial (every leg fp32)
    timeouts: int = 0             # deadline (CHECK) fires that found a
    #   stalled microbatch — dead, hung, or dropped-delivery receiver
    retries: int = 0              # recovery attempts spent (bounded by
    #   max_retries per microbatch; includes flaky-leg resends)

    @property
    def time_per_microbatch(self) -> float:
        return self.duration / max(1, self.completed)

    @property
    def events_per_sec(self) -> float:
        return self.events / self.loop_seconds if self.loop_seconds > 0 else 0.0


#: (metric label, per-iteration extractor) pairs for `summarize`.
_COLUMNS = (
    ("time_per_mb", lambda m: m.time_per_microbatch),
    ("throughput", lambda m: float(m.completed)),
    ("comm_time", lambda m: m.comm_time),
    ("wasted_gpu", lambda m: m.wasted_gpu),
    ("aggregation_time", lambda m: m.aggregation_time),
    ("reroutes", lambda m: float(m.reroutes)),
    ("queue_depth_peak", lambda m: float(m.queue_depth_peak)),
    ("queue_enqueues", lambda m: float(m.queue_enqueues)),
    ("bytes_on_wire", lambda m: m.bytes_on_wire),
    ("timeouts", lambda m: float(m.timeouts)),
    ("retries", lambda m: float(m.retries)),
)


def _percentile(xs: List[float], q: float) -> float:
    """Deterministic linear-interpolation percentile (numpy default)."""
    if not xs:
        return 0.0
    return float(np.percentile(np.asarray(xs, dtype=float), q))


@dataclass
class RequestMetrics:
    """One decode request's lifecycle through the serving plane.

    All times are simulated seconds on the engine's global clock.
    ``first_token``/``completion`` stay ``None`` while the request is
    in flight; under the drop-and-retry baseline a restart resets
    ``first_token``, so TTFT always measures arrival to the first token
    of the attempt that ultimately completed (the latency a client
    actually observes).
    """
    rid: int
    arrival: float
    prompt_len: int
    gen_tokens: int
    first_token: Optional[float] = None
    completion: Optional[float] = None
    requeues: int = 0             # defended chain migrations survived
    restarts: int = 0             # drop-and-retry from-scratch attempts
    migrated_kv_bytes: float = 0.0
    dropped: bool = False

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (arrival -> first decoded token)."""
        if self.first_token is None:
            return None
        return self.first_token - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        """Time per output token after the first (steady decode rate)."""
        if self.completion is None or self.first_token is None:
            return None
        if self.gen_tokens <= 1:
            return 0.0
        return (self.completion - self.first_token) / (self.gen_tokens - 1)


@dataclass
class ServingIterationMetrics:
    """Per-iteration serving ledger (the request-conservation unit).

    ``admitted``/``completed``/``dropped`` count events *within* the
    iteration; ``in_flight`` is the end-of-iteration census, so the
    cumulative invariant ``sum(admitted) == sum(completed) +
    sum(dropped) + in_flight`` must hold exactly after every iteration.
    """
    admitted: int = 0
    completed: int = 0
    dropped: int = 0
    in_flight: int = 0            # end-of-iteration census
    queued: int = 0               # subset of in_flight not yet on a chain
    requeues: int = 0             # defended reroutes of live sequences
    restarts: int = 0             # drop-and-retry from-scratch attempts
    migrated_kv_bytes: float = 0.0
    kv_peak: int = 0              # max resident sequences on any node
    ttfts: List[float] = None     # TTFTs of requests completed this iter
    tpots: List[float] = None

    def __post_init__(self):
        if self.ttfts is None:
            self.ttfts = []
        if self.tpots is None:
            self.tpots = []


def summarize_serving(
        metrics: List["ServingIterationMetrics"]) -> Dict[str, float]:
    """Fold a serving run into the bench/golden scalar row.

    Latency percentiles (p50/p99 TTFT and TPOT, simulated seconds) pool
    every completed request across iterations; the counters are run
    totals.  All values are deterministic functions of the spec, so the
    row pins byte-for-byte in golden files.
    """
    ttfts = [t for m in metrics for t in m.ttfts]
    tpots = [t for m in metrics for t in m.tpots]
    return {
        "admitted": float(sum(m.admitted for m in metrics)),
        "completed": float(sum(m.completed for m in metrics)),
        "dropped": float(sum(m.dropped for m in metrics)),
        "in_flight": float(metrics[-1].in_flight) if metrics else 0.0,
        "requeues": float(sum(m.requeues for m in metrics)),
        "restarts": float(sum(m.restarts for m in metrics)),
        "migrated_kv_bytes": float(
            sum(m.migrated_kv_bytes for m in metrics)),
        "kv_peak": float(max((m.kv_peak for m in metrics), default=0)),
        "p50_ttft": _percentile(ttfts, 50.0),
        "p99_ttft": _percentile(ttfts, 99.0),
        "p50_tpot": _percentile(tpots, 50.0),
        "p99_tpot": _percentile(tpots, 99.0),
    }


def summarize(metrics: List[IterationMetrics], *,
              warmup: int = 0) -> Dict[str, Tuple[float, float]]:
    """Fold per-iteration metrics into `{column: (mean, std)}` rows.

    Covers the paper's Table II/III columns plus the engine's
    queue-depth and reroute-count series.  `warmup` iterations are
    dropped from the front (pipeline fill).  Also reports
    `truncated_iterations` as (count, 0.0) so silent event-budget
    exhaustion shows up in any table built from this summary.
    """
    ms = metrics[warmup:]
    if not ms:
        return {}
    out = {name: (float(np.mean([fn(m) for m in ms])),
                  float(np.std([fn(m) for m in ms])))
           for name, fn in _COLUMNS}
    out["truncated_iterations"] = (float(sum(m.truncated for m in ms)), 0.0)
    return out
