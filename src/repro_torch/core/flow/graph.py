"""Flow-network model of a decentralized training system (paper Sec. III/IV).

Nodes are data nodes or relay nodes, grouped into pipeline stages.  Link
costs follow Eq. 1:

    d_ij = (c_i + c_j)/2 + (lambda_ij + lambda_ji)/2 + 2*size/(beta_ij + beta_ji)

with asymmetric latency/bandwidth averaged because every link is used once
forward and once backward.

Compression-aware pricing
-------------------------
On WAN links, compressing the payload is the dominant bandwidth lever
(FusionLLM), so every link is priced at its *best admissible wire
codec*: ``FlowNetwork.codec_menu`` names entries of :data:`WIRE_CODECS`
(compression ratio, encode+decode compute rate, fidelity penalty), the
scenario-level ``fidelity_budget`` gates which codecs are admissible,
and the per-edge price becomes

    min over admissible codecs c of
        lat_avg + 2*(ratio_c*size)/(beta_ij+beta_ji)
        + coder_rate_c*size + fidelity_weight*penalty_c

so fast links keep ``fp32`` (no distortion for negligible time saved)
while slow inter-region links pick aggressive codecs — routing and
compression are co-optimized because both land in the same cost
matrices the planner consumes.  ``wire_codec_matrix()`` exposes the
argmin (which codec each link chose).  The default menu ``("fp32",)``
takes a short-circuit path whose float arithmetic is *bit-identical* to
the pre-codec implementation; that is the in-engine equality oracle.

Reputation-aware pricing
------------------------
Beyond fail-stop faults, the defense layer prices *distrust* into the
same Eq. 1 matrices: each node carries a reputation in (0, 1] (default
1.0), and every edge INTO node j pays an extra

    reputation_weight * (1/rep_j - 1)

on ``cost_matrix()``/``edge_matrix()``/``edge_cost()`` — the matrices
the planner and reroute policy consume — but NOT on
``comm_matrix()``/``comm_cost()``, which model transfer physics (a
suspected node does not move bytes slower; the planner just avoids
it).  ``report_fault`` multiplicatively drops a node's reputation
(quarantine: the penalty dwarfs typical edge costs so flow routes
around it), ``decay_reputations`` relaxes everyone back toward 1.0
(rehabilitation), and when every reputation returns to ~1.0 storage
snaps back to the trivial ``None`` state whose arithmetic — and cached
matrix *objects* — are bit-identical to the reputation-free
implementation.  Reputation survives ``kill_node``/rejoin: quarantine
is about trust, not liveness.

KV-residency pricing (serving plane)
------------------------------------
When the same stage graph carries decode traffic, a node holding N
resident KV-cache sequences is the serving analogue of a loaded
activation store: every edge INTO node j pays an extra

    kv_weight * residency_j

on ``cost_matrix()``/``edge_matrix()``/``edge_cost()`` (planner-facing
matrices only, like reputation — residency does not move bytes slower,
it just makes loaded nodes less attractive to *new* chains).  The
default ``kv_weight = 0`` / empty residency keeps the trivial ``None``
storage whose arithmetic and cached matrix objects are bit-identical to
the serving-free implementation.  Evicting/migrating a resident
sequence to another node pays ``kv_migration_cost(i, j, kv_bytes)`` —
the KV payload priced through the same admissible-wire-codec
communication model as activations (FusionLLM's compressed geo-links
apply to KV-boundary traffic verbatim).

Scale notes
-----------
``edge_cost``/``comm_cost`` are the innermost calls of both the protocol
and the simulator, so the Eq. 1 terms are precomputed once into dense
(N, N) matrices (``cost_matrix()``) and every query is a single array
read.  The caches are keyed on a version counter that ``add_node`` (and
``invalidate_costs``) bumps; node death does *not* invalidate them
because link costs are independent of liveness.  Per-size matrices
(``comm_matrix``/``edge_matrix``) live in a small per-epoch dict so
alternating sizes — e.g. activation bytes vs aggregation bytes, or the
multiple effective sizes a codec menu produces — do not thrash full
rebuilds (``matrix_rebuild_count`` tracks rebuilds for regression
tests).  ``add_node`` grows the latency/bandwidth matrices
geometrically (amortized O(N) per join instead of a fresh O(N^2)
reallocation per join).
"""
from __future__ import annotations

import dataclasses
import inspect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# Defaults for links of a joining node when no measurements are supplied
# (previously inlined in add_node).
DEFAULT_JOIN_LATENCY = 0.05
DEFAULT_JOIN_BANDWIDTH = 500e6 / 8


@dataclass(frozen=True)
class LinkCodec:
    """One wire-codec entry of the per-link compression menu.

    ``ratio`` is encoded bytes per raw byte; ``coder_rate`` is the
    encode+decode compute term in seconds per raw byte (both endpoints
    combined); ``fidelity_penalty`` is a dimensionless distortion proxy
    — a scenario's ``fidelity_budget`` gates admissibility and
    ``FlowNetwork.fidelity_weight`` converts the residual distortion of
    an admissible codec into seconds-equivalent cost, so near-lossless
    links are not compressed for free.
    """
    name: str
    ratio: float
    coder_rate: float
    fidelity_penalty: float


# The planner's codec menu.  Ratios mirror the runtime codecs in
# `runtime/activations.py`: bf16 halves the payload, int8 is 1 byte per
# element plus a fp32 scale (~0.26 measured on bench tensors), top-k at
# k=1/16 keeps value+int32 index pairs (2*k of the raw bytes).  Coder
# rates are seconds/byte on the CI-class host (cast ~10 GB/s, quantise
# ~5 GB/s, top-k selection ~2.5 GB/s, encode+decode combined).
WIRE_CODECS: Dict[str, LinkCodec] = {
    "fp32": LinkCodec("fp32", 1.0, 0.0, 0.0),
    "bf16": LinkCodec("bf16", 0.5, 1.0e-10, 0.004),
    "int8": LinkCodec("int8", 0.26, 2.0e-10, 0.02),
    "top-k": LinkCodec("top-k", 0.125, 4.0e-10, 0.08),
}

# Bounded per-epoch size->matrix cache (a codec menu touches a handful
# of sizes per epoch; 16 is generous).
_WIRE_CACHE_MAX = 16

# Reputation defaults for the detect-quarantine-reroute defense layer.
# A fault report multiplies reputation by REPORT_DROP (floored), each
# decay step closes RECOVERY_RATE of the gap back to 1.0, and a node is
# "quarantined" while its reputation sits below QUARANTINE_THRESHOLD.
# With drop 0.2 the edge penalty is reputation_weight*(1/0.2-1) = 4x
# the weight — at the default weight of 50 that is ~200s-equivalent,
# dominating typical Eq. 1 edge costs (~10-40s) so planning routes
# around the node until decay rehabilitates it.
REPORT_DROP = 0.2
REPUTATION_FLOOR = 1e-3
RECOVERY_RATE = 0.4
QUARANTINE_THRESHOLD = 0.5


@dataclass
class Node:
    id: int
    stage: int                  # 0..S-1 for relays; -1 for data nodes
    capacity: int               # max concurrent microbatches (cap_i)
    compute_cost: float         # c_i: time to process one microbatch
    is_data: bool = False
    alive: bool = True
    location: int = -1          # geographic location id (-1 = unknown)

    def __hash__(self):
        return self.id


@dataclass
class FlowNetwork:
    """Global network description — the *simulator's* ground truth.

    Decentralized protocol code only ever reads local slices of this
    (a node's own row/column and its known peers), preserving the paper's
    partial-knowledge property.
    """
    nodes: Dict[int, Node]
    num_stages: int
    latency: np.ndarray          # (N, N) lambda_ij, seconds
    bandwidth: np.ndarray        # (N, N) beta_ij, bytes/s
    activation_size: float       # bytes per microbatch activation
    codec_menu: Tuple[str, ...] = ("fp32",)   # WIRE_CODECS names offered
    fidelity_budget: float = 0.0  # max admissible fidelity_penalty
    fidelity_weight: float = 1.0  # seconds-equivalent per unit penalty
    reputation_weight: float = 50.0  # seconds-equivalent per unit of
    #   distrust (1/rep - 1) on edges into a suspected node
    kv_weight: float = 0.0       # seconds-equivalent per KV-resident
    #   sequence on edges into a loaded node (serving plane; 0 = off)

    # ------------------------------------------------------------------
    # Cached Eq. 1 cost model
    # ------------------------------------------------------------------
    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        # rebinding a cost input (e.g. bench code replacing the whole
        # latency matrix, or widening the codec menu) invalidates the
        # caches; in-place element writes still require an explicit
        # invalidate_costs().
        if name in ("latency", "bandwidth", "activation_size",
                    "codec_menu", "fidelity_budget", "fidelity_weight",
                    "reputation_weight", "kv_weight"):
            object.__setattr__(self, "_cost_version",
                               getattr(self, "_cost_version", 0) + 1)

    def invalidate_costs(self):
        """Bump the cache version; the next cost query rebuilds.

        Call after mutating ``latency``/``bandwidth``/``compute_cost`` in
        place.  ``add_node`` calls this automatically.
        """
        self._cost_version = getattr(self, "_cost_version", 0) + 1

    @property
    def cost_version(self) -> int:
        """Monotonic counter identifying the current cost-cache epoch."""
        return getattr(self, "_cost_version", 0)

    def _cost_cache(self) -> dict:
        ver = self.cost_version
        cc = getattr(self, "_cc", None)
        if cc is not None and cc["version"] == ver:
            return cc
        lat_avg = 0.5 * (self.latency + self.latency.T)
        bw_sum = self.bandwidth + self.bandwidth.T
        n = lat_avg.shape[0]
        comp = np.zeros(n)
        for nid, node in self.nodes.items():
            if nid < n:
                comp[nid] = node.compute_cost
        comp_pair = 0.5 * (comp[:, None] + comp[None, :])
        cost = comp_pair + lat_avg + 2.0 * self.activation_size / bw_sum
        cc = dict(version=ver, lat_avg=lat_avg, bw_sum=bw_sum,
                  comp_pair=comp_pair, cost=cost)
        self._cc = cc
        return cc

    # -- wire-codec menu ------------------------------------------------
    def admissible_codecs(self) -> Tuple[LinkCodec, ...]:
        """Menu entries whose fidelity penalty fits the budget, in menu
        order (ties in edge price resolve to the earlier entry).

        ``fp32`` (penalty 0) is always admissible, so an over-tight
        budget degrades to lossless rather than to an empty menu.
        """
        key = (tuple(self.codec_menu), float(self.fidelity_budget))
        cached = getattr(self, "_adm", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        menu = []
        for name in key[0]:
            codec = WIRE_CODECS.get(name)
            if codec is None:
                raise ValueError(
                    f"unknown wire codec {name!r}; "
                    f"known: {sorted(WIRE_CODECS)}")
            if codec.fidelity_penalty <= key[1] or codec.name == "fp32":
                menu.append(codec)
        adm = tuple(menu)
        self._adm = (key, adm)
        return adm

    def _wire_trivial(self) -> bool:
        """True when pricing reduces to the pre-codec fp32 arithmetic."""
        adm = self.admissible_codecs()
        return (len(adm) == 1 and adm[0].ratio == 1.0
                and adm[0].coder_rate == 0.0
                and adm[0].fidelity_penalty == 0.0)

    # -- reputation (detect-quarantine-reroute defense layer) -----------
    def _reputation_trivial(self) -> bool:
        """True when every node is fully trusted (storage is ``None``)
        and pricing reduces to the exact reputation-free arithmetic."""
        return getattr(self, "_reputation", None) is None

    def reputation_active(self) -> bool:
        """True while any node's reputation is below 1.0."""
        return not self._reputation_trivial()

    def _rep_array(self) -> np.ndarray:
        """Materialize (and grow) the reputation vector for mutation."""
        n = (max(self.nodes) + 1) if self.nodes else 0
        rep = getattr(self, "_reputation", None)
        if rep is None:
            rep = np.ones(n)
        elif rep.shape[0] < n:
            grown = np.ones(n)          # joiners start fully trusted
            grown[:rep.shape[0]] = rep
            rep = grown
        self._reputation = rep
        return rep

    def reputation(self, nid: int) -> float:
        rep = getattr(self, "_reputation", None)
        if rep is None or nid >= rep.shape[0]:
            return 1.0
        return float(rep[nid])

    def quarantined(self, nid: int) -> bool:
        """True while planning actively routes around ``nid``."""
        return self.reputation(nid) < QUARANTINE_THRESHOLD

    def set_reputation(self, nid: int, value: float):
        """Pin a node's reputation directly (tests / manual override)."""
        if not 0.0 < value <= 1.0:
            raise ValueError(f"reputation must be in (0, 1], got {value}")
        rep = self._rep_array()
        rep[nid] = value
        self._maybe_snap_trivial()
        self.invalidate_costs()

    def report_fault(self, nid: int, *, drop: float = REPORT_DROP):
        """Multiplicatively drop ``nid``'s reputation on a detection.

        Order-independent within an iteration (multiplication commutes);
        the engine applies decay first, then the iteration's reports, so
        fresh detections carry the full penalty into the next plan.
        """
        rep = self._rep_array()
        rep[nid] = max(REPUTATION_FLOOR, float(rep[nid]) * drop)
        self.invalidate_costs()

    def decay_reputations(self, *, rate: float = RECOVERY_RATE):
        """Relax all reputations toward 1.0 (rehabilitation).

        No-op (and no cache-version bump) in the trivial state, so runs
        that never report a fault keep their exact cache epochs.  When
        the worst deficit decays below 1e-9 storage snaps back to
        ``None`` and pricing returns to the bit-identical trivial path.
        """
        rep = getattr(self, "_reputation", None)
        if rep is None:
            return
        self._reputation = rep + rate * (1.0 - rep)
        self._maybe_snap_trivial()
        self.invalidate_costs()

    def _maybe_snap_trivial(self):
        rep = getattr(self, "_reputation", None)
        if rep is not None and float(np.max(1.0 - rep)) < 1e-9:
            self._reputation = None

    def _rep_penalty(self, cc: dict) -> Optional[np.ndarray]:
        """Per-destination penalty vector ``w*(1/rep - 1)``, or ``None``
        in the trivial state.  Cached per cost-cache epoch (reputation
        mutators bump the version)."""
        rep = getattr(self, "_reputation", None)
        if rep is None:
            return None
        cached = getattr(self, "_rep_pen", None)
        if cached is not None and cached[0] == cc["version"]:
            return cached[1]
        n = cc["lat_avg"].shape[0]
        r = np.ones(n)
        m = min(n, rep.shape[0])
        r[:m] = rep[:m]
        vec = self.reputation_weight * (1.0 / r - 1.0)
        self._rep_pen = (cc["version"], vec)
        return vec

    # -- KV-cache residency (serving plane) -----------------------------
    def _kv_trivial(self) -> bool:
        """True when no sequence is resident anywhere (storage ``None``)
        or the surcharge is off; pricing reduces to the exact
        serving-free arithmetic."""
        return (getattr(self, "_kv_residency", None) is None
                or self.kv_weight == 0.0)

    def kv_active(self) -> bool:
        """True while any node carries resident sequences (and the
        surcharge weight is non-zero)."""
        return not self._kv_trivial()

    def _kv_array(self) -> np.ndarray:
        """Materialize (and grow) the residency vector for mutation."""
        n = (max(self.nodes) + 1) if self.nodes else 0
        res = getattr(self, "_kv_residency", None)
        if res is None:
            res = np.zeros(n)
        elif res.shape[0] < n:
            grown = np.zeros(n)         # joiners start empty
            grown[:res.shape[0]] = res
            res = grown
        self._kv_residency = res
        return res

    def kv_residency(self, nid: int) -> int:
        """Resident-sequence count the planner prices on node ``nid``."""
        res = getattr(self, "_kv_residency", None)
        if res is None or nid >= res.shape[0]:
            return 0
        return int(res[nid])

    def set_kv_residency(self, nid: int, count: int):
        """Pin one node's resident-sequence count."""
        if count < 0:
            raise ValueError(f"kv residency must be >= 0, got {count}")
        res = self._kv_array()
        res[nid] = count
        self._maybe_snap_kv_trivial()
        self.invalidate_costs()

    def update_kv_residency(self, counts: Dict[int, int]):
        """Replace the whole residency map in one cache epoch (the
        serving engine's per-iteration bulk update).  An empty map snaps
        storage back to the trivial ``None`` state."""
        res = self._kv_array()
        res[:] = 0.0
        for nid, count in counts.items():
            if count < 0:
                raise ValueError(
                    f"kv residency must be >= 0, got {count} for {nid}")
            if count and nid < res.shape[0]:
                res[nid] = count
        self._maybe_snap_kv_trivial()
        self.invalidate_costs()

    def _maybe_snap_kv_trivial(self):
        res = getattr(self, "_kv_residency", None)
        if res is not None and float(np.max(res)) < 1e-9:
            self._kv_residency = None

    def _kv_penalty(self, cc: dict) -> Optional[np.ndarray]:
        """Per-destination surcharge vector ``kv_weight * residency``,
        or ``None`` in the trivial state.  Cached per cost-cache epoch
        (residency mutators bump the version)."""
        if self._kv_trivial():
            return None
        cached = getattr(self, "_kv_pen", None)
        if cached is not None and cached[0] == cc["version"]:
            return cached[1]
        res = self._kv_residency
        n = cc["lat_avg"].shape[0]
        r = np.zeros(n)
        m = min(n, res.shape[0])
        r[:m] = res[:m]
        vec = self.kv_weight * r
        self._kv_pen = (cc["version"], vec)
        return vec

    def kv_migration_cost(self, i: int, j: int, kv_bytes: float) -> float:
        """Price of migrating one resident sequence's KV slice from
        node ``i`` to node ``j``: the KV payload moved through the same
        admissible-wire-codec communication model as activations."""
        return self.comm_cost(i, j, kv_bytes)

    # -- combined per-destination planner penalty -----------------------
    def _dest_penalty(self, cc: dict) -> Optional[np.ndarray]:
        """Reputation + KV-residency penalty per destination column, or
        ``None`` when both layers are trivial (the bit-identical path).
        Epoch-cached; when only one layer is active its vector is
        returned untouched (no ``+ 0.0`` pass over it)."""
        rep = self._rep_penalty(cc)
        kv = self._kv_penalty(cc)
        if kv is None:
            return rep
        if rep is None:
            return kv
        cached = getattr(self, "_dest_pen", None)
        if cached is not None and cached[0] == cc["version"]:
            return cached[1]
        vec = rep + kv
        self._dest_pen = (cc["version"], vec)
        return vec

    def _cost_with_rep(self, cc: dict) -> np.ndarray:
        """``cc["cost"]`` plus the destination penalties, epoch-cached;
        returns the untouched legacy object in the trivial state."""
        pen = self._dest_penalty(cc)
        if pen is None:
            return cc["cost"]
        cached = getattr(self, "_cost_rep", None)
        if cached is not None and cached[0] == cc["version"]:
            return cached[1]
        mat = cc["cost"] + pen[None, :]
        self._cost_rep = (cc["version"], mat)
        return mat

    def wire_codec_names(self) -> Tuple[str, ...]:
        """Names indexing ``wire_codec_matrix`` entries (menu order)."""
        return tuple(c.name for c in self.admissible_codecs())

    def wire_codec_ratios(self) -> np.ndarray:
        """Compression ratio per admissible codec, same order as names."""
        return np.array([c.ratio for c in self.admissible_codecs()])

    def wire_codec_matrix(self, size: Optional[float] = None) -> np.ndarray:
        """(N, N) index into ``wire_codec_names()``: the codec each link
        chose at ``size`` bytes (argmin of the per-codec edge price)."""
        cc = self._cost_cache()
        if size is None:
            size = self.activation_size
        comm, choice = self._wire_tables(cc, float(size))
        if choice is None:
            choice = np.zeros(comm.shape, dtype=np.int8)
        return choice

    # -- matrix caches --------------------------------------------------
    @property
    def matrix_rebuild_count(self) -> int:
        """Total per-size comm/edge matrix builds (regression guard for
        the per-epoch dict cache: alternating sizes must not thrash)."""
        return getattr(self, "_matrix_rebuilds", 0)

    def _wire_tables(self, cc: dict, size: float):
        """Codec-priced ``(comm, choice)`` at ``size``, per-epoch cached.

        ``comm[i, j]`` is the communication price of the best admissible
        codec on link (i, j); ``choice`` is the argmin (``None`` on the
        trivial fp32-only path, whose arithmetic is bit-identical to the
        pre-codec implementation).
        """
        cache = getattr(self, "_wire_m", None)
        if cache is None or cache[0] != cc["version"]:
            cache = (cc["version"], {})
            self._wire_m = cache
        ent = cache[1].get(size)
        if ent is not None:
            return ent
        lat, bw = cc["lat_avg"], cc["bw_sum"]
        if self._wire_trivial():
            ent = (lat + 2.0 * size / bw, None)
        else:
            adm = self.admissible_codecs()
            fw = float(self.fidelity_weight)
            first = adm[0]
            best = (lat + 2.0 * (first.ratio * size) / bw
                    + (first.coder_rate * size
                       + fw * first.fidelity_penalty))
            choice = np.zeros(lat.shape, dtype=np.int8)
            for k, codec in enumerate(adm[1:], start=1):
                cand = (lat + 2.0 * (codec.ratio * size) / bw
                        + (codec.coder_rate * size
                           + fw * codec.fidelity_penalty))
                better = cand < best
                best = np.where(better, cand, best)
                choice[better] = k
            ent = (best, choice)
        if len(cache[1]) >= _WIRE_CACHE_MAX:
            cache[1].clear()
        cache[1][size] = ent
        self._matrix_rebuilds = getattr(self, "_matrix_rebuilds", 0) + 1
        return ent

    def cost_matrix(self) -> np.ndarray:
        """Dense Eq. 1 cost matrix at the default activation size.

        Cached; treat as read-only.  ``d(i, j)`` is ``cost_matrix()[i, j]``.
        With a non-trivial codec menu each entry is priced at that
        link's best admissible codec; with active reputations each
        column j additionally pays ``reputation_weight*(1/rep_j - 1)``.
        """
        cc = self._cost_cache()
        if self._wire_trivial():
            return self._cost_with_rep(cc)
        return self.edge_matrix(self.activation_size)

    def comm_matrix(self, size: Optional[float] = None) -> np.ndarray:
        """Dense communication-only Eq. 1 matrix at ``size`` bytes.

        ``comm_matrix(size)[i, j] == comm_cost(i, j, size)`` exactly (the
        elementwise NumPy expression mirrors the scalar one).  Cached in
        a per-epoch size dict; treat as read-only.  This is the batched
        lookup the simulator's event core resolves its per-leg transfer
        delays against instead of calling ``comm_cost`` per event.
        """
        cc = self._cost_cache()
        if size is None:
            size = self.activation_size
        return self._wire_tables(cc, float(size))[0]

    def edge_matrix(self, size: Optional[float] = None) -> np.ndarray:
        """Dense full Eq. 1 matrix (compute + comm) at ``size`` bytes.

        ``edge_matrix(size)[i, j] == edge_cost(i, j, size)`` exactly
        (same elementwise association as the scalar path).  Cached in a
        per-epoch size dict; treat as read-only.
        """
        cc = self._cost_cache()
        pen = self._dest_penalty(cc)
        if self._wire_trivial():
            if size is None:
                return self._cost_with_rep(cc)
            key = float(size)
            cache = getattr(self, "_edge_m", None)
            if cache is None or cache[0] != cc["version"]:
                cache = (cc["version"], {})
                self._edge_m = cache
            mat = cache[1].get(key)
            if mat is None:
                mat = (cc["comp_pair"] + cc["lat_avg"]
                       + 2.0 * float(size) / cc["bw_sum"])
                if pen is not None:
                    # safe to fold into the cached entry: reputation
                    # mutators bump the version, starting a new epoch
                    mat = mat + pen[None, :]
                if len(cache[1]) >= _WIRE_CACHE_MAX:
                    cache[1].clear()
                cache[1][key] = mat
                self._matrix_rebuilds = (
                    getattr(self, "_matrix_rebuilds", 0) + 1)
            return mat
        if size is None:
            size = self.activation_size
        key = float(size)
        cache = getattr(self, "_edge_m", None)
        if cache is None or cache[0] != cc["version"]:
            cache = (cc["version"], {})
            self._edge_m = cache
        mat = cache[1].get(key)
        if mat is None:
            mat = cc["comp_pair"] + self._wire_tables(cc, key)[0]
            if pen is not None:
                mat = mat + pen[None, :]
            if len(cache[1]) >= _WIRE_CACHE_MAX:
                cache[1].clear()
            cache[1][key] = mat
        return mat

    def edge_cost(self, i: int, j: int, size: Optional[float] = None) -> float:
        """Eq. 1 cost of moving one microbatch between nodes i and j."""
        cc = self._cost_cache()
        if self._wire_trivial():
            pen = self._dest_penalty(cc)
            if size is None:
                if pen is None:
                    return float(cc["cost"][i, j])
                return float(self._cost_with_rep(cc)[i, j])
            val = float(cc["comp_pair"][i, j] + cc["lat_avg"][i, j]
                        + 2.0 * size / cc["bw_sum"][i, j])
            if pen is not None:
                val = float(val + pen[j])
            return val
        return float(self.edge_matrix(size)[i, j])

    def comm_cost(self, i: int, j: int, size: Optional[float] = None) -> float:
        """Communication-only part of Eq. 1 (no compute term)."""
        cc = self._cost_cache()
        if size is None:
            size = self.activation_size
        if self._wire_trivial():
            return float(cc["lat_avg"][i, j] + 2.0 * size / cc["bw_sum"][i, j])
        return float(self.comm_matrix(size)[i, j])

    # ------------------------------------------------------------------
    def stage_nodes(self, stage: int, alive_only: bool = True) -> List[Node]:
        return [n for n in self.nodes.values()
                if n.stage == stage and not n.is_data
                and (n.alive or not alive_only)]

    def data_nodes(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.is_data]

    def alive_nodes(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.alive]

    def stage_capacity(self, stage: int) -> int:
        return sum(n.capacity for n in self.stage_nodes(stage))

    def kill_node(self, nid: int):
        """Mark a node dead.  Cost caches stay valid (liveness does not
        change link costs); only membership views change."""
        self.nodes[nid].alive = False

    # ------------------------------------------------------------------
    # Amortized matrix growth for churn
    # ------------------------------------------------------------------
    @property
    def matrix_capacity(self) -> int:
        """Allocated side length of the latency/bandwidth buffers."""
        return getattr(self, "_matrix_capacity", self.latency.shape[0])

    @property
    def matrix_grow_count(self) -> int:
        """Number of buffer reallocations performed by ``add_node`` —
        O(log joins) thanks to geometric growth (the seed reallocated
        on every join)."""
        return getattr(self, "_grow_count", 0)

    def _ensure_matrix_capacity(self, size: int):
        lat_buf = getattr(self, "_lat_buf", None)
        bw_buf = getattr(self, "_bw_buf", None)
        backed = (lat_buf is not None
                  and (self.latency is lat_buf or self.latency.base is lat_buf)
                  and (self.bandwidth is bw_buf
                       or self.bandwidth.base is bw_buf))
        if not backed:
            # First growth, or the matrices were rebound externally
            # (e.g. bench code replacing net.latency wholesale): adopt
            # the *current* arrays so the rebound values survive the
            # next join instead of being shadowed by a stale buffer.
            self._lat_buf = self.latency
            self._bw_buf = self.bandwidth
            self._matrix_capacity = self.latency.shape[0]
            if not hasattr(self, "_grow_count"):
                self._grow_count = 0
        if self._matrix_capacity >= size:
            return
        cap = self._matrix_capacity
        newcap = max(16, size, 2 * cap)
        n = self.latency.shape[0]
        lat = np.full((newcap, newcap), DEFAULT_JOIN_LATENCY)
        bw = np.full((newcap, newcap), DEFAULT_JOIN_BANDWIDTH)
        lat[:n, :n] = self.latency
        bw[:n, :n] = self.bandwidth
        self._lat_buf, self._bw_buf = lat, bw
        self._matrix_capacity = newcap
        self._grow_count += 1

    def add_node(self, node: Node, latency_row=None, latency_col=None,
                 bandwidth_row=None, bandwidth_col=None):
        """Grow the matrices for a joining node (amortized O(N))."""
        n = max(self.nodes) + 1 if self.nodes else 0
        assert node.id == n, f"node ids must be dense ({node.id} != {n})"
        size = n + 1
        self._ensure_matrix_capacity(size)
        # Rows/cols beyond the live region are pristine fill values: each
        # row/col index is written at most once (ids are dense and nodes
        # are never removed from the matrices).
        if latency_row is not None:
            self._lat_buf[n, :n] = latency_row
        if latency_col is not None:
            self._lat_buf[:n, n] = latency_col
        if bandwidth_row is not None:
            self._bw_buf[n, :n] = bandwidth_row
        if bandwidth_col is not None:
            self._bw_buf[:n, n] = bandwidth_col
        self.latency = self._lat_buf[:size, :size]
        self.bandwidth = self._bw_buf[:size, :size]
        self.nodes[node.id] = node
        self.invalidate_costs()


# ---------------------------------------------------------------------------
# Topology builders (paper Sec. VI setup)
# ---------------------------------------------------------------------------

def geo_distributed_network(
    *,
    num_stages: int,
    relay_capacities: List[int],
    num_data_nodes: int = 2,
    data_capacity: int = 4,
    rng: Optional[np.random.Generator] = None,
    num_locations: int = 10,
    min_bandwidth: float = 50e6 / 8,     # 50 Mb/s in bytes/s
    max_bandwidth: float = 500e6 / 8,    # 500 Mb/s
    compute_cost: float = 6.0,           # seconds per microbatch fwd+bwd
    compute_jitter: float = 0.3,
    activation_size: float = 4 * 512 * 1024 * 2 * 32,  # mb=4, seq=512, x32 scale
) -> FlowNetwork:
    """Build the paper's geo-distributed evaluation topology.

    Relay nodes are spread over ``num_locations`` simulated locations;
    intra-location links get max bandwidth / low latency, inter-location
    links get degraded bandwidth (down to 50 Mb/s) and higher latency.
    ``activation_size`` bakes in the paper's x32 bandwidth-reduction trick.

    Link matrices are drawn with NumPy broadcasting (O(N^2) C work, not
    O(N^2) Python loop iterations), so thousand-node topologies build in
    milliseconds.  NOTE: the batched draws consume the RNG stream in a
    different order than the seed implementation's per-pair loop, so a
    given seed yields a different (equally distributed) topology than
    before the scale rebuild; node capacities/compute costs, drawn
    first, are unchanged.
    """
    rng = rng or np.random.default_rng(0)
    nodes: Dict[int, Node] = {}
    nid = 0
    for _ in range(num_data_nodes):
        nodes[nid] = Node(nid, -1, data_capacity, 0.0, is_data=True)
        nid += 1
    per_stage = len(relay_capacities) // num_stages
    for s in range(num_stages):
        for k in range(per_stage):
            cap = relay_capacities[s * per_stage + k]
            c = compute_cost * (1.0 + compute_jitter * rng.standard_normal())
            nodes[nid] = Node(nid, s, cap, max(0.5, c))
            nid += 1

    N = nid
    loc = rng.integers(0, num_locations, size=N)
    for i in range(N):
        nodes[i].location = int(loc[i])   # drives correlated regional churn
    same = loc[:, None] == loc[None, :]
    lat = np.where(same,
                   rng.uniform(0.001, 0.005, size=(N, N)),
                   rng.uniform(0.02, 0.15, size=(N, N)))
    bw = np.where(same,
                  max_bandwidth,
                  rng.uniform(min_bandwidth, max_bandwidth, size=(N, N)))
    np.fill_diagonal(lat, 0.0)
    np.fill_diagonal(bw, max_bandwidth)
    return FlowNetwork(nodes=nodes, num_stages=num_stages, latency=lat,
                       bandwidth=bw, activation_size=activation_size)


def synthetic_network(
    *,
    num_stages: int,
    relays_per_stage: int,
    capacities,                   # callable(rng) -> int
    link_costs,                   # callable(rng) -> float, or
                                  # callable(rng, shape) -> (N, N) array
    num_sources: int = 1,
    source_capacity: int = 100,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[FlowNetwork, np.ndarray]:
    """Abstract flow-test network (paper Tables IV/V): d_ij drawn directly.

    Returns (network, cost_matrix) where cost_matrix[i, j] *is* d_ij —
    edge_cost is bypassed by storing costs in the latency matrix with
    zero compute and infinite bandwidth.

    ``link_costs`` may optionally accept a second ``shape`` argument and
    return a full (N, N) array — the vectorized fast path used by the
    scaling benchmarks.  Scalar callables keep the seed's element-wise
    draw order (diagonal excluded), so existing seeds reproduce.
    """
    rng = rng or np.random.default_rng(0)
    nodes: Dict[int, Node] = {}
    nid = 0
    for _ in range(num_sources):
        nodes[nid] = Node(nid, -1, source_capacity, 0.0, is_data=True)
        nid += 1
    for s in range(num_stages):
        for _ in range(relays_per_stage):
            nodes[nid] = Node(nid, s, int(capacities(rng)), 0.0)
            nid += 1
    N = nid
    # Detect the batched protocol from the signature instead of probing
    # with a trial call: a probe could consume RNG draws inside a
    # shape-tolerant scalar callable and silently shift the stream.
    batched = False
    try:
        params = list(inspect.signature(link_costs).parameters.values())
        batched = (len([p for p in params if p.kind in
                        (inspect.Parameter.POSITIONAL_ONLY,
                         inspect.Parameter.POSITIONAL_OR_KEYWORD)]) >= 2
                   or any(p.kind == inspect.Parameter.VAR_POSITIONAL
                          for p in params))
    except (TypeError, ValueError):
        batched = False
    if batched:
        cost = np.asarray(link_costs(rng, (N, N)), dtype=float)
        if cost.shape != (N, N):
            raise ValueError(
                f"batched link_costs must return shape {(N, N)}, "
                f"got {cost.shape}")
        cost = cost.copy()
        np.fill_diagonal(cost, 0.0)
    else:
        cost = np.empty((N, N))
        for i in range(N):
            for j in range(N):
                cost[i, j] = link_costs(rng) if i != j else 0.0
    net = FlowNetwork(nodes=nodes, num_stages=num_stages,
                      latency=cost, bandwidth=np.full((N, N), np.inf),
                      activation_size=0.0)
    return net, cost
