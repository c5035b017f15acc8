"""GWTF's decentralized flow optimization (paper Sec. V-A / V-C).

Pipelines ("flows") are built *backwards* — from the sink (the data node a
microbatch must return to) toward the first stage — using three
message-passing subprotocols that rely only on local knowledge:

* **Request Flow**     — a node with spare capacity asks a subsequent-stage
  node with an *unpaired outflow* (committed downstream path, no upstream
  feeder yet) to connect; costs-to-sink propagate in reverse.
* **Request Change**   — two same-stage nodes swap their downstream peers
  when that lowers the objective (min-max edge cost).
* **Request Redirect** — a node with spare capacity interposes itself,
  replacing a peer on a 2-hop segment when that lowers cost.

Request Change / Redirect use simulated annealing (T=1.7, alpha=0.95 per
the paper): a worsening move is still accepted with probability
exp((cost_cur - cost_new)/T) > U(0,1).

Every decision here reads only (a) the deciding node's own state and (b)
state returned by an explicit query to a known peer — the global ``net``
object is used strictly as a message channel / cost oracle (d_ij is
measurable locally by the two endpoints).

Index structures (dirty-slot incremental maintenance)
-----------------------------------------------------
This implementation is behavior-preserving with respect to
``repro.core.flow.reference.ReferenceGWTFProtocol`` (the straightforward
per-round-scan implementation): the same seed produces the *identical*
flows and the identical RNG stream.  The speed comes from incremental
indexes over the protocol state, not from changing any decision:

* ``_unpaired[(j, dn)]`` — ordered map (keyed by segment append order) of
  node ``j``'s unpaired outflows toward data node ``dn``.
  Invariant: segment ``s`` owned by relay ``p`` is in
  ``_unpaired[(p.node_id, s.data_node)]`` **iff** ``s.upstream is None``.
  Kept current by the ``_append_segment`` / ``_remove_segment`` /
  ``_set_upstream`` mutation helpers — ``_advertised`` is an O(1) lookup
  instead of a scan of all of ``j``'s segments per query.
* ``_advertisers[dn]`` — the set of relay ids with at least one unpaired
  outflow toward ``dn``.  Invariant: ``j in _advertisers[dn]`` iff
  ``_unpaired[(j, dn)]`` is non-empty.  ``_request_flow`` consults it to
  reject peers in O(1) while still iterating ``known_next`` in the same
  order as the reference (ties in the strict ``<`` comparisons resolve
  identically).
* per-node unpaired counters (``ProtoNode.n_up_unpaired`` /
  ``n_down_unpaired``) — make ``stable()`` checks O(1); the set
  ``_broken`` (ids with ``n_down_unpaired > 0``) is the unpaired-inflow
  worklist: ``step_round`` only walks a node's segment list looking for
  repairs when the node is on it.
* ``_epoch[stage]`` — bumped by every segment mutation touching a relay
  of that stage.  When the annealing temperature has decayed below 1e-6
  (worsening moves rejected *without* consuming randomness), a
  Request Change / Redirect scan that found no improving move is memoised
  against the stage epoch and skipped until some same-stage state
  changes.  Scans consume no randomness before their annealed accepts
  (the per-round RNG block below), so memo hits stay stream-neutral.
* **dirty-slot candidate tables** (``_tbl[stage]``) — each stage keeps a
  position-aligned column store over its slot registry
  (``_stage_slot_buf[stage][:n]``): up/owner/down/data-node/order
  columns, the cached edge costs ``curR = d(up, owner) + d(owner,
  down)`` and ``w = d(owner, down)``, and the redirect/change validity
  masks.  The mutation helpers mark the touched slot's *position* dirty
  (``_mark_slot_dirty`` via the global ``_slot_pos`` slot→position
  map); ``_patch_stage`` re-gathers just the dirty positions on the
  next query.  An accepted refinement move therefore invalidates O(1)
  table rows instead of forcing an O(stage) rebuild — the epoch bumps
  survive only to key the frozen-regime memos above.  Full rebuilds
  remain the slow path behind three explicit triggers: registry
  compaction (positions shuffle), slot-buffer growth, and a
  cost-matrix refresh (cached edge costs go stale).  Candidate *sets*
  and their values are identical to a from-scratch rebuild, and the
  batched scans rank candidates by the unique (rotation rank, order
  stamp) key, so table row order cannot influence any decision.
  ``strict_rebuild=True`` keeps the pre-dirty-slot behavior — a full
  epoch-keyed table rebuild per mutated stage — as the in-engine
  equality oracle (``tests/test_flow_dirty_slots.py`` drives both modes
  through randomized mutation sequences and asserts table equality).
* ``_refresh_costs`` is an iterative stage-by-stage walk with
  deduplicated visits (a node's recompute is an idempotent function of
  its downstream values, so visiting each cone node once in
  downstream-first order produces the reference recursion's exact final
  values without its exponential revisit blowup).

Batched annealing engine (this PR's rebuild)
--------------------------------------------
The refinement hot loop is a *batched array program*:

* **Per-round RNG block.**  ``step_round`` draws the node-order shuffle
  plus ONE uniform block ``rng.random((len(order), 4))`` per round —
  source rotation, segment choice, and the two scan-visit rotations are
  *indexed* out of the block instead of drawn per node, so the stream
  position is a pure function of membership size (shared discipline
  with ``ReferenceGWTFProtocol``).
* **Segment slot arrays.**  Every relay-owned segment occupies a slot
  in flat NumPy arrays (``_seg_owner/_seg_up/_seg_down/_seg_dnode/
  _seg_ord``) kept current by the mutation helpers (O(1) scalar writes;
  per-stage slot registries with tombstones + lazy compaction).  A scan
  gathers its whole candidate set with a few vectorized ops instead of
  a Python walk over peer segment lists.
* **Vectorized scans.**  Frozen regime: "first improving candidate in
  rotation order" is one masked argmin — no fallthrough rescans.
  Annealing regime: the non-improving prefix's acceptance uniforms are
  drawn as one sized block (bit-identical to the reference's scalar
  draws), accepts are prefiltered with ``np.exp`` under a conservative
  margin and confirmed with ``math.exp`` (the reference's function), and
  unused draws are returned to the stream with ``bit_generator.advance``
  so the stream stays exactly aligned.
* ``strict_rng=True`` selects the scalar scan implementation (same
  stream, same flows — the compatibility oracle inside the optimized
  engine); the default batched mode is gated on flow-equality and in
  practice reproduces the reference stream bit-for-bit as well.

Cost queries go through a flattened copy of the dense cost matrix
(``FlowNetwork.cost_matrix()`` or the explicit ``cost_matrix`` argument),
refreshed when the network's cost-cache version changes.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from bisect import bisect_left, insort
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.flow.graph import FlowNetwork, Node

_EMPTY_F = np.empty(0)
_EMPTY_SLOTS = np.empty(0, np.intp)
_EMPTY_I = np.empty(0, np.int64)
_EMPTY_B = np.empty(0, bool)


class _StageTable:
    """Dirty-slot candidate column store of one stage.

    Columns are aligned with positions ``0..n-1`` of the stage's slot
    registry (``_stage_slot_buf[stage]``); ``dirty`` holds positions
    whose columns are stale, ``rebuild`` forces a from-scratch refill
    (set on registry compaction, slot-buffer growth, or cost refresh).
    ``ver`` bumps whenever a patch changed anything — a cheap identity
    for downstream caches.
    """
    __slots__ = ("n", "ver", "rebuild", "dirty", "A", "B", "C", "dn",
                 "ords", "curR", "w", "validR", "validC")

    def __init__(self):
        self.n = 0
        self.ver = 0
        self.rebuild = True
        self.dirty: Set[int] = set()
        self.A = None       # upstream peer (-1 = unpaired)
        self.B = None       # owner
        self.C = None       # downstream peer (-1 = unpaired)
        self.dn = None      # the flow's data node
        self.ords = None    # append-order stamp
        self.curR = None    # d(A,B) + d(B,C) where validR
        self.w = None       # d(B,C) where validC
        self.validR = None  # live & fully paired -> redirect candidate
        self.validC = None  # live & non-sink downstream -> change candidate


@dataclass(eq=False)
class Segment:
    """One unit of flow through one node.

    ``eq=False``: segments are compared by identity — two segments of
    different flows can transiently carry identical field values, and
    list removal / membership must target the exact object.
    """
    flow_id: int
    data_node: int               # the sink this flow must return to
    downstream: Optional[int]    # next-stage peer (the sink itself for last stage)
    upstream: Optional[int]      # previous-stage feeder (None = unpaired outflow)
    cost_to_sink: float          # d(self, downstream) + downstream cost


@dataclass
class ProtoNode:
    """Local protocol state of one participant.

    ``n_up_unpaired`` / ``n_down_unpaired`` count segments with a missing
    upstream / downstream peer; the optimized protocol maintains them via
    its mutation helpers so ``stable()``-style checks are O(1).  The
    scan-based methods below remain the semantic definitions (and are
    what the reference implementation uses).
    """
    node_id: int
    stage: int                   # -1 for the data node's source side
    capacity: int
    known_next: Set[int] = field(default_factory=set)   # peers in stage+1 (or sink)
    known_same: Set[int] = field(default_factory=set)
    segments: List[Segment] = field(default_factory=list)
    alive: bool = True
    n_up_unpaired: int = 0
    n_down_unpaired: int = 0

    @property
    def used(self) -> int:
        return len(self.segments)

    @property
    def free(self) -> int:
        return self.capacity - self.used

    def unpaired_outflows(self) -> List[Segment]:
        return [s for s in self.segments if s.upstream is None]

    def stable(self) -> bool:
        return all(s.upstream is not None and s.downstream is not None
                   for s in self.segments)


class GWTFProtocol:
    """Round-based execution of the decentralized flow construction.

    ``peer_view`` limits each node's membership knowledge to a random
    subset of each adjacent stage (partial views, paper Sec. III); None
    means full adjacent-stage knowledge (as after long DHT gossip).
    ``refine=False`` disables the annealed Request Change / Redirect
    refinement (used by benchmarks to isolate its contribution).
    """

    def __init__(self, net: FlowNetwork, *,
                 cost_matrix: Optional[np.ndarray] = None,
                 temperature: float = 1.7, alpha: float = 0.95,
                 objective: str = "minmax",
                 peer_view: Optional[int] = None,
                 refine: bool = True,
                 strict_rng: bool = False,
                 strict_rebuild: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self.net = net
        self.cost_matrix = cost_matrix
        self.T = temperature
        self.alpha = alpha
        self.objective = objective
        self.refine = refine
        self.strict_rng = strict_rng
        self.strict_rebuild = strict_rebuild
        self.rng = rng or np.random.default_rng(0)
        # the batched annealing prefix returns unused uniform draws via
        # bit_generator.advance(); generators without it (e.g. MT19937,
        # SFC64) fall back to per-candidate scalar draws — identical
        # stream, still-batched delta evaluation
        self._can_rewind = hasattr(self.rng.bit_generator, "advance")
        self.peer_view = peer_view
        self._flow_counter = itertools.count()
        self._order_counter = itertools.count()
        self.protos: Dict[int, ProtoNode] = {}
        self._sink_slots: Dict[int, int] = {}    # data node -> free sink slots
        # --- indexes (see module docstring for invariants) ---
        self._unpaired: Dict[Tuple[int, int], Dict[int, Segment]] = {}
        self._advertisers: Dict[int, Set[int]] = {}
        self._broken: Set[int] = set()           # unpaired-inflow worklist
        # _epoch[stage]: bumped by ANY segment mutation in the stage
        # (guards Request Redirect memos, which read upstream+downstream).
        # _epoch_down[(stage, dn)]: bumped only by downstream-pointer /
        # membership changes of that (stage, data_node) — the only state
        # a Request Change scan reads — so upstream-only pairings don't
        # spuriously invalidate change memos.
        self._epoch: Dict[int, int] = defaultdict(int)
        self._epoch_down: Dict[Tuple[int, int], int] = defaultdict(int)
        # _epoch_dn[stage]: bumped by downstream/membership mutations of
        # any (stage, dn) — i.e. exactly what the change candidate table
        # reads — so upstream-only pairings don't invalidate it.
        self._epoch_dn: Dict[int, int] = defaultdict(int)
        self._memo_change: Dict[Tuple[int, int], int] = {}
        self._memo_redirect: Dict[int, int] = {}
        # --- segment slot arrays (batched scan candidate store) ---
        # slot s of a live relay-owned segment: _seg_owner[s] = owner id
        # (-1 = tombstone), _seg_up/_seg_down = peer ids (-1 = unpaired),
        # _seg_dnode = the flow's data node, _seg_ord = the segment's
        # append-order stamp (ascending _seg_ord within an owner ==
        # segment-list order), _seg_objs[s] = the Segment object.
        cap0 = 256
        self._seg_owner = np.full(cap0, -1, np.int64)
        self._seg_up = np.full(cap0, -1, np.int64)
        self._seg_down = np.full(cap0, -1, np.int64)
        self._seg_dnode = np.full(cap0, -1, np.int64)
        self._seg_ord = np.zeros(cap0, np.int64)
        self._seg_objs: List[Optional[Segment]] = [None] * cap0
        self._seg_free: List[int] = []
        self._seg_top = 0
        # per-stage slot registries (append order, preallocated int
        # buffers; tombstones compacted lazily once they outnumber half
        # the registry)
        self._stage_slot_buf: Dict[int, np.ndarray] = {}
        self._stage_slot_n: Dict[int, int] = defaultdict(int)
        self._stage_dead: Dict[int, int] = defaultdict(int)
        self._stage_slots_ver: Dict[int, int] = defaultdict(int)
        self._cand_cache_r: Dict[int, tuple] = {}
        self._cand_cache_c: Dict[int, tuple] = {}
        # dirty-slot candidate tables (see module docstring): the
        # slot→position map plus one _StageTable of columns per stage,
        # patched in place at the dirty positions on query.
        self._slot_pos = np.full(cap0, -1, np.intp)
        self._tbl: Dict[int, _StageTable] = {}
        # sorted per-stage membership lists: _stage_alive[s] == the sorted
        # alive relay ids of stage s (== any member's known_same + itself);
        # _stage_with_segs[s] == the subset that currently carries >=1
        # segment.  They let the refinement scans take their candidate
        # lists in O(stage) slicing instead of sorted(genexpr) per call.
        # The *_ver counters key cached ndarray views of both lists.
        self._stage_alive: Dict[int, List[int]] = defaultdict(list)
        self._stage_with_segs: Dict[int, List[int]] = defaultdict(list)
        self._alive_ver: Dict[int, int] = defaultdict(int)
        self._wseg_ver: Dict[int, int] = defaultdict(int)
        self._alive_arr_cache: Dict[int, tuple] = {}
        self._wseg_arr_cache: Dict[int, tuple] = {}
        self._order_cache: Optional[np.ndarray] = None   # sorted proto ids
        # dense advertised-cost vectors: _adv_cost[dn][j] == the cheapest
        # cost-to-sink j advertises toward dn (+inf when none), kept
        # current by _adv_update at every advertisement mutation; and
        # per-node known_next snapshots in set-iteration order (the
        # reference's scan order), used to vectorize _best_advertiser.
        self._adv_cost: Dict[int, np.ndarray] = {}
        self._known_arr: Dict[int, np.ndarray] = {}
        self._data_ids: List[int] = [n.id for n in net.data_nodes()]
        self._data_set: Set[int] = set(self._data_ids)
        n_ids = (max(net.nodes) + 1) if net.nodes else 0
        self._is_data_arr = np.zeros(n_ids, bool)
        for d in self._data_ids:
            self._is_data_arr[d] = True
        self._cml: Optional[List[List[float]]] = None
        self._cml_ver: Optional[int] = None
        self._refresh_cost_source()
        self._build_protocol_state()

    # ------------------------------------------------------------------
    # Cost oracle
    # ------------------------------------------------------------------
    def _refresh_cost_source(self):
        """(Re)flatten the dense cost matrix into nested Python lists —
        the innermost ``d()`` lookup then avoids ndarray scalar boxing."""
        if self.cost_matrix is not None:
            if self._cml is None:
                self._cm_np = np.asarray(self.cost_matrix, dtype=float)
                self._cml = self._cm_np.tolist()
            return
        ver = self.net.cost_version
        if self._cml is None or self._cml_ver != ver:
            self._cml = self.net.cost_matrix().tolist()
            self._cm_np = self.net.cost_matrix()
            self._cml_ver = ver
            # cost changes invalidate every memoised refinement scan and
            # the candidate tables' cached edge costs
            self._memo_change.clear()
            self._memo_redirect.clear()
            self._cand_cache_r.clear()
            self._cand_cache_c.clear()
            for tbl in self._tbl.values():
                tbl.rebuild = True
                tbl.dirty.clear()

    def d(self, i: int, j: int) -> float:
        return self._cml[i][j]

    def _build_protocol_state(self):
        S = self.net.num_stages
        # one pass over the (insertion-ordered) node table gives per-stage
        # id lists in exactly net.stage_nodes() order, so the known_* sets
        # below have the same insertion history — and therefore the same
        # iteration order — as the reference implementation's.
        stage_ids: Dict[int, List[int]] = defaultdict(list)
        data_alive: List[int] = []
        for n in self.net.nodes.values():
            if n.is_data:
                if n.alive:
                    data_alive.append(n.id)
            elif n.alive:
                stage_ids[n.stage].append(n.id)
        for n in self.net.nodes.values():
            if not n.alive:
                continue
            p = ProtoNode(n.id, n.stage, n.capacity)
            self.protos[n.id] = p
        for s, ids in stage_ids.items():
            self._stage_alive[s] = sorted(ids)
        for p in self.protos.values():
            n = self.net.nodes[p.node_id]
            if n.is_data:
                self._sink_slots[n.id] = n.capacity
                nxt = set(stage_ids[0])
            elif n.stage == S - 1:
                nxt = set(data_alive)
            else:
                nxt = set(stage_ids[n.stage + 1])
            same = set(stage_ids[n.stage]) - {n.id}
            if self.peer_view is not None:
                nxt = set(self.rng.choice(sorted(nxt),
                                          size=min(self.peer_view, len(nxt)),
                                          replace=False)) if nxt else set()
            p.known_next = nxt
            p.known_same = same

    # ------------------------------------------------------------------
    # Index-maintaining mutation helpers.  Every segment-state mutation
    # in this class goes through these, which is what keeps the
    # _unpaired/_advertisers/_broken indexes and the per-stage epochs
    # consistent with the invariants in the module docstring.
    # ------------------------------------------------------------------
    def _touch(self, p: ProtoNode):
        if p.stage >= 0:
            self._epoch[p.stage] += 1

    def _touch_down(self, p: ProtoNode, data_node: int):
        if p.stage >= 0:
            self._epoch_down[(p.stage, data_node)] += 1
            self._epoch_dn[p.stage] += 1

    # -- segment slot store (see module docstring) ----------------------
    def _slot_alloc(self) -> int:
        if self._seg_free:
            return self._seg_free.pop()
        if self._seg_top == len(self._seg_owner):
            new = 2 * len(self._seg_owner)
            for name in ("_seg_owner", "_seg_up", "_seg_down",
                         "_seg_dnode", "_seg_ord"):
                old = getattr(self, name)
                arr = np.full(new, -1, np.int64) if name != "_seg_ord" \
                    else np.zeros(new, np.int64)
                arr[:self._seg_top] = old[:self._seg_top]
                setattr(self, name, arr)
            pos = np.full(new, -1, np.intp)
            pos[:self._seg_top] = self._slot_pos[:self._seg_top]
            self._slot_pos = pos
            self._seg_objs.extend([None] * (new - len(self._seg_objs)))
        slot = self._seg_top
        self._seg_top += 1
        return slot

    def _slot_add(self, p: ProtoNode, seg: Segment):
        slot = self._slot_alloc()
        seg._slot = slot
        self._seg_owner[slot] = p.node_id
        self._seg_up[slot] = -1 if seg.upstream is None else seg.upstream
        self._seg_down[slot] = -1 if seg.downstream is None else seg.downstream
        self._seg_dnode[slot] = seg.data_node
        self._seg_ord[slot] = seg._order
        self._seg_objs[slot] = seg
        stage = p.stage
        buf = self._stage_slot_buf.get(stage)
        n = self._stage_slot_n[stage]
        if buf is None or n == len(buf):
            grown = np.empty(max(64, 2 * (0 if buf is None else len(buf))),
                             np.intp)
            if buf is not None:
                grown[:n] = buf[:n]
            buf = self._stage_slot_buf[stage] = grown
        buf[n] = slot
        self._stage_slot_n[stage] = n + 1
        self._stage_slots_ver[stage] += 1
        self._slot_pos[slot] = n
        self._mark_slot_dirty(stage, slot)

    def _slot_drop(self, p: ProtoNode, seg: Segment):
        slot = getattr(seg, "_slot", -1)
        if slot < 0:
            return
        stage = p.stage
        self._mark_slot_dirty(stage, slot)
        self._seg_owner[slot] = -1           # tombstone
        self._seg_objs[slot] = None
        seg._slot = -1
        dead = self._stage_dead[stage] + 1
        n = self._stage_slot_n[stage]
        if dead > 16 and 2 * dead > n:
            buf = self._stage_slot_buf[stage]
            used = buf[:n]
            live = used[self._seg_owner[used] >= 0]
            self._seg_free.extend(used[self._seg_owner[used] < 0].tolist())
            k = len(live)
            buf[:k] = live
            self._stage_slot_n[stage] = k
            self._stage_dead[stage] = 0
            self._stage_slots_ver[stage] += 1
            # positions shuffled: remap the slot→position index and fall
            # back to a full table rebuild (dirty marks are meaningless
            # across a compaction, so they are discarded with it)
            self._slot_pos[live] = np.arange(k, dtype=np.intp)
            tbl = self._tbl.get(stage)
            if tbl is not None:
                tbl.rebuild = True
                tbl.dirty.clear()
        else:
            self._stage_dead[stage] = dead

    def _stage_slot_arr(self, stage: int) -> np.ndarray:
        buf = self._stage_slot_buf.get(stage)
        if buf is None:
            return _EMPTY_SLOTS
        return buf[:self._stage_slot_n[stage]]

    # -- dirty-slot candidate tables (see module docstring) -------------
    def _mark_slot_dirty(self, stage: int, slot: int):
        tbl = self._tbl.get(stage)
        if tbl is not None and not tbl.rebuild:
            tbl.dirty.add(int(self._slot_pos[slot]))

    def _tbl_fill(self, tbl: _StageTable, P: np.ndarray, slots: np.ndarray):
        """Refill the table columns at positions ``P`` ← slots ``slots``."""
        owner = self._seg_owner[slots]
        up = self._seg_up[slots]
        down = self._seg_down[slots]
        tbl.A[P] = up
        tbl.B[P] = owner
        tbl.C[P] = down
        tbl.dn[P] = self._seg_dnode[slots]
        tbl.ords[P] = self._seg_ord[slots]
        live = owner >= 0
        down_ok = down >= 0
        vr = live & (up >= 0) & down_ok
        vc = live & down_ok & ~self._is_data_arr[np.where(down_ok, down, 0)]
        tbl.validR[P] = vr
        tbl.validC[P] = vc
        cm = self._cm_np
        if vr.any():
            k = np.flatnonzero(vr)
            a, b, c = up[k], owner[k], down[k]
            tbl.curR[P[k]] = cm[a, b] + cm[b, c]
        if vc.any():
            k = np.flatnonzero(vc)
            tbl.w[P[k]] = cm[owner[k], down[k]]

    def _patch_stage(self, stage: int) -> _StageTable:
        """Bring the stage's candidate table current: O(#dirty) in the
        steady state, a full refill after compaction / growth / cost
        refresh."""
        tbl = self._tbl.get(stage)
        if tbl is None:
            tbl = self._tbl[stage] = _StageTable()
        buf = self._stage_slot_buf.get(stage)
        n = 0 if buf is None else self._stage_slot_n[stage]
        cap = 0 if buf is None else len(buf)
        if tbl.A is None or len(tbl.A) < cap:
            tbl.A = np.empty(cap, np.int64)
            tbl.B = np.empty(cap, np.int64)
            tbl.C = np.empty(cap, np.int64)
            tbl.dn = np.empty(cap, np.int64)
            tbl.ords = np.empty(cap, np.int64)
            tbl.curR = np.empty(cap)
            tbl.w = np.empty(cap)
            tbl.validR = np.zeros(cap, bool)
            tbl.validC = np.zeros(cap, bool)
            tbl.rebuild = True
        tbl.n = n
        if tbl.rebuild:
            if n:
                self._tbl_fill(tbl, np.arange(n, dtype=np.intp), buf[:n])
            tbl.dirty.clear()
            tbl.rebuild = False
            tbl.ver += 1
        elif tbl.dirty:
            P = np.fromiter(tbl.dirty, np.intp, len(tbl.dirty))
            tbl.dirty.clear()
            self._tbl_fill(tbl, P, buf[P])
            tbl.ver += 1
        return tbl

    def _alive_arr(self, stage: int) -> np.ndarray:
        ver = self._alive_ver[stage]
        cached = self._alive_arr_cache.get(stage)
        if cached is None or cached[0] != ver:
            cached = (ver, np.asarray(self._stage_alive[stage], np.int64))
            self._alive_arr_cache[stage] = cached
        return cached[1]

    def _wseg_arr(self, stage: int) -> np.ndarray:
        ver = self._wseg_ver[stage]
        cached = self._wseg_arr_cache.get(stage)
        if cached is None or cached[0] != ver:
            cached = (ver, np.asarray(self._stage_with_segs[stage], np.int64))
            self._wseg_arr_cache[stage] = cached
        return cached[1]

    def _adv_update(self, j: int, dn: int):
        """Refresh the dense advertised-cost entry for (j, dn)."""
        arr = self._adv_cost.get(dn)
        if arr is None:
            arr = self._adv_cost[dn] = np.full(len(self._is_data_arr),
                                               np.inf)
        idx = self._unpaired.get((j, dn))
        if idx:
            arr[j] = min(s.cost_to_sink for s in idx.values())
        else:
            arr[j] = np.inf

    def _index_add(self, p: ProtoNode, seg: Segment):
        key = (p.node_id, seg.data_node)
        idx = self._unpaired.get(key)
        if idx is None:
            idx = self._unpaired[key] = {}
        if not idx:
            self._advertisers.setdefault(seg.data_node, set()).add(p.node_id)
        idx[seg._order] = seg
        self._adv_update(p.node_id, seg.data_node)

    def _index_discard(self, p: ProtoNode, seg: Segment):
        key = (p.node_id, seg.data_node)
        idx = self._unpaired.get(key)
        if idx is not None and seg._order in idx:
            del idx[seg._order]
            if not idx:
                self._advertisers[seg.data_node].discard(p.node_id)
            self._adv_update(p.node_id, seg.data_node)

    def _append_segment(self, p: ProtoNode, seg: Segment):
        seg._order = next(self._order_counter)
        p.segments.append(seg)
        is_data = p.node_id in self._data_set
        if not is_data:
            if seg.upstream is None:
                p.n_up_unpaired += 1
                self._index_add(p, seg)
            if len(p.segments) == 1:
                insort(self._stage_with_segs[p.stage], p.node_id)
                self._wseg_ver[p.stage] += 1
            self._slot_add(p, seg)
        else:
            seg._slot = -1
        if seg.downstream is None:
            p.n_down_unpaired += 1
            self._broken.add(p.node_id)
        self._touch(p)
        self._touch_down(p, seg.data_node)

    def _remove_segment(self, p: ProtoNode, seg: Segment):
        p.segments.remove(seg)          # identity match (Segment eq=False)
        is_data = p.node_id in self._data_set
        if not is_data:
            if seg.upstream is None:
                p.n_up_unpaired -= 1
                self._index_discard(p, seg)
            if not p.segments:
                self._stage_with_segs[p.stage].remove(p.node_id)
                self._wseg_ver[p.stage] += 1
            self._slot_drop(p, seg)
            # evict the dead segment's memo entry so the cache stays
            # bounded by the number of live segments
            self._memo_change.pop((p.node_id, seg._order), None)
        if seg.downstream is None:
            p.n_down_unpaired -= 1
            if p.n_down_unpaired == 0:
                self._broken.discard(p.node_id)
        self._touch(p)
        self._touch_down(p, seg.data_node)

    def _set_upstream(self, p: ProtoNode, seg: Segment, up: Optional[int]):
        if seg.upstream is None and up is not None:
            if p.node_id not in self._data_set:
                p.n_up_unpaired -= 1
                self._index_discard(p, seg)
        elif seg.upstream is not None and up is None:
            if p.node_id not in self._data_set:
                p.n_up_unpaired += 1
                self._index_add(p, seg)
        seg.upstream = up
        slot = getattr(seg, "_slot", -1)
        if slot >= 0:
            self._seg_up[slot] = -1 if up is None else up
            self._mark_slot_dirty(p.stage, slot)
        self._touch(p)

    def _set_downstream(self, p: ProtoNode, seg: Segment, down: Optional[int]):
        if seg.downstream is None and down is not None:
            p.n_down_unpaired -= 1
            if p.n_down_unpaired == 0:
                self._broken.discard(p.node_id)
        elif seg.downstream is not None and down is None:
            p.n_down_unpaired += 1
            self._broken.add(p.node_id)
        seg.downstream = down
        slot = getattr(seg, "_slot", -1)
        if slot >= 0:
            self._seg_down[slot] = -1 if down is None else down
            self._mark_slot_dirty(p.stage, slot)
        self._touch(p)
        self._touch_down(p, seg.data_node)

    # ------------------------------------------------------------------
    # Queries (what a peer answers when asked — local information only)
    # ------------------------------------------------------------------
    def _advertised(self, j: int, data_node: int) -> Optional[float]:
        """Peer j's advertised cost-to-sink for an unpaired outflow to
        ``data_node``; None if it has none (infinite).  O(#unpaired at j
        for this sink) via the advertisement table."""
        if j in self._data_set:
            pj = self.protos.get(j)
            if pj is None or not pj.alive:
                return None
            return 0.0 if (j == data_node and self._sink_slots[j] > 0) else None
        idx = self._unpaired.get((j, data_node))
        if not idx:
            return None
        return min(s.cost_to_sink for s in idx.values())

    def _unpaired_in_list_order(self, j: int, data_node: int):
        """Unpaired outflows of j toward data_node, in segment-list
        (append) order — matches the reference's scan order exactly."""
        idx = self._unpaired.get((j, data_node))
        if not idx:
            return ()
        return [idx[k] for k in sorted(idx)]

    # ------------------------------------------------------------------
    # Request Flow
    # ------------------------------------------------------------------
    def _known_arr_of(self, i: int) -> np.ndarray:
        """``known_next`` snapshot in set-iteration order (the scan
        order of the reference's loop); invalidated on membership
        churn."""
        arr = self._known_arr.get(i)
        if arr is None:
            known = self.protos[i].known_next
            arr = np.fromiter(known, np.int64, len(known))
            self._known_arr[i] = arr
        return arr

    def _best_advertiser(self, i: int, data_node: int):
        """Cheapest known next-stage peer with an unpaired outflow toward
        ``data_node`` (or the sink itself), as (j, total, cost_to_sink).

        When the sink itself is not in view (every stage but the last),
        the scan is one vectorized argmin over the dense advertised-cost
        vector in ``known_next`` set order — ``np.argmin``'s
        first-minimum rule reproduces the reference loop's strict ``<``
        tie-breaking exactly.  Otherwise it falls back to the scalar
        scan.  Shared by _request_flow and _repair_downstream."""
        pi = self.protos[i]
        adv = self._advertisers.get(data_node)
        known = pi.known_next
        if ((not adv or adv.isdisjoint(known))
                and (data_node not in known
                     or self._sink_slots[data_node] <= 0)):
            return None, None, None
        if data_node not in known:
            arr = self._adv_cost.get(data_node)
            if arr is None:
                return None, None, None
            ks = self._known_arr_of(i)
            totals = arr[ks] + self._cm_np[i, ks]
            k = int(np.argmin(totals))
            total = totals[k]
            if total == np.inf:
                return None, None, None
            j = int(ks[k])
            return j, float(total), float(arr[j])
        best_j, best_total, best_cts = None, None, None
        row = self._cml[i]
        data_set = self._data_set
        for j in known:
            if j in data_set:
                if j != data_node or self._sink_slots[j] <= 0:
                    continue
                cts = 0.0
            else:
                idx = self._unpaired.get((j, data_node)) if adv and j in adv \
                    else None
                if not idx:
                    continue
                cts = min(s.cost_to_sink for s in idx.values())
            total = cts + row[j]
            if best_total is None or total < best_total:
                best_j, best_total, best_cts = j, total, cts
        return best_j, best_total, best_cts

    def _request_flow(self, i: int, data_node: int) -> bool:
        """Node i tries to pair with a subsequent-stage unpaired outflow."""
        pi = self.protos[i]
        best_j, _, best_cts = self._best_advertiser(i, data_node)
        if best_j is None:
            return False
        row = self._cml[i]
        # --- the Request Flow message exchange ---
        if best_j in self._data_set:
            if self._sink_slots[best_j] <= 0:
                return False
            self._sink_slots[best_j] -= 1
            fid = next(self._flow_counter)
            self._append_segment(pi, Segment(fid, data_node, best_j, None,
                                             row[best_j]))
            return True
        target = None
        for s in self._unpaired_in_list_order(best_j, data_node):
            if abs(s.cost_to_sink - best_cts) < 1e-9:
                target = s
                break
        if target is None:      # stale cost -> reject (requester retries next round)
            return False
        self._set_upstream(self.protos[best_j], target, i)
        self._append_segment(pi, Segment(target.flow_id, data_node, best_j, None,
                                         target.cost_to_sink + row[best_j]))
        return True

    # ------------------------------------------------------------------
    # Batched scan core.  A refinement scan visits a candidate list in
    # rotation order (sorted peers, random start offset) and resolves
    # the annealed accept/reject sequence.  The helpers below do that as
    # array programs over the segment slot store; outcomes and RNG
    # consumption are bit-identical to the scalar scans (strict_rng).
    # ------------------------------------------------------------------
    def _rotation_ranks(self, peers_arr: np.ndarray, self_id: int,
                        u_rot: float, owners: np.ndarray):
        """Visit rank of each candidate's owner under the rotation order
        over ``peers_arr`` minus ``self_id``.  Returns (ranks, n); n == 0
        means the scan has no peers at all."""
        n_all = len(peers_arr)
        pos_self = int(np.searchsorted(peers_arr, self_id))
        present = pos_self < n_all and peers_arr[pos_self] == self_id
        n = n_all - 1 if present else n_all
        if n <= 0:
            return None, 0
        start = int(u_rot * n)
        pos = np.searchsorted(peers_arr, owners)
        if present:
            pos = pos - (pos > pos_self)
        rank = pos - start
        rank[rank < 0] += n
        return rank, n

    def _redirect_cands(self, stage: int):
        """Request Redirect candidate table of a stage, full-length over
        the slot registry: (slot, A=up, B=owner, C=down,
        cur=d(A,B)+d(B,C), order stamp, valid mask).  Default mode reads
        the dirty-slot table (O(#dirty) maintenance); ``strict_rebuild``
        regathers everything from the slot store per mutated epoch — the
        in-engine equality oracle.  Rows where ``valid`` is False carry
        unspecified values."""
        if not self.strict_rebuild:
            tbl = self._patch_stage(stage)
            n = tbl.n
            if not n:
                return (_EMPTY_SLOTS, _EMPTY_I, _EMPTY_I, _EMPTY_I,
                        _EMPTY_F, _EMPTY_I, _EMPTY_B)
            return (self._stage_slot_buf[stage][:n], tbl.A[:n], tbl.B[:n],
                    tbl.C[:n], tbl.curR[:n], tbl.ords[:n], tbl.validR[:n])
        key = (self._epoch[stage], self._stage_slots_ver[stage])
        cached = self._cand_cache_r.get(stage)
        if cached is not None and cached[0] == key:
            return cached[1]
        slots = self._stage_slot_arr(stage)
        owner = self._seg_owner[slots]
        up = self._seg_up[slots]
        down = self._seg_down[slots]
        valid = (owner >= 0) & (up >= 0) & (down >= 0)
        if slots.size:
            cm = self._cm_np
            a = np.where(up >= 0, up, 0)
            b = np.where(owner >= 0, owner, 0)
            c = np.where(down >= 0, down, 0)
            cur = cm[a, b] + cm[b, c]
        else:
            cur = _EMPTY_F
        data = (slots, up, owner, down, cur, self._seg_ord[slots], valid)
        self._cand_cache_r[stage] = (key, data)
        return data

    def _change_cands(self, stage: int):
        """Request Change candidate table of a stage, full-length over
        the slot registry: (slot, J=owner, D=down, data node, w=d(J,D),
        order stamp, valid mask [live, downstream paired, non-sink]).
        Same dual-mode contract as ``_redirect_cands``; the strict path
        stays keyed on the downstream/membership epoch — upstream-only
        pairings leave it valid."""
        if not self.strict_rebuild:
            tbl = self._patch_stage(stage)
            n = tbl.n
            if not n:
                return (_EMPTY_SLOTS, _EMPTY_I, _EMPTY_I, _EMPTY_I,
                        _EMPTY_F, _EMPTY_I, _EMPTY_B)
            return (self._stage_slot_buf[stage][:n], tbl.B[:n], tbl.C[:n],
                    tbl.dn[:n], tbl.w[:n], tbl.ords[:n], tbl.validC[:n])
        key = (self._epoch_dn[stage], self._stage_slots_ver[stage])
        cached = self._cand_cache_c.get(stage)
        if cached is not None and cached[0] == key:
            return cached[1]
        slots = self._stage_slot_arr(stage)
        owner = self._seg_owner[slots]
        down = self._seg_down[slots]
        down_ok = down >= 0
        ds = np.where(down_ok, down, 0)
        valid = (owner >= 0) & down_ok & ~self._is_data_arr[ds]
        cm = self._cm_np
        wc = cm[np.where(owner >= 0, owner, 0), ds] if slots.size else _EMPTY_F
        data = (slots, owner, down, self._seg_dnode[slots], wc,
                self._seg_ord[slots], valid)
        self._cand_cache_c[stage] = (key, data)
        return data

    def _batched_pick(self, cur: np.ndarray, new: np.ndarray,
                      owners: np.ndarray, ords: np.ndarray,
                      peers_arr: np.ndarray, self_id: int,
                      u_rot: float) -> int:
        """Resolve a scan over the candidate arrays.  Returns the index
        (into cur/new) of the accepted candidate or -1, consuming
        acceptance uniforms exactly as the scalar scan: one per
        non-improving candidate visited before the accept (none when
        frozen)."""
        impr_u = new < cur
        if self.T <= 1e-6:                       # frozen: no draws at all
            # only the improving candidates matter; rank just them
            if not impr_u.any():
                return -1
            sub = np.flatnonzero(impr_u)
            rank, n = self._rotation_ranks(peers_arr, self_id, u_rot,
                                           owners[sub])
            if n <= 0:
                return -1
            k = np.lexsort((ords[sub], rank))[0]
            self.T *= self.alpha
            return int(sub[k])
        rank, n = self._rotation_ranks(peers_arr, self_id, u_rot, owners)
        if n <= 0:
            return -1
        order = np.lexsort((ords, rank))
        cur_o = cur[order]
        new_o = new[order]
        impr = impr_u[order]
        has_impr = bool(impr.any())
        fi = int(np.argmax(impr)) if has_impr else len(order)
        if fi and not self._can_rewind:
            # no advance(): draw the prefix uniforms one at a time (the
            # reference's exact consumption), deltas still vectorized
            xs = np.minimum((cur_o[:fi] - new_o[:fi]) / self.T,
                            0.0).tolist()
            uniform = self.rng.uniform
            for t, xv in enumerate(xs):
                if math.exp(xv) > uniform(0.0, 1.0):
                    self.T *= self.alpha
                    return int(order[t])
        elif fi:
            # the non-improving prefix: one uniform each, in visit order.
            # Sized draws produce the reference's exact scalar sequence;
            # np.exp can differ from the reference's math.exp by ~1 ulp,
            # so it only prefilters (with a conservative margin) and the
            # first plausible accept onward is confirmed with math.exp.
            u = self.rng.uniform(0.0, 1.0, size=fi)
            x = np.minimum((cur_o[:fi] - new_o[:fi]) / self.T, 0.0)
            maybe = u < np.exp(x) * (1.0 + 1e-12)
            if maybe.any():
                k0 = int(np.argmax(maybe))
                xl = x[k0:].tolist()
                ul = u[k0:].tolist()
                for t, xv in enumerate(xl):
                    if math.exp(xv) > ul[t]:
                        a = k0 + t
                        unused = fi - (a + 1)
                        if unused:       # return unconsumed draws
                            bg = self.rng.bit_generator
                            st = bg.state
                            bg.advance(-unused)
                            # advance() zeroes the buffered 32-bit half
                            # (has_uint32/uinteger) that bounded-integer
                            # draws (e.g. the round-order shuffle) leave
                            # behind; double draws never touch it, so
                            # restore it to keep the full state
                            # bit-identical to the scalar scan's.
                            st2 = bg.state
                            st2["has_uint32"] = st["has_uint32"]
                            st2["uinteger"] = st["uinteger"]
                            bg.state = st2
                        self.T *= self.alpha
                        return int(order[a])
        if has_impr:
            self.T *= self.alpha
            return int(order[fi])
        return -1

    # ------------------------------------------------------------------
    # Request Change (same-stage peer swap, annealed)
    # ------------------------------------------------------------------
    def _request_change(self, i: int, u_seg: float, u_rot: float) -> bool:
        pi = self.protos[i]
        if not pi.segments:
            return False
        si = pi.segments[int(u_seg * len(pi.segments))]
        si_dn = si.downstream
        if si_dn is None or si_dn in self._data_set:
            return False
        stage = pi.stage
        frozen = self.T <= 1e-6
        if frozen:
            # T is frozen: worsening moves are rejected without drawing
            # randomness, so a fruitless scan is a pure function of the
            # (stage, data_node) downstream state -> memoise against the
            # fine-grained epoch (a removed pair can never turn a
            # fruitless scan fruitful, so membership-only shrinkage
            # needs no bump).
            memo_key = (i, si._order)
            epoch_now = self._epoch_down[(stage, si.data_node)]
            if self._memo_change.get(memo_key) == epoch_now:
                return False
        if self.strict_rng:
            found = self._change_scan_scalar(i, pi, si, u_rot, frozen)
        else:
            found = self._change_scan_batched(i, pi, si, u_rot)
        if found:
            return True
        if frozen:
            self._memo_change[memo_key] = epoch_now
        return False

    def _change_scan_batched(self, i: int, pi: ProtoNode, si: Segment,
                             u_rot: float) -> bool:
        stage = pi.stage
        sc, Jc, Dc, dnc, wc, ordc, vc = self._change_cands(stage)
        if not sc.size:
            return False
        si_dn = si.downstream
        mask = vc & (Jc != i) & (dnc == si.data_node) & (Dc != si_dn)
        if not mask.any():
            return False
        idx = np.flatnonzero(mask)
        J = Jc[idx]
        D = Dc[idx]
        w = wc[idx]
        cm = self._cm_np
        a_cost = cm[i, si_dn]
        if self.objective == "sum":
            cur = a_cost + w
            new = cm[i, D] + cm[J, si_dn]
        else:
            cur = np.maximum(a_cost, w)
            new = np.maximum(cm[i, D], cm[J, si_dn])
        pick = self._batched_pick(cur, new, J, ordc[idx],
                                  self._alive_arr(stage), i, u_rot)
        if pick < 0:
            return False
        sj = self._seg_objs[sc[idx[pick]]]
        self._apply_change(i, pi, si, int(J[pick]), sj)
        return True

    def _change_scan_scalar(self, i: int, pi: ProtoNode, si: Segment,
                            u_rot: float, frozen: bool) -> bool:
        """strict_rng compatibility scan: the reference's per-candidate
        loop, visit order = sorted peers rotated by ``int(u_rot * n)``."""
        stage_lst = self._stage_alive[pi.stage]
        k_self = bisect_left(stage_lst, i)
        present = k_self < len(stage_lst) and stage_lst[k_self] == i
        candidates = (stage_lst[:k_self] + stage_lst[k_self + 1:]
                      if present else stage_lst)
        n = len(candidates)
        if n == 0:
            return False
        start = int(u_rot * n)
        # invariants of the scan, hoisted: si's fields cannot change until
        # an accept (which returns immediately), and T cannot cross the
        # frozen threshold mid-scan for the same reason.
        row_i = self._cml[i]
        data_set = self._data_set
        si_dn, si_data = si.downstream, si.data_node
        sum_obj = self.objective == "sum"
        a_cost = row_i[si_dn]
        protos = self.protos
        for k in range(n):
            t = start + k
            j = candidates[t if t < n else t - n]
            pj = protos[j]
            row_j = self._cml[j]
            rj_si = row_j[si_dn]
            for sj in pj.segments:
                sj_dn = sj.downstream
                if (sj.data_node != si_data or sj_dn is None
                        or sj_dn in data_set or sj_dn == si_dn):
                    continue
                if sum_obj:
                    cur = a_cost + row_j[sj_dn]
                    new = row_i[sj_dn] + rj_si
                else:
                    b = row_j[sj_dn]
                    cur = a_cost if a_cost > b else b
                    nx = row_i[sj_dn]
                    new = nx if nx > rj_si else rj_si
                # inlined _anneal_accept
                if new < cur:
                    self.T *= self.alpha
                elif frozen:
                    continue
                elif not self._anneal_worsening(cur, new):
                    continue
                self._apply_change(i, pi, si, j, sj)
                return True
        return False

    def _apply_change(self, i: int, pi: ProtoNode, si: Segment,
                      j: int, sj: Segment):
        """Accepted Request Change: swap downstream peers; inform the
        next-stage nodes (identical mutation order to the reference)."""
        pj = self.protos[j]
        si_dn, sj_dn = si.downstream, sj.downstream
        self._repoint_upstream(si_dn, old_up=i, new_up=j,
                               data_node=si.data_node)
        self._repoint_upstream(sj_dn, old_up=j, new_up=i,
                               data_node=sj.data_node)
        self._set_downstream(pi, si, sj_dn)
        self._set_downstream(pj, sj, si_dn)
        self._refresh_costs(i)
        self._refresh_costs(j)

    def _repoint_upstream(self, downstream_id: int, *, old_up: int,
                          new_up: Optional[int], data_node: int):
        pd = self.protos.get(downstream_id)
        if pd is None:
            return
        for s in pd.segments:
            if s.upstream == old_up and s.data_node == data_node:
                self._set_upstream(pd, s, new_up)
                return

    # ------------------------------------------------------------------
    # Request Redirect (node substitution, annealed)
    # ------------------------------------------------------------------
    def _request_redirect(self, m: int, u_rot: float) -> bool:
        """Spare node m offers to replace peer b on a chain a -> b -> c."""
        pm = self.protos[m]
        if pm.capacity <= len(pm.segments):      # == pm.free <= 0
            return False
        stage = pm.stage
        frozen = self.T <= 1e-6
        if frozen:
            epoch_now = self._epoch[stage]
            if self._memo_redirect.get(m) == epoch_now:
                return False
        if self.strict_rng:
            found = self._redirect_scan_scalar(m, pm, u_rot, frozen)
        else:
            found = self._redirect_scan_batched(m, pm, u_rot)
        if found:
            return True
        if frozen:
            self._memo_redirect[m] = epoch_now
        return False

    def _redirect_scan_batched(self, m: int, pm: ProtoNode,
                               u_rot: float) -> bool:
        stage = pm.stage
        sr, Ar, Br, Cr, cur_r, ordr, vr = self._redirect_cands(stage)
        if not sr.size:
            return False
        cm = self._cm_np
        mask = vr & (Br != m)
        if not mask.any():
            return False
        idx = np.flatnonzero(mask)
        sl = sr[idx]
        A = Ar[idx]
        B = Br[idx]
        C = Cr[idx]
        cur = cur_r[idx]
        ords = ordr[idx]
        new = cm[A, m] + cm[m, C]
        pick = self._batched_pick(cur, new, B, ords,
                                  self._wseg_arr(stage), m, u_rot)
        if pick < 0:
            return False
        sb = self._seg_objs[sl[pick]]
        self._apply_redirect(m, pm, int(B[pick]), sb)
        return True

    def _redirect_scan_scalar(self, m: int, pm: ProtoNode, u_rot: float,
                              frozen: bool) -> bool:
        """strict_rng compatibility scan (rotation visit order)."""
        # == sorted(j for j in pm.known_same if alive proto w/ segments)
        stage_lst = self._stage_with_segs[pm.stage]
        k_self = bisect_left(stage_lst, m)
        present = k_self < len(stage_lst) and stage_lst[k_self] == m
        peers = (stage_lst[:k_self] + stage_lst[k_self + 1:]
                 if present else stage_lst)
        n = len(peers)
        if n == 0:
            return False
        start = int(u_rot * n)
        row_m = self._cml[m]
        cml = self._cml
        protos = self.protos
        for k in range(n):
            t = start + k
            b = peers[t if t < n else t - n]
            pb = protos[b]
            row_b = cml[b]
            for sb in pb.segments:
                a = sb.upstream
                c = sb.downstream
                if a is None or c is None:
                    continue
                row_a = cml[a]
                cur = row_a[b] + row_b[c]
                new = row_a[m] + row_m[c]
                # inlined _anneal_accept
                if new < cur:
                    self.T *= self.alpha
                elif frozen:
                    continue
                elif not self._anneal_worsening(cur, new):
                    continue
                self._apply_redirect(m, pm, b, sb)
                return True
        return False

    def _apply_redirect(self, m: int, pm: ProtoNode, b: int, sb: Segment):
        """Accepted Request Redirect: b approves, m takes over the
        segment (identical mutation order to the reference)."""
        pb = self.protos[b]
        a, c = sb.upstream, sb.downstream
        row_m = self._cml[m]
        row_b = self._cml[b]
        self._remove_segment(pb, sb)
        seg = dataclasses.replace(
            sb, cost_to_sink=sb.cost_to_sink - row_b[c] + row_m[c])
        self._append_segment(pm, seg)
        # upstream a (may be the data node) and downstream c repoint
        pa = self.protos.get(a)
        if pa is not None:
            for s in pa.segments:
                if s.downstream == b and s.data_node == sb.data_node:
                    self._set_downstream(pa, s, m)
                    break
        if c not in self._data_set:
            self._repoint_upstream(c, old_up=b, new_up=m,
                                   data_node=sb.data_node)
        self._refresh_costs(m)

    def _anneal_accept(self, cur: float, new: float) -> bool:
        """Semantic definition of annealed acceptance.  The hot scans in
        _request_change/_request_redirect inline the improving/frozen
        branches and call _anneal_worsening directly — keep the three in
        sync (and in sync with ReferenceGWTFProtocol._anneal_accept)."""
        if new < cur:
            self.T *= self.alpha
            return True
        if self.T <= 1e-6:
            return False
        return self._anneal_worsening(cur, new)

    def _anneal_worsening(self, cur: float, new: float) -> bool:
        """Annealed acceptance of a non-improving move (T > 1e-6)."""
        p = math.exp(min((cur - new) / self.T, 0.0))
        if p > self.rng.uniform(0.0, 1.0):
            self.T *= self.alpha
            return True
        return False

    def _refresh_costs(self, i: int):
        """Recompute cost_to_sink for node i and propagate to feeders.

        Level-order propagation with the shared message-passing rules
        (see ``ReferenceGWTFProtocol._refresh_costs``): each wave node
        recomputes all its segments once, and only *changed* values are
        forwarded to the segment's feeder.  ``pair_map`` carries the
        previous level's just-recomputed (node, upstream, data_node) ->
        cost entries so the feeder resolves its downstream pairing in
        O(1); pairings outside the wave fall back to the reference's
        segment-list scan (first match wins) and read the same values.
        """
        data_set = self._data_set
        cml = self._cml
        protos = self.protos
        level = [i]
        seen = {i}
        pair_map: Dict[Tuple[int, int, int], float] = {}
        while level:
            nxt: List[int] = []
            new_pairs: Dict[Tuple[int, int, int], float] = {}
            setpair = new_pairs.setdefault
            for nid in level:
                pi = protos.get(nid)
                if pi is None:
                    continue
                row = cml[nid]
                for s in pi.segments:
                    sd = s.downstream
                    changed = False
                    if sd is not None:
                        if sd in data_set:
                            down_cost = 0.0
                        else:
                            down_cost = pair_map.get((sd, nid, s.data_node))
                            if down_cost is None:
                                down_cost = 0.0
                                pd = protos.get(sd)
                                if pd is not None:
                                    for seg_d in pd.segments:
                                        if (seg_d.upstream == nid
                                                and seg_d.data_node
                                                == s.data_node):
                                            down_cost = seg_d.cost_to_sink
                                            break
                        val = down_cost + row[sd]
                        if val != s.cost_to_sink:
                            s.cost_to_sink = val
                            changed = True
                            if s.upstream is None:
                                # an advertised (unpaired-outflow) cost
                                # moved: keep the dense vector current
                                self._adv_update(nid, s.data_node)
                    su = s.upstream
                    if su is not None and su not in data_set:
                        # record every pairing (first match in segment-
                        # list order wins, exactly like the scan — an
                        # earlier unchanged or unpaired-downstream
                        # segment must shadow a later changed one)
                        setpair((nid, su, s.data_node), s.cost_to_sink)
                        if changed and su not in seen:
                            seen.add(su)
                            nxt.append(su)
            level = nxt
            pair_map = new_pairs

    # ------------------------------------------------------------------
    # Round driver
    # ------------------------------------------------------------------
    def step_round(self) -> int:
        """One synchronous protocol round; returns number of state changes."""
        self._refresh_cost_source()
        changes = 0
        if self._order_cache is None:
            self._order_cache = np.asarray(sorted(self.protos))
        order = self._order_cache.copy()
        self.rng.shuffle(order)
        # the round's RNG block (shared discipline with the reference):
        # row k = (source rotation, segment choice, change rotation,
        # redirect rotation) for node order[k]; unused slots unread.
        block = self.rng.random((len(order), 4))
        data_set = self._data_set
        # liveness is static within a round: hoist the alive source list
        # the per-node rotations index into
        nodes = self.net.nodes
        alive_dns = [d for d in self._data_ids if nodes[d].alive]
        ndns = len(alive_dns)
        refine = self.refine
        protos = self.protos
        broken = self._broken
        adv_get = self._advertisers.get
        sink_slots = self._sink_slots
        request_flow = self._request_flow
        request_change = self._request_change
        request_redirect = self._request_redirect
        for k, i in enumerate(order.tolist()):
            pi = protos[i]
            if not pi.alive or i in data_set:
                continue
            if (pi.capacity > len(pi.segments)
                    and pi.n_up_unpaired == 0 and pi.n_down_unpaired == 0):
                if ndns > 1:
                    r = int(block[k, 0] * ndns)
                    dns = alive_dns[r:] + alive_dns[:r]
                else:
                    dns = alive_dns
                known = pi.known_next
                for dn in dns:
                    if pi.capacity <= len(pi.segments):
                        break
                    # inline fast-fail of _best_advertiser: no known
                    # advertiser and no reachable free sink slot
                    adv = adv_get(dn)
                    if ((not adv or adv.isdisjoint(known))
                            and (dn not in known or sink_slots[dn] <= 0)):
                        continue
                    if request_flow(i, dn):
                        changes += 1
            # nodes with unpaired inflow (downstream lost) re-pair downstream
            if i in broken:
                for s in list(pi.segments):
                    if s.downstream is None:
                        if self._repair_downstream(i, s):
                            s._deny_after = 3
                            changes += 1
                        else:
                            # DENY (Sec. V-D): if no alternate peer exists after
                            # a few attempts, release the segment and tell the
                            # upstream so the flow can be redistributed.
                            s._deny_after = getattr(s, "_deny_after", 3) - 1
                            if s._deny_after <= 0:
                                self._deny(i, s)
                                changes += 1
            # annealed refinement runs for every relay, every round
            # (paper Sec. V-C)
            if refine:
                if request_change(i, block[k, 1], block[k, 2]):
                    changes += 1
                if request_redirect(i, block[k, 3]):
                    changes += 1
        # data nodes also repair source-side segments whose downstream died
        for dn_id in self._data_ids:
            pd = self.protos.get(dn_id)
            if pd is None or dn_id not in self._broken:
                continue
            for s in list(pd.segments):
                if s.downstream is None:
                    self._remove_segment(pd, s)  # re-issue via _connect_sources
                    changes += 1
        # data nodes (source side) connect to stage-0 unpaired outflows
        changes += self._connect_sources()
        return changes

    def _repair_downstream(self, i: int, seg: Segment) -> bool:
        """Re-pair a segment whose downstream crashed (unpaired inflow)."""
        pi = self.protos[i]
        best_j, _, best_cts = self._best_advertiser(i, seg.data_node)
        if best_j is None:
            return False
        row = self._cml[i]
        if best_j in self._data_set:
            if self._sink_slots[best_j] <= 0:
                return False
            self._sink_slots[best_j] -= 1
            self._set_downstream(pi, seg, best_j)
            seg.cost_to_sink = row[best_j]
            if seg.upstream is None:
                self._adv_update(i, seg.data_node)
            return True
        for s in self._unpaired_in_list_order(best_j, seg.data_node):
            if abs(s.cost_to_sink - best_cts) < 1e-9:
                self._set_upstream(self.protos[best_j], s, i)
                self._set_downstream(pi, seg, best_j)
                seg.cost_to_sink = s.cost_to_sink + row[best_j]
                if seg.upstream is None:
                    self._adv_update(i, seg.data_node)
                return True
        return False

    def _deny(self, i: int, seg: Segment):
        """Drop an unrepairable segment and unpair its upstream feeder."""
        pi = self.protos.get(i)
        if pi is None or seg not in pi.segments:
            return
        up = seg.upstream
        self._remove_segment(pi, seg)
        if up is None:
            return
        pu = self.protos.get(up)
        if pu is None:
            return
        if up in self._data_set:
            # the source drops its segment and re-issues via connect_sources
            for su in list(pu.segments):
                if su.downstream == i and su.data_node == seg.data_node:
                    self._remove_segment(pu, su)
                    break
        else:
            for su in pu.segments:
                if su.downstream == i and su.data_node == seg.data_node:
                    self._set_downstream(pu, su, None)
                    break

    def _connect_sources(self) -> int:
        """Source side of each data node pairs with stage-0 unpaired outflows."""
        changes = 0
        for dn_id in self._data_ids:
            dn = self.net.nodes[dn_id]
            if not dn.alive:
                continue
            pd = self.protos[dn_id]
            row = self._cml[dn_id]
            while pd.used < pd.capacity:
                best = None
                adv = self._advertisers.get(dn_id)
                if adv and not adv.isdisjoint(pd.known_next):
                    for j in pd.known_next:
                        if j not in adv:
                            continue
                        for s in self._unpaired_in_list_order(j, dn_id):
                            total = s.cost_to_sink + row[j]
                            if best is None or total < best[0]:
                                best = (total, j, s)
                if best is None:
                    break
                _, j, s = best
                self._set_upstream(self.protos[j], s, dn_id)
                self._append_segment(pd, Segment(s.flow_id, dn_id, j, None,
                                                 best[0]))
                changes += 1
        return changes

    def run(self, max_rounds: int = 200, quiet_rounds: int = 25) -> int:
        quiet = 0
        r = 0
        for r in range(max_rounds):
            if self.step_round() == 0:
                quiet += 1
                if quiet >= quiet_rounds:
                    break
            else:
                quiet = 0
        return r + 1

    # ------------------------------------------------------------------
    # Results
    # ------------------------------------------------------------------
    def complete_flows(self) -> List[List[int]]:
        """Chains data_node -> s0 -> ... -> s(S-1) -> data_node."""
        chains = []
        visited = set()
        for dn_id in self._data_ids:
            pd = self.protos.get(dn_id)
            if pd is None:
                continue
            for seg in pd.segments:
                chain = [dn_id]
                prev, cur = dn_id, seg.downstream
                ok = True
                for _ in range(self.net.num_stages + 1):
                    if cur is None:
                        ok = False
                        break
                    chain.append(cur)
                    if cur == dn_id:
                        break
                    pc = self.protos.get(cur)
                    nxt = None
                    if pc is not None:
                        for s in pc.segments:
                            if (id(s) not in visited and s.upstream == prev
                                    and s.data_node == dn_id):
                                nxt = s.downstream
                                visited.add(id(s))
                                break
                    prev, cur = cur, nxt
                if ok and chain[-1] == dn_id and len(chain) == self.net.num_stages + 2:
                    chains.append(chain)
        return chains

    def flow_costs(self) -> List[float]:
        self._refresh_cost_source()
        costs = []
        for chain in self.complete_flows():
            c = sum(self.d(chain[k], chain[k + 1]) for k in range(len(chain) - 1))
            costs.append(c)
        return costs

    def total_cost(self) -> float:
        return float(sum(self.flow_costs()))

    def flow_codecs(self) -> List[List[str]]:
        """Per-edge chosen wire codec for every complete flow.

        Mirrors ``complete_flows()``: entry ``k`` of chain ``c`` is the
        codec the network priced edge ``(chain[k], chain[k+1])`` at, at
        the planner's activation size.  With an explicit external
        ``cost_matrix`` (abstract topologies) the menu is whatever the
        network carries — by construction fp32-only there.
        """
        names = self.net.wire_codec_names()
        choice = self.net.wire_codec_matrix()
        return [[names[choice[a, b]] for a, b in zip(chain, chain[1:])]
                for chain in self.complete_flows()]

    def max_edge_cost(self) -> float:
        self._refresh_cost_source()
        m = 0.0
        for chain in self.complete_flows():
            for k in range(len(chain) - 1):
                m = max(m, self.d(chain[k], chain[k + 1]))
        return m

    # ------------------------------------------------------------------
    # Churn hooks (used by the simulator)
    # ------------------------------------------------------------------
    def reclaim_sink_slots(self):
        """Recount free sink slots + garbage-collect stale segments.

        A segment left unpaired across two consecutive reclaim passes (one
        full iteration each) is dropped — the paper's "nodes that send
        DENY are excluded until they free memory" applied to dead flows.
        """
        self._gc_pass = getattr(self, "_gc_pass", 0) + 1
        for p in self.protos.values():
            if p.node_id in self._data_set:
                continue
            for s in list(p.segments):
                unpaired = s.upstream is None or s.downstream is None
                last = getattr(s, "_stale_since", None)
                if unpaired:
                    if last is None:
                        s._stale_since = self._gc_pass
                    elif self._gc_pass - last >= 2:
                        # free the memory; downstream/upstream unpair too
                        if s.downstream is not None:
                            self._repoint_upstream(s.downstream, old_up=p.node_id,
                                                   new_up=None,
                                                   data_node=s.data_node)
                        if s.upstream is not None:
                            pu = self.protos.get(s.upstream)
                            if pu is not None:
                                for su in pu.segments:
                                    if (su.downstream == p.node_id
                                            and su.data_node == s.data_node):
                                        self._set_downstream(pu, su, None)
                                        break
                        self._remove_segment(p, s)
                else:
                    s._stale_since = None
        for dn_id in self._data_ids:
            dn = self.net.nodes[dn_id]
            used = 0
            for p in self.protos.values():
                if p.node_id in self._data_set:
                    continue
                for s in p.segments:
                    if s.downstream == dn_id and s.data_node == dn_id:
                        used += 1
            self._sink_slots[dn_id] = max(0, dn.capacity - used)

    def remove_node(self, nid: int):
        """Crash: drop the node, unpair all segments that touched it."""
        p = self.protos.pop(nid, None)
        if p is None:
            return
        self._order_cache = None
        self._known_arr.clear()     # membership views change below
        if nid not in self._data_set:
            for seg in p.segments:
                if seg.upstream is None:
                    self._index_discard(p, seg)
                self._memo_change.pop((nid, seg._order), None)
                self._slot_drop(p, seg)
            self._memo_redirect.pop(nid, None)
            if p.stage >= 0:
                self._epoch[p.stage] += 1
                self._epoch_dn[p.stage] += 1
                alive = self._stage_alive[p.stage]
                k = bisect_left(alive, nid)
                if k < len(alive) and alive[k] == nid:
                    del alive[k]
                    self._alive_ver[p.stage] += 1
                if p.segments:
                    self._stage_with_segs[p.stage].remove(nid)
                    self._wseg_ver[p.stage] += 1
        self._broken.discard(nid)
        for other in self.protos.values():
            other.known_next.discard(nid)
            other.known_same.discard(nid)
            for s in other.segments:
                if s.downstream == nid:
                    self._set_downstream(other, s, None)  # re-pair later
                if s.upstream == nid:
                    self._set_upstream(other, s, None)    # unpaired outflow again
        # sink slots freed for flows that died with this node are reclaimed
        # lazily by the simulator between iterations.

    def add_node(self, node: Node):
        """Join: create protocol state with adjacent-stage views.

        Churn events are rare relative to rounds, so this mirrors the
        reference's O(N) membership walk; only the indexes and epochs
        need extra bookkeeping.
        """
        self._refresh_cost_source()
        S = self.net.num_stages
        p = ProtoNode(node.id, node.stage, node.capacity)
        if node.stage == S - 1:
            p.known_next = {m.id for m in self.net.data_nodes() if m.alive}
        else:
            p.known_next = {m.id for m in self.net.stage_nodes(node.stage + 1)}
        p.known_same = {m.id for m in self.net.stage_nodes(node.stage)} - {node.id}
        self.protos[node.id] = p
        self._order_cache = None
        self._known_arr.clear()     # membership views change below
        if node.id >= len(self._is_data_arr):
            new_n = max(node.id + 1, 2 * len(self._is_data_arr))
            grown = np.zeros(new_n, bool)
            grown[:len(self._is_data_arr)] = self._is_data_arr
            self._is_data_arr = grown
            for dn, arr in list(self._adv_cost.items()):
                big = np.full(new_n, np.inf)
                big[:len(arr)] = arr
                self._adv_cost[dn] = big
        if 0 <= node.stage:
            self._epoch[node.stage] += 1
            insort(self._stage_alive[node.stage], node.id)
            self._alive_ver[node.stage] += 1
        for other in self.protos.values():
            if other.node_id == node.id:
                continue
            on = self.net.nodes.get(other.node_id)
            if on is None:
                continue
            if on.stage == node.stage - 1 or (on.is_data and node.stage == 0):
                other.known_next.add(node.id)
            if on.stage == node.stage and not on.is_data:
                other.known_same.add(node.id)
            if on.is_data and node.stage == S - 1:
                p.known_next.add(on.id)
