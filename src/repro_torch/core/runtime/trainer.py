"""Training loop over the staged runtime: aggregation, AdamW, checkpoints.

Port of ``repro.core.runtime.trainer``: the same iteration, repair
bookkeeping, chunking, gradient screen, reputation and checkpoint
cadence, over torch tensors on ``device`` (``cuda`` unless the caller
asks for the CPU).  Host syncs stay where the JAX package has them: one
``float`` of the loss per dispatch chunk, and the gradient screen's copy
of every per-microbatch gradient to the host; besides, each chunk's tokens
and labels are copied to the device from pageable host memory.
``IterationResult.host_syncs`` counts these blocking round trips where
each is made, and ``repro_torch.spans`` marks the iteration's phases
(``churn``, ``plan``, ``resolve``, ``execute``, ``commit``) and each
chunk's dispatches.

`RuntimeTrainer` wires the layers together into the paper's iteration
(Sec. V-E):

1. the fault layer samples crashes/rejoins (`ChurnModel` through the
   same `ChurnContext` the simulator uses; rejoining nodes bootstrap by
   downloading their stage snapshot via ``checkpoint.store.restore_stage``
   when a checkpoint directory is configured);
2. the routing policy plans this iteration's complete-flow chains and
   microbatches are assigned to them;
3. `RecoveryManager` resolves every mid-iteration crash against the
   policy (stage-local substitute, requeue onto another chain, or
   drop);
4. the numeric pass executes the completed microbatches through
   `StageCompute` in **depth-first dispatch chunks**: each chunk of up
   to `dispatch_chunk` stacked microbatches runs embed → fused
   per-stage forwards (capturing VJP residuals in the
   `ActivationStore`) → loss head → per-stage backwards consuming the
   stored residuals — so the backward never recomputes the forward and
   a stage's residuals are freed as soon as its chunk's backward used
   them (peak residency ~ one chunk per stage).  Each recorded crash
   additionally dispatches the dead replica's lost work (via
   `RecoveryManager.replay_lost`, from stored residuals where
   available), so recovery cost is real wall time, not bookkeeping.
   ``remat=True`` switches the backward to the rematerialising oracle
   path (same compiled programs, composed — bit-identical gradients,
   no residual storage); ``activation_codec="int8"`` quantises the
   store at a bounded fidelity cost;
5. per-stage gradients are averaged over completed microbatches and
   applied with an AdamW update (identical on every replica, so
   replicas stay bit-identical), and stage snapshots are written to
   ``checkpoint.store`` every ``checkpoint_every`` iterations.

`CentralizedTrainer` (the Fig. 6 baseline) lives here too and runs the
*same* chunked pass (`_chunk_pass`) over the same cached kernels, so
at churn 0 the decentralized trainer executes bit-for-bit the
identical float program; the ``repro_torch.core.executor`` facade
re-exports both.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, spans
from repro_torch.checkpoint import store as ckpt
from repro_torch.core.flow.graph import FlowNetwork, Node
from repro_torch.core.runtime import cache
from repro_torch.core.runtime.activations import ActivationStore, make_codec
from repro_torch.core.runtime.recovery import Job, RecoveryManager, Resolution
from repro_torch.core.runtime.stages import StageCompute
from repro_torch.core.sim.faults import (BernoulliChurn, ChurnContext,
                                         ChurnModel, adversarial_plan)
from repro_torch.core.sim.policies import GWTFPolicy, RoutingPolicy
from repro_torch.core.sim.timeline import FaultTimeline, record_injections
from repro_torch.models.transformer import DTYPES
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import leaves, tree_map

# Depth-first dispatch chunking: stack at most this many microbatches
# per stage dispatch, shrinking toward 1 when a single microbatch's
# boundary activation exceeds the byte target.  Tuned on the 1-core CI
# host where small chunks keep residuals cache-hot between a stage's
# forward and its backward; multi-core hosts may prefer larger chunks
# via the ``dispatch_chunk`` kwarg.  Both trainers share this rule —
# chunking changes gradient-accumulation association, so bit-identity
# requires identical chunk boundaries.
_CHUNK_TARGET_BYTES = 256 * 1024
_CHUNK_MAX_MB = 4


def auto_chunk(n_mb: int, per: int, seq: int, d_model: int,
               itemsize: int = 4) -> int:
    """Microbatches per dispatch chunk (deterministic, shared by both
    trainers)."""
    mb_bytes = max(1, per * seq * d_model * itemsize)
    return max(1, min(_CHUNK_MAX_MB, n_mb,
                      _CHUNK_TARGET_BYTES // mb_bytes))


class _WireLink:
    """Per-boundary wire codecs for inter-stage chunk transfers.

    ``send(s, x)`` encodes + decodes the boundary activation leaving
    stage ``s`` with the codec the planner chose for that boundary's
    link (encode → wire → decode; the receiving stage computes on the
    decoded tensor, so compression fidelity costs are *real* in the
    loss, not simulated).  Cotangents stay exact: crash replay consumes
    stored residuals, and compressing the backward would double-charge
    the fidelity budget the planner priced for one crossing.
    ``bytes`` accumulates the encoded (on-wire) payload size.
    """

    def __init__(self, names: List[str]):
        self.names = list(names)
        self._codecs = [make_codec(n) for n in self.names]
        self.bytes = 0

    def send(self, boundary: int, x):
        codec = self._codecs[boundary]
        enc = codec.encode(x)
        self.bytes += int(codec.nbytes(enc))
        return codec.decode(enc)


class HostSyncs:
    """Blocking host-device round trips of a numeric pass, counted where
    each is made: a copy of a host array to the device without
    ``non_blocking``, a read of a device value to the host.  The count is
    the same on any device."""
    __slots__ = ("n",)

    def __init__(self) -> None:
        self.n = 0


def _chunk_pass(stages: StageCompute, store: ActivationStore,
                stage_params: List[Any], head_params, toks, labels,
                ids: Tuple[int, ...], per: int, *, remat: bool,
                grad_stage: List[Any], syncs: HostSyncs,
                replay: Optional[Callable] = None,
                wire: Optional[_WireLink] = None) -> Tuple[float, Any]:
    """One depth-first chunk: embed → per-stage forward (fused residual
    capture unless ``remat``) → loss head → per-stage backward from
    stored residuals (or remat oracle) → embedding pull-back.

    Shared verbatim by `RuntimeTrainer` and `CentralizedTrainer`: at
    churn 0 (``replay=None``) both execute exactly this program, which
    is what makes the bit-identity invariant hold by construction.
    ``wire`` (when set) compresses each inter-stage boundary transfer
    with that boundary's planner-chosen codec — callers pass ``None``
    (not a no-op wire) for fp32 so the bit-identity path stays
    untouched.  Accumulates per-stage gradients into ``grad_stage`` in
    place; returns ``(loss_sum, g_head)`` with the embedding share
    included.
    """
    S = len(stage_params)
    with spans.span("embed"):
        x = stages.embed(head_params, toks)
    for s in range(S):
        store.put(s, ids, x)
        with spans.span("stage.fwd", stage=s):
            if remat:
                x = stages.forward(s, stage_params[s], x)
            else:
                x, resid = stages.forward_fused(s, stage_params[s], x)
                store.put_residuals(s, ids, resid)
        if replay is not None:
            replay(s, "fwd", ids)
        if wire is not None and s < S - 1:
            x = wire.send(s, x)
    B = len(ids)
    seq, D = x.shape[1], x.shape[-1]
    h = x.reshape(B, per, seq, D)
    with spans.span("head_loss"):
        losses, g_head, g_hidden = stages.head_loss(head_params, h, labels)
    g = g_hidden.reshape(B * per, seq, D)
    for s in reversed(range(S)):
        if replay is not None:
            replay(s, "bwd", ids, g, per)
        with spans.span("stage.bwd", stage=s):
            if remat:
                xin = store.stacked(s, ids)
                dp, dx = stages.backward(s, stage_params[s], xin, g)
            else:
                dp, dx = stages.backward_from_residuals(
                    s, store.residuals(s, ids), g)
            grad_stage[s] = (dp if grad_stage[s] is None else
                            tree_map(torch.add, grad_stage[s], dp))
        g = dx
        store.drop(s, ids)
    with spans.span("embed.bwd"):
        g_emb = stages.embed_backward(head_params, toks, g)
    with spans.span("loss_sync"):
        loss_sum = float(losses.sum())
    syncs.n += 1
    return loss_sum, tree_map(torch.add, g_head, g_emb)


@dataclass
class IterationResult:
    loss: float
    completed: int
    launched: int
    dropped: int
    rerouted: int = 0             # crash repairs that saved the microbatch
    requeued: int = 0             # subset of rerouted: moved to another chain
    fwd_recomputes: int = 0       # stage-local forward recomputes (Sec. V-D)
    bwd_replays: int = 0          # stage-local VJP replays (Sec. V-D)
    store_peak_bytes: int = 0     # high-water resident activation+residual
                                  # bytes (encoded) during the numeric pass
    wire_bytes: int = 0           # encoded bytes sent over inter-stage
                                  # boundaries (0 when the wire is fp32)
    wire_codecs: Tuple[str, ...] = ()   # applied codec per stage boundary
                                  # (empty when the wire is fp32/off)
    deadline_requeues: int = 0    # subset of rerouted: re-dispatches
                                  # fired by the sender's deadline on a
                                  # hung/straggling (alive) relay
    grads_flagged: int = 0        # contributions the gradient screen
                                  # excluded from this update (the jobs
                                  # still count as completed)
    host_syncs: int = 0           # blocking host-device round trips of
                                  # the numeric pass (`HostSyncs`)


def _batch(mbs: List[dict], device, syncs: HostSyncs
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked tokens (B * per, S) and labels (B, per, S) of microbatches,
    as int64 on ``device``: two blocking copies from pageable memory."""
    with spans.span("batch"):
        toks = np.concatenate([np.asarray(mb["tokens"]) for mb in mbs])
        labels = np.stack([np.asarray(mb["labels"]) for mb in mbs])
        out = (torch.from_numpy(toks).long().to(device),
               torch.from_numpy(labels).long().to(device))
    syncs.n += 2
    return out


def _chunk_size(cfg, dispatch_chunk: Optional[int], n_mb: int, per: int,
                seq: int) -> int:
    if dispatch_chunk is not None:
        return max(1, min(dispatch_chunk, n_mb))
    itemsize = DTYPES[cfg.param_dtype].itemsize
    return auto_chunk(n_mb, per, seq, cfg.d_model, itemsize)


class RuntimeTrainer:
    """GWTF training with real torch compute over the staged runtime."""

    def __init__(self, cfg, net: FlowNetwork, *,
                 churn: float = 0.0, lr: float = 1e-3, seed: int = 0,
                 rng: Optional[np.random.Generator] = None,
                 policy: Optional[RoutingPolicy] = None,
                 churn_model: Optional[ChurnModel] = None,
                 batch_microbatches: bool = True,
                 max_retries: int = 2,
                 timeout: float = 30.0,
                 deadline_defense: bool = True,
                 grad_screen: Optional[bool] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0,
                 record_microbatch_grads: bool = False,
                 remat: bool = False,
                 activation_codec: str = "fp",
                 wire_codec: Optional[str] = None,
                 dispatch_chunk: Optional[int] = None,
                 device="cuda"):
        self.cfg = cfg
        self.net = net
        self.device = resolve_device(device)
        self.rng = rng or np.random.default_rng(seed)
        self.policy = policy or GWTFPolicy(net, rng=self.rng)
        self.churn_model = churn_model or BernoulliChurn(churn)
        self.batch_microbatches = batch_microbatches
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.record_microbatch_grads = record_microbatch_grads
        self.remat = remat
        # wire_codec: None/"fp"/"fp32" leaves boundary transfers exact;
        # "planner" applies, per stage boundary, the codec the network's
        # menu chose for that boundary's planned links; any codec name
        # ("bf16"/"int8"/"top-k") forces it on every boundary.
        self.wire_codec = wire_codec
        self.dispatch_chunk = dispatch_chunk

        # defenses against beyond-fail-stop faults: the sender-side
        # deadline (hung/straggling relays are requeued, mirroring the
        # sim engine) and the gradient screen (norm/cosine outlier test
        # over per-microbatch contributions before aggregation).
        # grad_screen=None auto-enables the screen exactly when the
        # churn model injects corrupt gradients; False is the
        # undefended baseline the adversarial benchmarks compare.
        self.grad_screen = grad_screen
        self.timeline = FaultTimeline()

        self.stages = StageCompute(cfg, net.num_stages)
        self.store = ActivationStore(codec=activation_codec)
        self.recovery = RecoveryManager(net, self.policy,
                                        max_retries=max_retries,
                                        timeout=timeout,
                                        deadline_defense=deadline_defense)

        S = net.num_stages
        # identical replicas per stage (paper: joining nodes download the
        # stage weights) -> ONE canonical copy per stage; replicas share
        # it because aggregation keeps them identical.  Initial trees
        # come from the process-wide cache (immutable, replaced on
        # update, so sharing across trainers cannot leak state).
        stage_p, head_p = cache.initial_params(cfg, S, seed, self.device)
        self.stage_params = list(stage_p)
        self.head_params = {d.id: head_p for d in net.data_nodes()}
        self.opt = AdamW(lr=lr)
        self.stage_opt = [self.opt.init(p) for p in self.stage_params]
        self.head_opt = {d: self.opt.init(p)
                         for d, p in self.head_params.items()}
        self._upd = self.opt.update

        self.losses: List[float] = []
        self.step = 0
        self.joins_bootstrapped = 0
        self.last_microbatch_grads: List[Tuple[int, Any, Any]] = []
        # introspection for tests/examples: the most recent iteration's
        # planned chains, crash resolution, and store high-water mark
        self.last_chains: List[List[int]] = []
        self.last_resolution: Optional[Resolution] = None
        self.last_store_peak_bytes = 0
        self.last_wire_codecs: List[str] = []
        self.last_wire_bytes = 0

    # ------------------------------------------------------------------
    @property
    def protocol(self):
        """The GWTF protocol behind the routing policy, when there is
        one (pre-refactor compat accessor; ``None`` for policies that
        are not flow-based)."""
        return getattr(self.policy, "protocol", None)

    # ------------------------------------------------------------------
    # Fault-layer hooks
    # ------------------------------------------------------------------
    def _on_rejoin(self, node: Node) -> None:
        """Sec. V-E join path: the rejoining replica downloads its
        stage's latest snapshot before re-entering the flow graph.
        The restored tree is discarded afterwards because replicas
        share one canonical copy (the aggregation invariant keeps them
        bit-identical); the download itself — and its validation
        against the live stage structure — is the exercised path."""
        if (self.checkpoint_dir and node.stage >= 0
                and os.path.exists(os.path.join(
                    self.checkpoint_dir, f"stage_{node.stage:03d}.npz"))):
            ckpt.restore_stage(self.checkpoint_dir, node.stage,
                               {"params": self.stage_params[node.stage],
                                "opt": self.stage_opt[node.stage]})
            self.joins_bootstrapped += 1
        self.policy.on_rejoin(node)

    # ------------------------------------------------------------------
    # Checkpoint plumbing
    # ------------------------------------------------------------------
    def save_checkpoint(self, dirpath: Optional[str] = None) -> str:
        """Per-stage snapshots (params + AdamW state) plus the data-node
        heads; the unit a joining node downloads (paper Sec. V-E)."""
        d = dirpath or self.checkpoint_dir
        if not d:
            raise ValueError("no checkpoint directory configured")
        for s, (p, o) in enumerate(zip(self.stage_params, self.stage_opt)):
            ckpt.save_stage(d, s, {"params": p, "opt": o}, step=self.step)
        for dn, p in self.head_params.items():
            ckpt.save(os.path.join(d, f"head_{dn:03d}.npz"),
                      {"params": p, "opt": self.head_opt[dn]},
                      step=self.step)
        return d

    def restore_checkpoint(self, dirpath: Optional[str] = None) -> int:
        """Resume every stage + head from snapshots; returns the step."""
        d = dirpath or self.checkpoint_dir
        if not d:
            raise ValueError("no checkpoint directory configured")
        step = 0
        for s in range(self.net.num_stages):
            tree, step = ckpt.restore_stage(
                d, s, {"params": self.stage_params[s],
                       "opt": self.stage_opt[s]})
            self.stage_params[s] = tree["params"]
            self.stage_opt[s] = tree["opt"]
        for dn in self.head_params:
            tree, step = ckpt.restore(
                os.path.join(d, f"head_{dn:03d}.npz"),
                {"params": self.head_params[dn], "opt": self.head_opt[dn]})
            self.head_params[dn] = tree["params"]
            self.head_opt[dn] = tree["opt"]
        self.step = step
        return step

    # ------------------------------------------------------------------
    # Wire codec (planner-chosen per-boundary compression)
    # ------------------------------------------------------------------
    def _make_wire(self, chains: List[List[int]]) -> Optional[_WireLink]:
        """Resolve this iteration's per-boundary wire codecs.

        ``"planner"`` mode reads the network's codec-choice matrix at
        the hop each planned chain crosses between stages ``s`` and
        ``s+1`` and applies the modal choice per boundary (chunks stack
        microbatches from several chains, so one codec per boundary;
        ties resolve to the earlier menu entry).  Returns ``None`` when
        every boundary resolves to fp32 — the exact path must not even
        construct a wire, so bit-identity survives by construction.
        """
        spec = self.wire_codec
        if spec is None or spec in ("fp", "fp32"):
            return None
        S = self.net.num_stages
        if S < 2:
            return None
        if spec != "planner":
            return _WireLink([spec] * (S - 1))
        menu = self.net.wire_codec_names()
        if len(menu) <= 1:
            return None
        choice = self.net.wire_codec_matrix()
        names = []
        for s in range(S - 1):
            votes: Dict[int, int] = {}
            for chain in chains:
                k = int(choice[chain[s + 1], chain[s + 2]])
                votes[k] = votes.get(k, 0) + 1
            best = (min(votes, key=lambda k: (-votes[k], k))
                    if votes else 0)
            names.append(menu[best])
        if all(n == "fp32" for n in names):
            return None
        return _WireLink(names)

    # ------------------------------------------------------------------
    # One training iteration
    # ------------------------------------------------------------------
    def iteration(self, batches_per_data_node: Dict[int, List[dict]]
                  ) -> IterationResult:
        it = self.step
        with spans.span("iteration", iteration=it):
            horizon = 1.0                    # normalized pipeline-flush clock
            with spans.span("churn"):
                crash_times = self.churn_model.sample(ChurnContext(
                    net=self.net, rng=self.rng, horizon=horizon,
                    iteration=it, on_rejoin=self._on_rejoin))
                # adversarial side channel — None for plain fail-stop
                # models, keeping every defended branch below inert.
                # Injections are recorded from the same model outputs the
                # simulator records from, which is what makes the two
                # layers' timelines injection-count identical by
                # construction.
                adv = adversarial_plan(self.churn_model, it)
                record_injections(self.timeline, it, crash_times, adv)

            with spans.span("plan"):
                chains = [list(c) for c in self.policy.plan()]
            jobs: List[Job] = []
            per_dn: Dict[int, int] = {}
            for chain in chains:
                dn = chain[0]
                avail = batches_per_data_node.get(dn, [])
                k = per_dn.get(dn, 0)
                if k < len(avail):
                    jobs.append(Job(index=len(jobs), data_node=dn,
                                    mb=avail[k], chain=list(chain)))
                    per_dn[dn] = k + 1
            launched = len(jobs)

            with spans.span("resolve"):
                res = self.recovery.resolve(jobs, chains, crash_times, horizon,
                                            adv=adv, timeline=self.timeline,
                                            iteration=it)
            self.last_chains = chains
            self.last_resolution = res

            # corrupt-gradient injection: per completed job, the stages
            # whose relay the adversarial plan corrupts (on the job's
            # *final* chain, after any reroutes)
            corrupt = adv.corrupt if adv is not None else {}
            corrupt_stages: Dict[int, Dict[int, Tuple]] = {}
            if corrupt:
                S = self.net.num_stages
                for job in res.completed:
                    hit = {s: corrupt[job.chain[s + 1]] + (job.chain[s + 1],)
                           for s in range(S) if job.chain[s + 1] in corrupt}
                    if hit:
                        corrupt_stages[job.index] = hit
            self._corrupt_stages = corrupt_stages
            self._screen = (self.grad_screen if self.grad_screen is not None
                            else bool(corrupt))
            self._grads_flagged = 0
            self._syncs = HostSyncs()

            with spans.span("execute"):
                wire = self._make_wire(chains)
                self.last_wire_codecs = (list(wire.names) if wire is not None
                                         else [])
                mean_loss = self._execute(res, wire)
                self.last_wire_bytes = wire.bytes if wire is not None else 0

            with spans.span("commit"):
                # ---- commit crashes for the next iteration -----------
                for nid in crash_times:
                    self.net.kill_node(nid)
                    self.policy.on_crash(nid)

                # ---- reputation: decay first (rehabilitation), then charge
                # this iteration's detections (fresh faults carry the full
                # quarantine penalty into the next plan).  Same ordering as
                # the sim engine; both no-op bit-identically on clean runs.
                if res.rep_reports or self.net.reputation_active():
                    self.net.decay_reputations()
                    for r_nid in res.rep_reports:
                        self.net.report_fault(r_nid)

                self.step += 1
                if (self.checkpoint_dir and self.checkpoint_every
                        and self.step % self.checkpoint_every == 0):
                    self.save_checkpoint()

            self.losses.append(mean_loss)
            return IterationResult(
                loss=mean_loss, completed=len(res.completed),
                launched=launched,
                dropped=res.dropped, rerouted=res.rerouted,
                requeued=res.requeued, fwd_recomputes=res.fwd_recomputes,
                bwd_replays=res.bwd_replays,
                store_peak_bytes=self.last_store_peak_bytes,
                wire_bytes=self.last_wire_bytes,
                wire_codecs=tuple(self.last_wire_codecs),
                deadline_requeues=res.deadline_requeues,
                grads_flagged=self._grads_flagged,
                host_syncs=self._syncs.n)

    # ------------------------------------------------------------------
    # Numeric pass
    # ------------------------------------------------------------------
    def _execute(self, res: Resolution,
                 wire: Optional[_WireLink] = None) -> float:
        """Run the completed microbatches through the staged compute and
        apply the aggregated update; dispatch each recorded crash's
        lost work so recovery cost is real."""
        done = res.completed
        self.store.clear()
        self.store.reset_peak()
        self.last_store_peak_bytes = 0
        if not done:
            return 0.0
        self.last_microbatch_grads = []
        # corrupt gradients (or an explicitly requested screen) force
        # the per-microbatch path: the perturbation is per-job and the
        # screen needs per-job contributions before aggregation
        adversarial = (bool(getattr(self, "_corrupt_stages", None))
                       or getattr(self, "_screen", False))
        if self.batch_microbatches and not adversarial:
            total = self._execute_batched(done, res, wire)
        else:
            total = self._execute_per_microbatch(done, res, wire)
        self.last_store_peak_bytes = self.store.peak_bytes
        self.store.clear()
        return total / len(done)

    def _group_by_dn(self, done: List[Job]) -> Dict[int, List[int]]:
        by_dn: Dict[int, List[int]] = {}
        for k, job in enumerate(done):
            by_dn.setdefault(job.data_node, []).append(k)
        return by_dn

    def _execute_batched(self, done: List[Job], res: Resolution,
                         wire: Optional[_WireLink] = None) -> float:
        by_dn = self._group_by_dn(done)
        per = np.asarray(done[0].mb["tokens"]).shape[0]
        seq = np.asarray(done[0].mb["tokens"]).shape[1]
        S = self.net.num_stages
        total = 0.0
        grad_stage: List[Any] = [None] * S
        g_head_by_dn: Dict[int, Any] = {}

        def replay(s, direction, ids, cotangent=None, p=0):
            self.recovery.replay_lost(
                self.stages, self.store, self.stage_params, res,
                s, direction, ids=ids, cotangent=cotangent, per=p,
                remat=self.remat)

        for dn, idxs in by_dn.items():
            C = _chunk_size(self.cfg, self.dispatch_chunk, len(idxs), per,
                            seq)
            head_p = self.head_params[dn]
            g_head = None
            for lo in range(0, len(idxs), C):
                jobs = [done[k] for k in idxs[lo:lo + C]]
                ids = tuple(j.index for j in jobs)
                with spans.span("chunk"):
                    toks, labels = _batch([j.mb for j in jobs], self.device,
                                          self._syncs)
                    loss_sum, gh = _chunk_pass(
                        self.stages, self.store, self.stage_params, head_p,
                        toks, labels, ids, per, remat=self.remat,
                        grad_stage=grad_stage, syncs=self._syncs,
                        replay=replay, wire=wire)
                total += loss_sum
                g_head = (gh if g_head is None else
                          tree_map(torch.add, g_head, gh))
            g_head_by_dn[dn] = (g_head, len(idxs))
        self._apply_update(grad_stage, g_head_by_dn, len(done))
        return total

    # -- corrupt-gradient adversary + screen ---------------------------
    def _perturb_tree(self, tree, mode: str, scale: float, seed: int,
                      job: int, stage: int):
        """Apply one corrupt node's backward perturbation to a gradient
        tree.  Deterministic: the noise stream is keyed on
        (seed, iteration, job, stage), so seeded adversarial runs
        reproduce bit-for-bit."""
        if mode == "sign_flip":
            return tree_map(torch.neg, tree)
        if mode == "zero":
            return tree_map(torch.zeros_like, tree)
        rng = np.random.default_rng([seed, self.step, job, stage])
        self._syncs.n += len(leaves(tree))
        return tree_map(
            lambda a: a + scale * torch.from_numpy(
                rng.standard_normal(a.shape)).to(a.device, a.dtype), tree)

    @staticmethod
    def _flatten_grads(tree) -> np.ndarray:
        flat = [x.detach().double().cpu().numpy().ravel()
                for x in leaves(tree)]
        return (np.concatenate(flat) if flat
                else np.zeros(1, dtype=np.float64))

    def _screen_contribs(self, contribs) -> set:
        """The cheap gradient screen: flag per-microbatch contributions
        whose per-stage gradient is a norm outlier (>8x or <1/8 the
        median) or anti-correlated with the other contributions at the
        same stage (cosine < -0.1 vs the leave-one-out mean).  A
        sign-flipped backward is ~-1 cosine at (and below) the corrupt
        stage; a zeroed one fails the norm floor; large perturbations
        fail the norm ceiling.  Returns flagged indices into
        ``contribs``.

        The reference norm is the *lower* median (element ``(k-1)//2``
        of the sorted norms), not the interpolated one: with exactly
        half the contributions inflated, the interpolated median
        averages an honest and a poisoned norm and both tests go
        blind, while the lower median stays an honest value for any
        contamination strictly below half."""
        S = self.net.num_stages
        k = len(contribs)
        flagged: set = set()
        for s in range(S):
            vecs = [self._flatten_grads(gs[s]) for _, _, gs in contribs]
            self._syncs.n += sum(len(leaves(gs[s])) for _, _, gs in contribs)
            norms = np.array([float(np.linalg.norm(v)) for v in vecs])
            med = float(np.sort(norms)[(k - 1) // 2])
            if med > 0.0:
                for i in range(k):
                    if norms[i] > 8.0 * med or norms[i] < med / 8.0:
                        flagged.add(i)
            if k >= 3:
                total = np.sum(vecs, axis=0)
                for i in range(k):
                    others = total - vecs[i]
                    no = float(np.linalg.norm(others))
                    if norms[i] > 0.0 and no > 0.0:
                        cos = float(np.dot(vecs[i], others)
                                    / (norms[i] * no))
                        if cos < -0.1:
                            flagged.add(i)
        return flagged

    def _execute_per_microbatch(self, done: List[Job], res: Resolution,
                                wire: Optional[_WireLink] = None) -> float:
        """Unbatched path: every microbatch runs its own per-stage
        dispatches and gradients are accumulated with ``torch.add`` —
        the dispatch order (and float association) of the centralized
        baseline, used by the numerical-equivalence tests.

        When the churn model injects corrupt gradients this path also
        hosts the adversary and its defense: each corrupt relay on a
        job's final chain perturbs that stage's backward outputs
        (``dp``/``dx`` — the poison propagates to earlier stages
        through the cotangent, as it would in a real pipeline), and the
        gradient screen then excludes flagged contributions *before*
        the AdamW aggregation (``grads_flagged``; flagged jobs still
        count as completed — delivery succeeded, trust didn't)."""
        S = self.net.num_stages
        corrupt_stages = getattr(self, "_corrupt_stages", None) or {}
        screening = getattr(self, "_screen", False)
        collect = bool(corrupt_stages) or screening
        contribs: List[Tuple[Job, Any, List[Any]]] = []
        total = 0.0
        grad_stage: List[Any] = [None] * S
        g_head_by_dn: Dict[int, Any] = {}
        # crash events per (job, stage, direction): each costs one real
        # lost-work dispatch, issued inline where the inputs are in hand
        lost: Dict[Tuple[int, int, str], int] = {}
        for ev in res.events:
            key = (ev.job, ev.stage, ev.direction)
            lost[key] = lost.get(key, 0) + 1
        for job in done:
            with spans.span("chunk"):
                toks, labels = _batch([job.mb], self.device, self._syncs)
                ids = (job.index,)
                with spans.span("embed"):
                    x = self.stages.embed(self.head_params[job.data_node],
                                          toks)
                for s in range(S):
                    self.store.put(s, ids, x)
                    for _ in range(lost.get((job.index, s, "fwd"), 0)):
                        with spans.span("replay", stage=s, direction="fwd"):
                            self.stages.forward(s, self.stage_params[s], x)
                    with spans.span("stage.fwd", stage=s):
                        if self.remat:
                            x = self.stages.forward(s, self.stage_params[s],
                                                    x)
                        else:
                            x, resid = self.stages.forward_fused(
                                s, self.stage_params[s], x)
                            self.store.put_residuals(s, ids, resid)
                    if wire is not None and s < S - 1:
                        x = wire.send(s, x)
                with spans.span("head_loss"):
                    losses, g_head, g_hidden = self.stages.head_loss(
                        self.head_params[job.data_node], x[None], labels)
                with spans.span("loss_sync"):
                    total += float(losses[0])
                self._syncs.n += 1
                g = g_hidden[0]
                g_stages: List[Any] = [None] * S
                for s in reversed(range(S)):
                    for _ in range(lost.get((job.index, s, "bwd"), 0)):
                        # a replay leaves g as it was: the real dispatch
                        # below uses the same one
                        with spans.span("replay", stage=s, direction="bwd"):
                            if (not self.remat
                                    and self.store.has_residuals(s, ids)):
                                self.stages.backward_from_residuals(
                                    s, self.store.residuals(s, ids), g)
                            else:
                                self.stages.backward(
                                    s, self.stage_params[s],
                                    self.store.get(s, job.index), g)
                    with spans.span("stage.bwd", stage=s):
                        if self.remat:
                            dp, dx = self.stages.backward(
                                s, self.stage_params[s],
                                self.store.get(s, job.index), g)
                        else:
                            dp, dx = self.stages.backward_from_residuals(
                                s, self.store.residuals(s, ids), g)
                        hit = corrupt_stages.get(job.index)
                        if hit is not None and s in hit:
                            # the corrupt relay at this stage perturbs the
                            # backward results it computed; the poisoned
                            # cotangent dx flows into every earlier stage
                            mode, scale, c_seed, _nid = hit[s]
                            dp = self._perturb_tree(dp, mode, scale, c_seed,
                                                    job.index, s)
                            dx = self._perturb_tree(dx, mode, scale, c_seed,
                                                    job.index, s)
                    g_stages[s] = dp
                    g = dx
                    self.store.drop(s, ids)
                with spans.span("embed.bwd"):
                    g_emb = self.stages.embed_backward(
                        self.head_params[job.data_node], toks, g)
                g_head = tree_map(torch.add, g_head, g_emb)
            if self.record_microbatch_grads:
                self.last_microbatch_grads.append(
                    (job.index, g_head, list(g_stages)))
            if collect:
                # defer aggregation until the screen has seen every
                # contribution (same torch.add chain in the same job
                # order afterwards, so an empty flag set aggregates
                # bit-identically to the inline path)
                contribs.append((job, g_head, g_stages))
                continue
            for s in range(S):
                grad_stage[s] = (g_stages[s] if grad_stage[s] is None else
                                 tree_map(torch.add, grad_stage[s],
                                          g_stages[s]))
            dn = job.data_node
            if dn in g_head_by_dn:
                acc, n = g_head_by_dn[dn]
                g_head_by_dn[dn] = (tree_map(torch.add, acc, g_head), n + 1)
            else:
                g_head_by_dn[dn] = (g_head, 1)
        if collect:
            flagged = self._screen_contribs(contribs) if screening else set()
            self._grads_flagged = len(flagged)
            for i in sorted(flagged):
                f_job = contribs[i][0]
                hit = corrupt_stages.get(f_job.index)
                if not hit:
                    continue   # false positive: excluded, but nobody
                    # is accused (no timeline record, no rep report)
                for s in sorted(hit):
                    c_nid = hit[s][3]
                    self.timeline.record(self.step, "corrupt_gradient",
                                         "detection", c_nid)
                    self.timeline.record(self.step, "corrupt_gradient",
                                         "repair", c_nid)
                    res.rep_reports.append(c_nid)
            kept = [i for i in range(len(contribs)) if i not in flagged]
            for i in kept:
                k_job, g_head, g_stages = contribs[i]
                for s in range(S):
                    grad_stage[s] = (
                        g_stages[s] if grad_stage[s] is None else
                        tree_map(torch.add, grad_stage[s], g_stages[s]))
                dn = k_job.data_node
                if dn in g_head_by_dn:
                    acc, n = g_head_by_dn[dn]
                    g_head_by_dn[dn] = (
                        tree_map(torch.add, acc, g_head), n + 1)
                else:
                    g_head_by_dn[dn] = (g_head, 1)
            if kept:
                self._apply_update(grad_stage, g_head_by_dn, len(kept))
            return total
        self._apply_update(grad_stage, g_head_by_dn, len(done))
        return total

    def _apply_update(self, grad_stage, g_head_by_dn, n_completed: int):
        with spans.span("update"):
            for s in range(self.net.num_stages):
                if grad_stage[s] is None:
                    continue
                self.stage_params[s], self.stage_opt[s] = self._upd(
                    grad_stage[s], self.stage_opt[s], self.stage_params[s],
                    divisor=n_completed)
            for dn, (gh, n) in g_head_by_dn.items():
                if gh is None:
                    continue
                self.head_params[dn], self.head_opt[dn] = self._upd(
                    gh, self.head_opt[dn], self.head_params[dn], divisor=n)


class CentralizedTrainer:
    """Baseline: same model, same data, no decentralization (Fig. 6).

    Runs the *same* chunked pass (`_chunk_pass`) over the same
    `StageCompute` primitives and the same AdamW update as
    the decentralized runtime, in the same dispatch order.  At churn 0
    the decentralized trainer therefore executes bit-for-bit the
    identical float program — which is the paper's convergence claim
    stated as an executable invariant (the pre-refactor whole-model-jit
    formulation could only guarantee this by being one monolithic
    program; the staged formulation preserves it by construction).
    """

    def __init__(self, cfg, num_stages: int, *, lr: float = 1e-3,
                 seed: int = 0, remat: bool = False,
                 activation_codec: str = "fp",
                 wire_codec: Optional[str] = None,
                 dispatch_chunk: Optional[int] = None,
                 device="cuda"):
        self.cfg = cfg
        self.num_stages = num_stages
        self.device = resolve_device(device)
        self.remat = remat
        # fixed per-boundary wire codec (no planner here); None/fp32
        # keeps the exact program the bit-identity invariant pins
        self.wire_codec = (None if wire_codec in (None, "fp", "fp32")
                           else wire_codec)
        self.dispatch_chunk = dispatch_chunk
        stage_p, head_p = cache.initial_params(cfg, num_stages, seed,
                                               self.device)
        self.stage_params = list(stage_p)
        self.head_params = head_p
        self.opt = AdamW(lr=lr)
        self.stage_opt = [self.opt.init(p) for p in self.stage_params]
        self.head_opt = self.opt.init(self.head_params)
        self.stages = StageCompute(cfg, num_stages)
        self.store = ActivationStore(codec=activation_codec)
        self._upd = self.opt.update
        self.losses: List[float] = []
        self.last_store_peak_bytes = 0
        self.last_wire_bytes = 0

    def iteration(self, microbatches: List[dict]) -> float:
        S = self.num_stages
        B = len(microbatches)
        per = np.asarray(microbatches[0]["tokens"]).shape[0]
        seq = np.asarray(microbatches[0]["tokens"]).shape[1]
        self.store.clear()
        self.store.reset_peak()
        wire = (_WireLink([self.wire_codec] * (S - 1))
                if self.wire_codec and S > 1 else None)
        total = 0.0
        grad_stage: List[Any] = [None] * S
        g_head = None
        C = _chunk_size(self.cfg, self.dispatch_chunk, B, per, seq)
        syncs = HostSyncs()
        for lo in range(0, B, C):
            part = microbatches[lo:lo + C]
            ids = tuple(range(lo, lo + len(part)))
            toks, labels = _batch(part, self.device, syncs)
            loss_sum, gh = _chunk_pass(
                self.stages, self.store, self.stage_params,
                self.head_params, toks, labels, ids, per,
                remat=self.remat, grad_stage=grad_stage, syncs=syncs,
                wire=wire)
            total += loss_sum
            g_head = gh if g_head is None else tree_map(torch.add, g_head, gh)
        for s in range(S):
            self.stage_params[s], self.stage_opt[s] = self._upd(
                grad_stage[s], self.stage_opt[s], self.stage_params[s],
                divisor=B)
        self.head_params, self.head_opt = self._upd(
            g_head, self.head_opt, self.head_params, divisor=B)
        self.last_store_peak_bytes = self.store.peak_bytes
        self.last_wire_bytes = wire.bytes if wire is not None else 0
        mean = float(total) / B
        self.losses.append(mean)
        return mean
