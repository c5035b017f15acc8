"""ServeTrainer: real-compute decode executor over the flow engine's chains.

Port of ``repro.core.runtime.serving`` for the dense, SSM and hybrid
models.  The trainer embeds its own ``ServingEngine`` (the port's copy of
``repro.core.sim.engine``), advances it one iteration at a time, and
executes the schedule it emits with real prefill and decode compute:
batched prefills for admission cohorts, stacked ``decode_step``
dispatches for sequences at the same token index on the same chain, and
teacher-forced cache replay for requeued sequences.  Scheduling metrics
pass through from the engine unchanged, so the schedule equals the JAX
package's exactly; the executor adds no timing of its own.

Caches are the port's dict trees (every leaf ``(L, B, ...)``), f32 as in
the JAX package.  ``prefill`` and ``decode_step`` write the cache they
are given in place, where JAX returns a new one, so a cohort's dispatch
always runs on a fresh ``torch.cat`` of its rows' caches: a row that
``_split`` returns is a view of the cohort's tensor, and no other
sequence's dispatch ever writes it.  Stacking and splitting run under
``torch.inference_mode``, as the model's entry points do.

The JAX package calls stacked decode bit-identical to decoding each row
alone, and the replayed cache bit-identical to the incremental one.  In
the port (and, on the CPU, in JAX too) both hold to a float tolerance,
not bit for bit: a GEMM's blocking depends on its row count.  Greedy
streams and schedules are what the tests hold exactly.

Seeding: ``serving_inputs`` draws the model and the prompts from one seed
through ``torch.Generator``s, which cannot reproduce the JAX keys; tests
set ``params`` and ``_prompts`` from the JAX trainer's to compare the two.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.flow.graph import FlowNetwork
from repro_torch.core.sim.engine import ServingEngine
from repro_torch.core.sim.faults import ChurnModel
from repro_torch.core.sim.metrics import ModelProfile, ServingIterationMetrics
from repro_torch.core.sim.policies import RoutingPolicy
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Transformer, decode_step,
                                            init_cache, init_params, prefill)
from repro_torch.tree import flatten, unflatten


def _generators(seed: int, device):
    """Independent generators for params, prompt and sampling, on
    ``device``, from one seed (``torch.Generator`` cannot reproduce the
    JAX keys; tests hand both packages the same numpy inputs instead)."""
    states = np.random.SeedSequence(seed).generate_state(3, dtype=np.uint64)
    return tuple(torch.Generator(device=device).manual_seed(int(s))
                 for s in states)


def serving_inputs(cfg: ModelConfig, *, seed: int, batch: int,
                   prompt_len: int, device="cuda"):
    """Seeded ``(model, prompt, sample_generator)`` setup on ``device``."""
    dev = resolve_device(device)
    g_params, g_prompt, g_sample = _generators(seed, dev)
    model: Transformer = init_params(cfg, g_params, dev)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=g_prompt, device=dev)
    return model, prompt, g_sample


class _Seq:
    """One request's executor-side decode state."""

    __slots__ = ("rid", "chain", "stream", "cache", "live")

    def __init__(self, rid: int):
        self.rid = rid
        self.chain: Optional[Tuple[int, ...]] = None
        self.stream: List[int] = []        # greedy tokens generated so far
        self.cache: Any = None             # batch-1 KV cache tree
        self.live = False                  # cache currently valid


class ServeTrainer:
    """Staged decode executor driven by an embedded ``ServingEngine``.

    Each ``iteration()`` first advances the engine (churn sample, chain
    plan, analytic request schedule), then executes the schedule with
    real compute on ``device``.  Token streams land in
    ``token_stream(rid)``; the counters ``prefill_calls``,
    ``decode_dispatches``, ``stacked_rows`` and ``replay_steps`` count
    the dispatches.

    ``params`` (a ``Transformer``) and ``_prompts`` (``(max_requests,
    prompt_len)`` tokens) come from ``serving_inputs``.  A request id at
    or beyond ``max_requests`` draws its prompt row from
    ``np.random.SeedSequence([seed, rid])``: the JAX package folds the id
    into its prompt key, which torch cannot reproduce, so such rows differ
    between the packages.
    """

    def __init__(self, cfg, net: FlowNetwork, *,
                 policy: RoutingPolicy,
                 arrival_program: List[List[float]],
                 churn_model: Optional[ChurnModel] = None,
                 profile: Optional[ModelProfile] = None,
                 prompt_len: int = 8, gen_tokens: int = 8,
                 serve_batch: int = 4, tokens_per_mb: int = 128,
                 timeout: float = 5.0, reroute: bool = True,
                 max_restarts: int = 5,
                 rng: Optional[np.random.Generator] = None,
                 seed: int = 0, max_requests: int = 64, device="cuda"):
        self.cfg = cfg
        self.net = net
        self.device = resolve_device(device)
        self.engine = ServingEngine(
            net, policy, arrival_program=arrival_program,
            churn_model=churn_model, profile=profile,
            prompt_len=prompt_len, gen_tokens=gen_tokens,
            serve_batch=serve_batch, tokens_per_mb=tokens_per_mb,
            timeout=timeout, reroute=reroute, max_restarts=max_restarts,
            rng=rng)
        self.timeline = self.engine.timeline
        self.prompt_len = int(prompt_len)
        self.gen_tokens = int(gen_tokens)
        self.cache_len = self.prompt_len + self.gen_tokens
        self.seed = int(seed)
        self.max_requests = int(max_requests)
        self.params, self._prompts, _ = serving_inputs(
            cfg, seed=seed, batch=max_requests, prompt_len=prompt_len,
            device=self.device)
        self._seqs: Dict[int, _Seq] = {}
        self._cache_axes = None            # per-leaf batch axis, lazy
        # dispatch accounting (the batching tests' ground truth)
        self.prefill_calls = 0
        self.decode_dispatches = 0
        self.stacked_rows = 0
        self.replay_steps = 0              # teacher-forced cache rebuilds

    # ------------------------------------------------------------------
    def _prompt_row(self, rid: int) -> torch.Tensor:
        """Prompt tokens for request ``rid``: a row of the shared seeded
        batch, or, beyond it, a row drawn from ``(seed, rid)``."""
        if rid < self.max_requests:
            return self._prompts[rid:rid + 1]
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, rid]))
        row = rng.integers(0, self.cfg.vocab_size, (1, self.prompt_len))
        return torch.from_numpy(row).to(self.device)

    def _seq(self, rid: int) -> _Seq:
        s = self._seqs.get(rid)
        if s is None:
            s = self._seqs[rid] = _Seq(rid)
        return s

    def _axes(self) -> List[int]:
        if self._cache_axes is None:
            self._cache_axes = _batch_axes(self.cfg, self.cache_len)
        return self._cache_axes

    def _stack(self, rows: List[Any]):
        """Stack batch-1 cache trees along each leaf's batch axis, into
        fresh tensors (the dispatch then writes them in place)."""
        flat = [flatten(r) for r in rows]
        spec = flat[0][1]
        leaves = [torch.cat([f[0][i] for f in flat], dim=ax)
                  for i, ax in enumerate(self._axes())]
        return unflatten(spec, leaves)

    def _split(self, cache: Any, batch: int) -> List[Any]:
        """Split a batch-B cache tree back into B batch-1 rows (views)."""
        leaves, spec = flatten(cache)
        return [unflatten(spec, [x.narrow(ax, b, 1)
                                 for x, ax in zip(leaves, self._axes())])
                for b in range(batch)]

    # -- stacked primitives ---------------------------------------------
    @torch.inference_mode()
    def _prefill_cohort(self, seqs: List[_Seq]):
        """One stacked prefill dispatch for an admission cohort."""
        B = len(seqs)
        tokens = torch.cat([self._prompt_row(s.rid) for s in seqs], dim=0)
        cache = init_cache(self.cfg, B, self.cache_len, dtype=torch.float32,
                           device=self.device)
        logits, cache = prefill(self.params, self.cfg, tokens=tokens,
                                cache=cache)
        self.prefill_calls += 1
        first = logits.argmax(-1).tolist()
        rows = self._split(cache, B)
        for b, s in enumerate(seqs):
            s.cache = rows[b]
            s.live = True
            s.stream = [first[b]]

    @torch.inference_mode()
    def _decode_cohort(self, seqs: List[_Seq], index: int):
        """ONE stacked ``decode_step`` dispatch: every sequence in the
        cohort sits at the same token index."""
        B = len(seqs)
        tok = torch.tensor([[s.stream[-1]] for s in seqs], dtype=torch.long,
                           device=self.device)
        cache = self._stack([s.cache for s in seqs])
        logits, cache = decode_step(self.params, self.cfg, tokens=tok,
                                    cache=cache, index=index)
        self.decode_dispatches += 1
        self.stacked_rows += B
        nxt = logits.argmax(-1).tolist()
        rows = self._split(cache, B)
        for b, s in enumerate(seqs):
            s.cache = rows[b]
            s.stream.append(nxt[b])

    @torch.inference_mode()
    def _replay_cache(self, s: _Seq):
        """Rebuild a migrated or evicted sequence's KV cache: prefill the
        prompt, then teacher-force the generated tokens through the same
        ``decode_step`` calls the original run made."""
        cache = init_cache(self.cfg, 1, self.cache_len, dtype=torch.float32,
                           device=self.device)
        _, cache = prefill(self.params, self.cfg,
                           tokens=self._prompt_row(s.rid), cache=cache)
        self.prefill_calls += 1
        for j in range(len(s.stream) - 1):
            tok = torch.tensor([[s.stream[j]]], dtype=torch.long,
                               device=self.device)
            _, cache = decode_step(self.params, self.cfg, tokens=tok,
                                   cache=cache, index=self.prompt_len + j)
            self.replay_steps += 1
        s.cache = cache
        s.live = True

    # ------------------------------------------------------------------
    def _advance(self, targets: Dict[int, int]):
        """Decode every sequence up to its target token count with
        same-index same-chain cohorts stacked into single dispatches."""
        pending = {rid: tgt for rid, tgt in targets.items()
                   if tgt > len(self._seq(rid).stream)}
        # admissions first: fresh sequences need their prefill token
        fresh: Dict[Tuple[int, ...], List[_Seq]] = {}
        for rid in sorted(pending):
            s = self._seq(rid)
            if not s.stream and not s.live:
                fresh.setdefault(s.chain or (), []).append(s)
        for cohort in fresh.values():
            self._prefill_cohort(cohort)
        # then decode rounds: group by (chain, current index)
        while True:
            groups: Dict[Tuple[Tuple[int, ...], int], List[_Seq]] = {}
            for rid, tgt in sorted(pending.items()):
                s = self._seq(rid)
                if len(s.stream) >= tgt:
                    continue
                if not s.live:
                    self._replay_cache(s)
                idx = self.prompt_len + len(s.stream) - 1
                groups.setdefault((s.chain or (), idx), []).append(s)
            if not groups:
                break
            for (_, idx), cohort in groups.items():
                self._decode_cohort(cohort, idx)

    # ------------------------------------------------------------------
    def iteration(self) -> ServingIterationMetrics:
        """Advance the engine one iteration, then execute its schedule
        with real compute."""
        m = self.engine.run_iteration()
        trace = self.engine.traces[-1]
        # process schedule incidents in chronological order: requeues
        # need the victim advanced to its crash-time token count before
        # the migration replays its cache on the new chain
        for op in trace:
            kind = op[0]
            if kind == "start":
                _, _, rid, chain, pre = op
                s = self._seq(rid)
                s.chain = chain
                if pre == 0 and s.stream and not s.live:
                    s.stream = []          # drop-and-retry restart landed
                if pre > 0:
                    self._advance({rid: pre})
                    s.live = False         # queued eviction lost the KV
            elif kind == "requeue":
                _, _, rid, _old, new, k = op
                s = self._seq(rid)
                if k > 0:
                    self._advance({rid: k})
                else:
                    s.stream = []
                s.chain = new
                s.live = False             # migration re-materializes it
            elif kind == "requeue_wait":
                _, _, rid, k = op
                s = self._seq(rid)
                if k > 0:
                    self._advance({rid: k})
                else:
                    s.stream = []
                s.chain = None
                s.live = False
            elif kind == "restart":
                s = self._seq(op[2])
                s.stream = []
                s.cache = None
                s.live = False
                s.chain = None
        # advance everything to the engine's end-of-iteration census
        targets: Dict[int, int] = {}
        for rid, rec in self.engine.requests.items():
            if rec.dropped:
                continue
            tgt = self.engine.tokens_now(rid)
            if tgt:
                targets[rid] = tgt
        self._advance(targets)
        # completed sequences release their executor cache
        for rid, rec in self.engine.requests.items():
            if rec.completion is not None:
                s = self._seqs.get(rid)
                if s is not None and s.cache is not None:
                    s.cache = None
                    s.live = False
        return m

    def run(self, iterations: int) -> List[ServingIterationMetrics]:
        return [self.iteration() for _ in range(iterations)]

    # ------------------------------------------------------------------
    def token_stream(self, rid: int) -> List[int]:
        """Greedy token stream decoded so far for request ``rid``."""
        s = self._seqs.get(rid)
        return list(s.stream) if s is not None else []


def _batch_axes(cfg, cache_len: int) -> List[int]:
    """Per-leaf batch-axis index of the decode cache tree.

    The batch axis is *detected*, as in the JAX package: allocate a
    batch-1 and a batch-2 cache (on the meta device: shapes only) and find
    the one axis where each leaf's shape differs.
    """
    l1, _ = flatten(init_cache(cfg, 1, cache_len, dtype=torch.float32,
                               device="meta"))
    l2, _ = flatten(init_cache(cfg, 2, cache_len, dtype=torch.float32,
                               device="meta"))
    axes = []
    for a, b in zip(l1, l2):
        diff = [i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                if x != y]
        if len(diff) != 1:  # pragma: no cover - cache layout invariant
            raise ValueError(f"ambiguous cache batch axis: "
                             f"{tuple(a.shape)} vs {tuple(b.shape)}")
        axes.append(diff[0])
    return axes
