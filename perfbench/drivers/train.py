"""Staged GWTF training: ``launch/train.py``'s ``build_gwtf`` and
``train_iteration``, that is ``RuntimeTrainer.iteration``, under a churn
trace drawn ahead of time.

Set-up builds the trainer (its constructor still draws the initial weights
on the CPU), writes the benchmark's own weights into ``stage_params`` and
``head_params``, puts the swarm in the trace's starting state, and drives
the trainer through its first ``warmup_iterations`` iterations: those warm
every shape up and are the steps the reference follows.  Under churn the
warm-up goes on, to ``warmup_max_iterations`` at most, until one of its
iterations has replayed work lost to a crash (a forward recompute or a
backward replay), so that the comparison covers the recovery path; the
replays of each compared iteration are printed with the checks.  The window then
runs whole iterations until ``--seconds`` have passed.  Every iteration's
microbatches are fresh random tokens drawn from (seed, iteration).

The comparison (``check``), after the window and with the trainer freed:
the plain reference (``reference/gwtf.py``) replays the warm-up
iterations on the microbatches that the routing completed.  Each number
that the cell's ``limits`` name is compared, each the worst of:

* ``loss_gap``: |loss - reference| / |reference| over the warm-up
  iterations that completed a microbatch;
* ``grad_gap``: over every leaf, the gap between the norms of the first
  gradient that AdamW got (the program's, worked out from its first moment
  after its first step, m / (1 - b1)) and the reference's, over the larger
  of that leaf's reference norm and the median leaf's;
* ``change_gap``: the same of the leaves' change over the warm-up
  iterations, leaving out each leaf whose reference first gradient is under
  a thousandth of the median leaf's (a key's bias under softmax: only
  rounding moves it).
"""
from __future__ import annotations

import math
import statistics
import sys
import time
import traceback
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from perfbench import churn, harness, profiling, weights
from perfbench.reference import dense, gwtf


class Shard:
    """One data node's microbatches of an iteration, as ``train_iteration``
    reads a data shard."""

    def __init__(self, mbs: List[dict], batch: int, seq_len: int):
        self.mbs = mbs
        self.cfg = SimpleNamespace(microbatch_size=batch, seq_len=seq_len)

    def microbatches(self) -> List[dict]:
        return self.mbs


class Feed:
    """Each iteration's microbatches: ``microbatches`` of ``batch`` rows of
    ``seq_len`` tokens for each data node, uniform over the vocabulary, the
    labels the next tokens, drawn from (seed, iteration)."""

    def __init__(self, seed: int, vocab: int, data_nodes: List[int], w: dict):
        self.seed, self.vocab, self.dns = seed % (1 << 64), vocab, data_nodes
        self.n, self.batch, self.seq = w["microbatches"], w["batch"], w["seq_len"]

    def __call__(self, it: int) -> Dict[int, Shard]:
        rng = np.random.default_rng([self.seed, it])
        x = rng.integers(0, self.vocab, size=(len(self.dns), self.n, self.batch, self.seq + 1))
        return {dn: Shard([{"tokens": mb[:, :-1], "labels": mb[:, 1:]} for mb in x[d]],
                          self.batch, self.seq)
                for d, dn in enumerate(self.dns)}


def _wrap(obj, name: str, spans: Dict[str, List[float]], sync: bool):
    """Time ``obj.name`` on the instance into ``spans[name]`` (the device
    synchronized on both sides when ``sync``), as a profiler range too."""
    fn = getattr(obj, name)
    spans.setdefault(name, [])

    def timed(*a, **k):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"perfbench/{name}"):
            out = fn(*a, **k)
        if sync:
            torch.cuda.synchronize()
        spans[name].append(time.perf_counter() - t0)
        return out
    setattr(obj, name, timed)


def _opt_trees(trainer):
    """(tree name, params, AdamW state) of every tree the trainer updates."""
    out = [(f"stage{s}", p, o) for s, (p, o) in
           enumerate(zip(trainer.stage_params, trainer.stage_opt))]
    return out + [(f"head{dn}", trainer.head_params[dn], trainer.head_opt[dn])
                  for dn in sorted(trainer.head_params)]


def _initial_key(key: str) -> str:
    """A leaf's weight key: data nodes' heads all start from ``head/...``."""
    tree, rest = key.split("/", 1)
    return f"head/{rest}" if tree.startswith("head") else key


def build(cell, run):
    """The trainer, as ``launch/train.py --mode gwtf`` builds it, with the
    benchmark's weights and churn trace; returns (trainer, feed)."""
    from repro_torch.core.runtime import cache
    from repro_torch.core.sim.faults import TraceChurn
    from repro_torch.launch import train as T
    w, cfg = cell.workload, harness.model_config(cell.config)
    args = T.parser().parse_args([
        "--mode", "gwtf", "--stages", str(w["stages"]),
        "--relays-per-stage", str(w["relays_per_stage"]), "--capacity", str(w["capacity"]),
        "--data-nodes", str(w["data_nodes"]), "--microbatches", str(w["microbatches"]),
        "--batch", str(w["batch"]), "--seq-len", str(w["seq_len"]), "--lr", str(w["adamw"]["lr"]),
        "--churn", str(w["churn"]), "--seed", str(run.seed), "--device", run.device])
    trainer, _ = T.build_gwtf(args, cfg)
    S = len(trainer.stage_params)
    trainer.stage_params = [weights.like(trainer.stage_params[s], f"stage{s}", run.seed)
                            for s in range(S)]
    head = weights.like(next(iter(trainer.head_params.values())), "head", run.seed)
    trainer.head_params = {dn: head for dn in trainer.head_params}
    cache.clear()
    net = trainer.net
    relays = [sorted(n.id for n in net.nodes.values() if not n.is_data and n.stage == s)
              for s in range(S)]
    dead, events = churn.stationary_trace(relays, w["churn"], w["trace_iterations"],
                                          w["trace_seed"], run.seed)
    for nid in dead:
        net.kill_node(nid)
        trainer.policy.on_crash(nid)
    trainer.churn_model = TraceChurn(events, known_ids=net.nodes.keys())
    feed = Feed(run.seed, cfg.vocab_size, sorted(trainer.head_params), w)
    return trainer, feed


def warm_up(cell, run, trainer, feed):
    """The first iterations, recorded for the reference: each one's loss,
    the first gradient of each tree as AdamW got it, the leaves' change
    over them, and the microbatches the routing completed."""
    from repro_torch.launch import train as T
    b1 = cell.workload["adamw"]["b1"]
    done: List[list] = []
    resolve = trainer.recovery.resolve

    def recording(*a, **k):
        res = resolve(*a, **k)
        done.append(list(res.completed))
        return res
    trainer.recovery.resolve = recording
    w = cell.workload
    losses, first, replays = [], {}, []
    while len(replays) < w["warmup_iterations"] or (
            w["churn"] > 0 and not any(replays) and len(replays) < w["warmup_max_iterations"]):
        shards = feed(len(replays))
        r, _, _ = T.train_iteration(trainer, shards)
        replays.append(r.fwd_recomputes + r.bwd_replays)
        where = {id(mb): (dn, mb) for dn, s in shards.items() for mb in s.mbs}
        done[-1] = [where[id(job.mb)] for job in done[-1]]
        losses.append(r.loss if r.completed else None)
        for name, _, state in _opt_trees(trainer):
            if int(state.step) == 1:
                first.update({k: float(torch.linalg.vector_norm(m / (1 - b1)))
                              for k, m in weights.flat(state.m, name).items()})
    del trainer.recovery.resolve
    change = {}
    for name, params, _ in _opt_trees(trainer):
        for key, t in weights.flat(params, name).items():
            t0 = weights.draw(_initial_key(key), t.shape, t.dtype, run.seed, t.device)
            change[key] = float(torch.linalg.vector_norm(t.float() - t0.float()))
    run.extra["compared_replays"] = replays
    return SimpleNamespace(losses=losses, first=first, change=change, done=done,
                           data_nodes=sorted(trainer.head_params),
                           stages=len(trainer.stage_params))


def run(cell, run):
    from repro_torch.launch import train as T
    if run.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trainer, feed = build(cell, run)
    state = warm_up(cell, run, trainer, feed)
    if run.trace:
        _wrap(trainer.policy, "plan", run.spans, sync=False)
        _wrap(trainer.recovery, "resolve", run.spans, sync=False)
        _wrap(trainer, "_apply_update", run.spans, sync=run.device == "cuda")
    it = len(state.done)
    t_start = time.perf_counter()
    run.setup_s = t_start - run.t0
    while True:
        shards = feed(it)
        fed = sum(len(s.mbs) for s in shards.values())
        try:
            r, secs, tokens = T.train_iteration(trainer, shards)
        except Exception:
            traceback.print_exc(file=sys.stderr)
            run.attempted += fed
            run.failed += fed
            break
        it += 1
        run.attempted += r.launched
        if not math.isfinite(r.loss) or r.completed + r.dropped != r.launched:
            run.failed += r.launched
        run.records.append({"completed": r.completed, "launched": r.launched,
                            "dropped": r.dropped, "fwd_recomputes": r.fwd_recomputes,
                            "bwd_replays": r.bwd_replays, "tokens": tokens, "seconds": secs})
        if time.perf_counter() - t_start >= run.seconds:
            break
    run.window_s = time.perf_counter() - t_start
    if run.device == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated()
    if run.trace and run.device == "cuda":
        window_spans = {k: list(v) for k, v in run.spans.items()}
        k = cell.workload["profile_iterations"]
        run.profile, _ = profiling.profile(
            lambda: [T.train_iteration(trainer, feed(it + i)) for i in range(k)])
        run.extra["profile_iterations"] = k
        run.spans = window_spans
    state.trainer = trainer
    return state


def reference_trees(cell, state, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The weights the run started from, drawn again, in f32."""
    cfg = cell.config
    trees = {}
    for s, layers in enumerate(gwtf.stage_layers(cfg["num_layers"], state.stages)):
        trees[f"stage{s}"] = {
            path: weights.draw(f"stage{s}/{path}", (len(layers), *shape), weights.DTYPES[dt],
                               seed, device).float()
            for path, (shape, dt) in dense.layer_shapes(cfg).items()}
    head = {path: weights.draw(f"head/{path}", shape, weights.DTYPES[dt], seed, device).float()
            for path, (shape, dt) in dense.head_shapes(cfg).items()}
    for dn in state.data_nodes:
        trees[f"head{dn}"] = head
    return trees


def follow(cell, state, trees, device, pr=dense.F32, keep=lambda done: done, lr=None):
    """The reference over the warm-up iterations: (losses, first-gradient
    norms, change norms), each keyed as the program's; ``lr`` (with no
    weight decay) in place of the cell's."""
    opt = cell.workload["adamw"]
    if lr is not None:
        opt = dict(opt, lr=lr, weight_decay=0.0)
    with dense.tf32_off():
        ref = gwtf.Trainer(cell.config, trees, opt, state.stages, pr)
        losses, first = [], {}
        for done in state.done:
            completed = [(dn, torch.as_tensor(mb["tokens"], device=device),
                          torch.as_tensor(mb["labels"], device=device)) for dn, mb in keep(done)]
            loss, grads = ref.iteration(completed)
            losses.append(loss if completed else None)
            for name, g in grads.items():
                if ref.steps[name] == 1:
                    first.update({f"{name}/{k}": float(torch.linalg.vector_norm(x))
                                  for k, x in g.items()})
        change = {f"{name}/{k}": float(torch.linalg.vector_norm(t.detach() - trees[name][k]))
                  for name, tree in ref.trees.items() for k, t in tree.items()}
    return losses, first, change


def gaps(prog, ref) -> Dict[str, float]:
    """The three numbers of the module's docstring, ``prog`` against
    ``ref``, each a (losses, first-gradient norms, change norms)."""
    (pl, pg, pc), (rl, rg, rc) = prog, ref
    loss = max([abs(p - r) / abs(r) for p, r in zip(pl, rl) if p is not None and r is not None]
               or [0.0])
    med = statistics.median(rg.values())
    grad = max(abs(pg.get(k, 0.0) - rg.get(k, 0.0)) / max(rg.get(k, 0.0), med)
               for k in set(rg) | set(pg))
    counted = [k for k, v in rg.items() if v >= 1e-3 * med]
    cmed = statistics.median(rc[k] for k in counted)
    change = max(abs(pc.get(k, 0.0) - rc[k]) / max(rc[k], cmed) for k in counted)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def free(state) -> None:
    state.trainer = None
    harness.release()


def check(cell, run, state) -> Dict[str, tuple]:
    free(state)
    trees = reference_trees(cell, state, run.seed, run.device)
    ref = follow(cell, state, trees, run.device)
    limits = cell.workload["limits"]
    got = gaps((state.losses, state.first, state.change), ref)
    return {k: (v, limits[k]) for k, v in got.items() if k in limits}


def controls(cell, run, state) -> Dict[str, Dict[str, float]]:
    """Readings of the reference against itself with, in the program's
    place: the control (every product in float8); the fault of half of
    each iteration's completed microbatches left out, the mean taken over
    the rest; and the fault of a step that leaves the state unchanged (no
    first moment, no change, the losses of the first weights)."""
    free(state)
    trees = reference_trees(cell, state, run.seed, run.device)
    ref = follow(cell, state, trees, run.device)
    out = {"program": gaps((state.losses, state.first, state.change), ref)}
    out["control"] = gaps(follow(cell, state, trees, run.device, pr=dense.FP8), ref)
    out["half_batch"] = gaps(follow(cell, state, trees, run.device,
                                    keep=lambda done: done[::2]), ref)
    frozen = follow(cell, state, trees, run.device, lr=0.0)
    out["state_unchanged"] = gaps((frozen[0], {}, {k: 0.0 for k in frozen[2]}), ref)
    return out
