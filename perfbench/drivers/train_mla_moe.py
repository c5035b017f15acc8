"""Staged GWTF training of a DeepSeek-V3-style model (latent attention,
sigmoid-routed and shared experts, leading dense layers): ``train.py``'s
set-up, warm-up, window and harness profile (``build``, ``warm_up``,
``run``), and its gaps, against ``reference/mla_moe.py``.

Before anything is built, a program whose ``ModelConfig`` lacks one of
the configuration's model keys (``MODEL_KEYS``) is refused with a
message: ``harness.model_config`` drops a key it does not know, and the
program would build another model.

A stage's tree keys its leaves by kind (``dense/...``, ``moe/...``), as
the program's stage tree does; the reference draws each leaf again from
the seed under the same key, and keeps one copy of the weights.

With ``--trace 1``, after the harness's profile (which runs with the
program's spans off, so that the launches and idle shares count no
program range), one more iteration runs with the program's spans on
(``repro_torch.spans``): on the card under the profiler, charged by span
(``by_span.charge``) into ``run.extra["span_profile"]``, with the host's
blocking calls (``SYNCS``) made inside a ``moe`` span, and standard error
gets the device time, launches and idle of the top span paths.  Its
``expert_load_max`` goes to ``run.extra["expert_load_max"]``.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Dict

import torch

from perfbench import by_span, weights
from perfbench.drivers import train
from perfbench.reference import dense, gwtf, mla_moe

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "aten::item", "aten::_local_scalar_dense")
MODEL_KEYS = ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
              "router_score", "norm_topk_prob", "routed_scaling_factor",
              "first_dense_layers", "dense_d_ff", "norm_eps")


def refuse_unknown_keys(cell) -> None:
    from repro_torch.models.config import ModelConfig
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    missing = [k for k in MODEL_KEYS if k in cell.config and k not in known]
    if missing:
        raise SystemExit(f"{cell.name}: the program's ModelConfig has no "
                         f"{', '.join(missing)}; it cannot build this model")


def moe_host_syncs(events) -> int:
    """The host's blocking calls (``SYNCS``) made while a ``moe`` span of
    the program was open on the same thread."""
    from torch.autograd import DeviceType
    host = [e for e in events if e.device_type == DeviceType.CPU]
    moe = [e for e in host if e.name == by_span.PROGRAM + "moe"]
    return sum(1 for e in host if e.name in SYNCS and any(
        m.thread == e.thread and m.time_range.start <= e.time_range.start <= m.time_range.end
        for m in moe))


def _report(prof: dict, n: int = 20) -> None:
    dev, count, idle = prof["span_device_s"], prof["span_launches"], prof["span_idle_s"]
    keys = sorted(set(dev) | set(idle), key=lambda k: -(dev.get(k, 0) + idle.get(k, 0)))
    print(f"traced iteration with spans: {prof['moe_host_syncs']} blocking host calls in "
          f"moe spans; device s, launches, idle s by span path:", file=sys.stderr)
    for k in keys[:n]:
        print(f"{dev.get(k, 0):10.6f} {count.get(k, 0):7d} {idle.get(k, 0):10.6f}  {k}",
              file=sys.stderr)


def _traced_iteration(run, trainer, shards) -> None:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import spans
    from repro_torch.launch.train import train_iteration
    spans.enable()
    try:
        if run.device != "cuda":
            r, _, _ = train_iteration(trainer, shards)
        else:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                r, _, _ = train_iteration(trainer, shards)
                torch.cuda.synchronize()
            events = prof.events()
            run.extra["span_profile"] = dict(by_span.charge(events), iterations=1,
                                             completed=r.completed,
                                             moe_host_syncs=moe_host_syncs(events))
            _report(run.extra["span_profile"])
    finally:
        spans.disable()
        spans.drain()
    run.extra["expert_load_max"] = [r.expert_load_max]


def run(cell, run):
    refuse_unknown_keys(cell)
    state = train.run(cell, run)
    if run.trace:
        it = len(state.done) + len(run.records) + run.extra.get("profile_iterations", 0)
        feed = train.Feed(run.seed, cell.config["vocab_size"], state.data_nodes, cell.workload)
        _traced_iteration(run, state.trainer, feed(it))
    return state


def _leaves(cell, state) -> Dict[str, Dict[str, tuple]]:
    """Each tree's leaves as the program drew them: {tree: {leaf path: (the
    weights' key, shape, dtype name)}}."""
    cfg = cell.config
    out = {}
    for s, layers in enumerate(gwtf.stage_layers(cfg["num_layers"], state.stages)):
        out[f"stage{s}"] = {
            f"{kind}/{path}": (f"stage{s}/{kind}/{path}", (len(idx), *shape), dt)
            for kind, idx in mla_moe.stage_kinds(cfg, layers)
            for path, (shape, dt) in mla_moe.layer_shapes(cfg, kind).items()}
    head = {path: (f"head/{path}", shape, dt) for path, (shape, dt) in dense.head_shapes(cfg).items()}
    out.update({f"head{dn}": head for dn in state.data_nodes})
    return out


def _draw(leaf: tuple, seed: int, device) -> torch.Tensor:
    key, shape, dt = leaf
    return weights.draw(key, shape, weights.DTYPES[dt], seed, device).float()


def follow(cell, state, seed: int, device, pr=mla_moe.F32, keep=lambda done: done, lr=None):
    """``train.follow`` over ``reference/mla_moe.py``'s trainer, from the
    weights the run started from, drawn again in f32.  The trainer keeps
    the only copy of them: each leaf's change is taken against the leaf
    drawn once more (a stage of 2.4 B f32 parameters, its gradients and
    moments leave no room for a second copy on the card)."""
    opt = cell.workload["adamw"]
    if lr is not None:
        opt = dict(opt, lr=lr, weight_decay=0.0)
    leaves = _leaves(cell, state)
    with dense.tf32_off():
        ref = mla_moe.Trainer(cell.config, {name: {k: _draw(leaf, seed, device)
                                                   for k, leaf in tree.items()}
                                            for name, tree in leaves.items()},
                              opt, state.stages, pr)
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
        change = {f"{name}/{k}": float(torch.linalg.vector_norm(
            ref.trees[name][k].detach() - _draw(leaf, seed, device)))
            for name, tree in leaves.items() for k, leaf in tree.items()}
    return losses, first, change


def check(cell, run, state) -> Dict[str, tuple]:
    train.free(state)
    ref = follow(cell, state, run.seed, run.device)
    limits = cell.workload["limits"]
    got = train.gaps((state.losses, state.first, state.change), ref)
    return {k: (v, limits[k]) for k, v in got.items() if k in limits}


def controls(cell, run, state) -> Dict[str, Dict[str, float]]:
    """``train.controls`` over this reference: the program, the control
    (every product in float8), half of each iteration's microbatches left
    out, and a step that leaves the state unchanged."""
    train.free(state)
    ref = follow(cell, state, run.seed, run.device)
    out = {"program": train.gaps((state.losses, state.first, state.change), ref)}
    out["control"] = train.gaps(follow(cell, state, run.seed, run.device, pr=mla_moe.FP8), ref)
    out["half_batch"] = train.gaps(follow(cell, state, run.seed, run.device,
                                          keep=lambda done: done[::2]), ref)
    frozen = follow(cell, state, run.seed, run.device, lr=0.0)
    out["state_unchanged"] = train.gaps((frozen[0], {}, {k: 0.0 for k in frozen[2]}), ref)
    return out
