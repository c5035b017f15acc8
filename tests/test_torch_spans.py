"""The port's spans (``repro_torch.spans``) and its host-sync counter.

With tracing off nothing is recorded and no profiler range opens; with it
on, the spans of a training iteration and of a ``generate`` call nest as
the code does and carry ``iteration``, ``request`` and ``step``.  Tracing
changes nothing the program computes: losses, parameters, dispatch
counters and served tokens are bit-identical on and off, and the op stream
that ``launch/trace_analysis.py`` counts is the same less the profiler's
own range ops.  ``IterationResult.host_syncs`` counts the numeric pass's
blocking round trips: three a dispatch chunk (tokens and labels copied to
the device, the loss read back), and on the per-microbatch path three a
microbatch plus, with the gradient screen, one a leaf of each stage
gradient it copies to the host.
"""
import collections
import dataclasses
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.core.runtime import cache
from repro_torch.core.runtime.serving import serving_inputs
from repro_torch.launch import train as T
from repro_torch.launch.serve import generate
from repro_torch.launch.trace_analysis import analyze_step, count_flops
from repro_torch.models.transformer import init_params, train_loss
from repro_torch.tree import leaves

CFG = dataclasses.replace(
    get_config("gwtf-llama-300m").reduced(num_layers=2, d_model=64),
    vocab_size=256, param_dtype="float32")


@pytest.fixture(autouse=True)
def quiet():
    """One torch thread, deterministic kernels, tracing off and no records
    left over, before and after each test."""
    threads = torch.get_num_threads()
    det = torch.are_deterministic_algorithms_enabled()
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()
    torch.use_deterministic_algorithms(det)
    torch.set_num_threads(threads)


def _trainer(churn=0.2, microbatches=2, chunk=None):
    args = T.parser().parse_args([
        "--mode", "gwtf", "--device", "cpu", "--stages", "2",
        "--relays-per-stage", "3", "--data-nodes", "1",
        "--microbatches", str(microbatches), "--batch", "2",
        "--seq-len", "16", "--churn", str(churn), "--seed", "3"])
    cache.clear()
    trainer, shards = T.build_gwtf(args, CFG)
    trainer.dispatch_chunk = chunk
    return trainer, shards


def _path(s) -> str:
    names = []
    while s is not None:
        names.append(s.name)
        s = s.parent
    return "/".join(reversed(names))


def _train(trainer, shards, n=3):
    return [T.train_iteration(trainer, shards)[0] for _ in range(n)]


def test_off_records_nothing_and_opens_no_profiler_range():
    assert spans.span("x", a=1) is spans.span("y")
    trainer, shards = _trainer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _train(trainer, shards, 2)
    assert spans.drain() == []
    assert not [e.name for e in prof.events() if spans.PREFIX in e.name]
    # the same run traced shows the ranges, so the check above can fail
    spans.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _train(trainer, shards, 1)
    names = {e.name for e in prof.events()}
    assert {spans.PREFIX + n for n in ("iteration", "chunk", "stage.fwd",
                                       "attention.core", "update")} <= names


def test_training_spans_nest_with_their_ids():
    spans.enable()
    trainer, shards = _trainer(chunk=1)
    results = _train(trainer, shards)
    recs = spans.drain()
    assert all(r.end_ns is not None and r.end_ns >= r.start_ns for r in recs)
    for r in recs:
        if r.parent is not None:
            assert r.parent.start_ns <= r.start_ns <= r.end_ns <= r.parent.end_ns
    paths = collections.Counter(_path(r) for r in recs)
    assert paths["init.params"] == 1
    assert paths["iteration"] == 3
    for phase in ("churn", "plan", "resolve", "execute", "commit"):
        assert paths[f"iteration/{phase}"] == 3
    chunks = sum(r.completed for r in results)
    assert paths["iteration/execute/chunk"] == chunks
    for name in ("batch", "embed", "head_loss", "embed.bwd", "loss_sync"):
        assert paths[f"iteration/execute/chunk/{name}"] == chunks
    assert paths["iteration/execute/chunk/stage.fwd"] == 2 * chunks
    assert paths["iteration/execute/chunk/stage.bwd"] == 2 * chunks
    fwd = "iteration/execute/chunk/stage.fwd/"
    assert paths[fwd + "norm"] == 2 * paths[fwd + "attention"] == 2 * paths[fwd + "mlp"]
    assert paths[fwd + "attention"] == CFG.num_layers * chunks     # one a layer
    assert paths[fwd + "attention/attention.core"] == paths[fwd + "attention"]
    updates = sum(1 for r in results if r.completed)
    assert paths["iteration/execute/update"] == updates
    # AdamW per tree: two stages and one head
    assert paths["iteration/execute/update/adamw.clip"] == 3 * updates
    assert paths["iteration/execute/update/adamw.step"] == 3 * updates
    replays = [r for r in recs if r.name == "replay"]
    assert len(replays) == sum(r.fwd_recomputes + r.bwd_replays for r in results) > 0
    assert all(_path(r.parent) == "iteration/execute/chunk" for r in replays)
    assert all(r.ids["direction"] in ("fwd", "bwd") and r.ids["stage"] in (0, 1)
               for r in replays)
    # every span of an iteration carries its step; a stage's, its stage
    by_it = collections.Counter(r.ids["iteration"] for r in recs if r.name != "init.params")
    assert set(by_it) == {0, 1, 2}
    assert all(r.ids["stage"] == r.parent.ids["stage"] for r in recs
               if r.parent is not None and r.parent.name == "stage.fwd")
    assert {r.ids["stage"] for r in recs if r.name == "stage.bwd"} == {0, 1}


def test_serving_spans_nest_with_request_and_step():
    model, prompt, _ = serving_inputs(CFG, seed=1, batch=2, prompt_len=8, device="cpu")
    spans.enable()
    for _ in range(2):
        generate(model, CFG, prompt, gen=3, window=None, temperature=0.0, generator=None)
    recs = spans.drain()
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == (["prefill", "sample", "logits"]
                                       + ["decode.step", "sample", "logits"] * 3) * 2
    first, second = roots[0].ids["request"], roots[12].ids["request"]
    assert second == first + 1
    assert all(r.ids["request"] == (first if i < 12 else second) for i, r in enumerate(roots))
    assert [r.ids.get("step") for r in roots[:12]] == [None] * 3 + [0] * 3 + [1] * 3 + [2] * 3
    core = [r for r in recs if r.name == "attention.core"]
    assert len(core) == 2 * 4 * CFG.num_layers
    steps = [r for r in core if _path(r) == "decode.step/attention/attention.core"]
    assert len(steps) == 2 * 3 * CFG.num_layers
    assert all(r.ids["step"] == r.parent.parent.ids["step"] for r in steps)


def test_tracing_changes_nothing_the_trainer_computes():
    runs = []
    for on in (False, True):
        if on:
            spans.enable()
        trainer, shards = _trainer()
        results = _train(trainer, shards)
        runs.append(SimpleNamespace(
            results=results, snapshot=trainer.stages.snapshot(),
            params=[t.clone() for t in leaves((trainer.stage_params, trainer.head_params))],
            moments=[t.clone() for t in leaves([o.m for o in trainer.stage_opt])]))
        spans.disable()
    off, on = runs
    assert on.results == off.results            # losses and every counter
    assert on.snapshot == off.snapshot
    assert all(torch.equal(a, b) for a, b in zip(off.params, on.params))
    assert all(torch.equal(a, b) for a, b in zip(off.moments, on.moments))
    assert sum(r.fwd_recomputes + r.bwd_replays for r in off.results) > 0


def test_tracing_changes_no_served_token():
    model, prompt, _ = serving_inputs(CFG, seed=2, batch=2, prompt_len=8, device="cpu")
    outs = []
    for on in (False, True):
        if on:
            spans.enable()
        outs.append(generate(model, CFG, prompt, gen=4, window=None,
                             temperature=0.0, generator=None))
    assert torch.equal(outs[0].tokens, outs[1].tokens)
    assert torch.equal(outs[0].logits, outs[1].logits)


@pytest.mark.parametrize("chunk", [None, 1])
def test_host_syncs_three_a_dispatch_chunk(chunk):
    trainer, shards = _trainer(churn=0.0, microbatches=4, chunk=chunk)
    for r in _train(trainer, shards, 2):
        per = chunk or r.completed                   # the reduced width: one chunk
        assert r.completed == 4
        assert r.host_syncs == 3 * (r.completed // per)


@pytest.mark.parametrize("screen", [False, True])
def test_host_syncs_on_the_per_microbatch_path(screen):
    trainer, shards = _trainer(churn=0.0, microbatches=3)
    trainer.batch_microbatches = False
    trainer.grad_screen = screen
    leaves_per_mb = sum(len(leaves(p)) for p in trainer.stage_params)
    for r in _train(trainer, shards, 2):
        assert r.completed == 3
        assert r.host_syncs == 3 * r.completed + (leaves_per_mb * r.completed if screen else 0)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_trace_analysis_counts_unchanged_with_tracing_off():
    model = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, CFG.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks}

    def step():
        return train_loss(model, batch, CFG)

    seen = {}
    for on in (False, True):
        if on:
            spans.enable()
        with _Ops() as mode:
            step()
        _, costs = analyze_step(step)
        seen[on] = (mode.ops, costs, count_flops(step))
    (off_ops, off_costs, off_flops), (on_ops, on_costs, on_flops) = seen[False], seen[True]
    assert not [op for op in off_ops if op.startswith("profiler.")]
    # on, without a profiler running, no range is entered either
    assert on_ops == off_ops
    assert (on_costs.dot_flops, on_costs.temp_peak_bytes, on_costs.comm_counts) == \
        (off_costs.dot_flops, off_costs.temp_peak_bytes, off_costs.comm_counts)
    assert on_flops == off_flops > 0
    # under a profiler the ranges are dispatcher ops, so the checks above can fail
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), \
            _Ops() as mode:
        step()
    assert [op for op in mode.ops if op.startswith("profiler.")]
    assert [op for op in mode.ops if not op.startswith("profiler.")] == off_ops


def test_drain_forgets_and_keeps_order():
    spans.enable()
    with spans.span("a", request=7):
        with spans.span("b", step=1):
            pass
    with spans.span("c"):
        got = spans.drain()
        assert got[2].end_ns is None                 # still open
    assert [(r.name, r.ids) for r in got] == [("a", {"request": 7}),
                                              ("b", {"request": 7, "step": 1}),
                                              ("c", {})]
    assert got[1].parent is got[0] and got[2].parent is None
    assert [r.name for r in spans.drain()] == []
    spans.disable()
    with spans.span("d"):
        pass
    assert spans.drain() == []
