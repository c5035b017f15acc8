"""The port's flow-routed ``ServeTrainer`` against the JAX package's.

Both trainers come from their own package's
``scenarios.generate.build_serving_runtime`` on the same ``ScenarioSpec``
fields (``tests/test_serving.py``'s tiny 3-stage geo serving scenario,
reduced ``gwtf-llama-300m``, f32).  The port trainer then takes the JAX
trainer's parameters (through ``weights.params_from_jax``) and prompt
rows.  Calm, with a relay crash mid-decode (``(0, "crash", 5, 0.45)``)
and, under that crash, undefended (``reroute=False``): the per-iteration
``ServingIterationMetrics``, ``summarize_serving``, the engine's chain
plans, the ``FaultTimeline`` records, the four dispatch counters and
every greedy token stream are exactly equal.  The hybrid model's case
and the port's own batching checks are in
``test_torch_serve_trainer_ssm.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.scenarios import generate as j_generate
from repro.core.scenarios.spec import ScenarioSpec as JSpec
from repro.core.sim.metrics import summarize_serving as j_summarize
from repro_torch.core.runtime.serving import ServeTrainer
from repro_torch.core.scenarios import generate as t_generate
from repro_torch.core.scenarios.spec import ScenarioSpec as TSpec
from repro_torch.core.sim.metrics import summarize_serving as t_summarize
from repro_torch.weights import params_from_jax

COUNTERS = ("prefill_calls", "decode_dispatches", "stacked_rows",
            "replay_steps")
CRASH = [{"kind": "trace", "events": [(0, "crash", 5, 0.45)]}]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def serving_spec_kw(**overrides):
    """``tests/test_serving.py``'s serving scenario, as keywords."""
    kw = dict(name="t-serve", seed=26, num_stages=3, relays_per_stage=3,
              num_data_nodes=1, iterations=2, model_layers=2, model_d=32,
              model_vocab=128, seq_len=16, microbatch_size=1,
              arrivals=[{"kind": "spike", "at_iteration": 0, "requests": 3,
                         "when": 0.2}],
              prompt_len=8, gen_tokens=16, serve_batch=4)
    kw.update(overrides)
    return kw


def port_trainer(spec_kw, jt=None, **kw) -> ServeTrainer:
    """The port's trainer on the CPU; with ``jt``, on its parameters and
    prompts."""
    spec = TSpec(**spec_kw)
    spec.validate()
    tt = t_generate.build_serving_runtime(spec, device="cpu", **kw)
    if jt is not None:
        tt.params = params_from_jax(tt.cfg, jax.tree.map(np.asarray, jt.params),
                                    device="cpu")
        tt._prompts = torch.from_numpy(np.array(jt._prompts))
    return tt


def run_both(spec_kw, **kw):
    """Build and run both packages' trainers over the spec's iterations;
    returns ``(jax_trainer, jax_metrics, port_trainer, port_metrics)``."""
    spec = JSpec(**spec_kw)
    spec.validate()
    jt = j_generate.build_serving_runtime(spec, **kw)
    tt = port_trainer(spec_kw, jt, **kw)
    return jt, jt.run(spec.iterations), tt, tt.run(spec.iterations)


def assert_same_run(jt, jm, tt, tm):
    assert [dataclasses.asdict(m) for m in tm] == \
        [dataclasses.asdict(m) for m in jm]
    assert [t_summarize([m]) for m in tm] == [j_summarize([m]) for m in jm]
    assert t_summarize(tm) == j_summarize(jm)
    assert tt.engine.chain_plans == jt.engine.chain_plans
    assert tt.engine.traces == jt.engine.traces
    assert ([vars(r) for r in tt.timeline.records]
            == [vars(r) for r in jt.timeline.records])
    assert ({c: getattr(tt, c) for c in COUNTERS}
            == {c: getattr(jt, c) for c in COUNTERS})
    assert sorted(tt.engine.requests) == sorted(jt.engine.requests)
    for rid in jt.engine.requests:
        assert tt.token_stream(rid) == jt.token_stream(rid), rid


@pytest.mark.parametrize("case", ["calm", "crash", "undefended"])
def test_serve_trainer_matches_jax(case):
    churn = [] if case == "calm" else CRASH
    kw = {"reroute": False} if case == "undefended" else {}
    spec_kw = serving_spec_kw(churn=churn)
    jt, jm, tt, tm = run_both(spec_kw, **kw)
    assert_same_run(jt, jm, tt, tm)
    assert t_summarize(tm)["completed"] >= 1.0
    assert tt.stacked_rows > tt.decode_dispatches     # cohorts did stack
    requeues = [op for tl in tt.engine.traces for op in tl
                if op[0] == "requeue"]
    if case == "crash":
        # every victim is mid-decode when the relay dies, and its cache
        # is rebuilt by replay
        assert requeues and all(op[5] > 0 for op in requeues)
        assert tt.replay_steps > 0 and tt.timeline.records
    if case == "undefended":
        assert not requeues and t_summarize(tm)["restarts"] >= 1.0
    if churn:
        # repaired or restarted, the streams are the calm run's
        calm = port_trainer(serving_spec_kw())
        calm.params, calm._prompts = tt.params, tt._prompts
        calm.run(spec_kw["iterations"])
        for rid in jt.engine.requests:
            assert tt.token_stream(rid) == calm.token_stream(rid), rid
