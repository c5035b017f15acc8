"""The port's copies of the JAX package's numpy modules against the
originals.

The port imports nothing of ``repro``, so the flow planner, the swarm
router, the fault and routing layers and the data pipeline it trains with
are copies under ``src/repro_torch/``.  Two guards hold them equal:

* each copy matches its original line for line once the original's
  ``repro.`` imports are rewritten to ``repro_torch.`` (and, for
  ``examples/torch_churn_recovery.py``, the usage lines name the copy's
  own path); the port's text
  cites no numbered change of the reference's history, so the lines named
  in ``CITED`` (two comments of ``core/scenarios/spec.py``, one of
  ``core/scenarios/corpus.py``) must differ from the original in such a
  citation and nothing else;
* once for each package boundary (a smoke test: the first guard already
  makes the code the same), both packages plan the same complete flows
  with the same RNG stream, draw the same churn, record the same fault
  timeline, solve the same min-cost flow, route the same swarm paths,
  produce the same data batches and schedule the same serving requests,
  and both scenario generators build runtimes that train alike.
"""
import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")


from repro.core.flow import graph as j_graph
from repro.core.flow import mincost as j_mincost
from repro.core.scenarios import generate as j_generate
from repro.core.scenarios.spec import ScenarioSpec as JSpec
from repro.core.sim import faults as j_faults
from repro.core.sim import policies as j_policies
from repro.core.sim import timeline as j_timeline
from repro.data import pipeline as j_pipeline
from repro_torch.core.flow import graph as t_graph
from repro_torch.core.flow import mincost as t_mincost
from repro_torch.core.scenarios import generate as t_generate
from repro_torch.core.scenarios.spec import ScenarioSpec as TSpec
from repro_torch.core.sim import faults as t_faults
from repro_torch.core.sim import policies as t_policies
from repro_torch.core.sim import timeline as t_timeline
from repro_torch.data import pipeline as t_pipeline

SRC = Path(__file__).resolve().parents[1] / "src"
COPIES = ["data/pipeline.py", "core/flow/graph.py", "core/flow/decentralized.py",
          "core/flow/mincost.py", "core/swarm.py", "core/sim/faults.py",
          "core/sim/timeline.py", "core/sim/policies.py", "core/sim/metrics.py",
          "core/sim/engine.py", "core/sim/facade.py", "core/sim/__init__.py",
          "core/flow/reference.py", "core/scenarios/spec.py",
          "core/scenarios/generate.py", "core/scenarios/__init__.py",
          "core/flow/hierarchy.py", "core/sim/reference.py",
          "core/simulator.py", "core/join.py", "core/membership.py",
          "core/scenarios/corpus.py"]
IMPORT = re.compile(r"^(\s*)(from|import) repro\.")
# a comment's citation of a numbered change: ", <KIND> <n>)" or " (<KIND> <n>)"
CITATION = re.compile(r"(, [A-Z]+ \d+(?=\))| \([A-Z]+ \d+\))")
# the only lines of the copies that word the original without its citation
CITED = {"core/scenarios/spec.py": {60, 88},
         "core/scenarios/corpus.py": {111}}
SEED = 7


@pytest.mark.parametrize("path", COPIES)
def test_copy_matches_original(path):
    original = [IMPORT.sub(r"\1\2 repro_torch.", line)
                for line in (SRC / "repro" / path).read_text().splitlines()]
    copy = (SRC / "repro_torch" / path).read_text().splitlines()
    assert len(copy) == len(original)
    for n, (a, b) in enumerate(zip(copy, original), 1):
        if n in CITED.get(path, ()):
            assert CITATION.search(b), f"{path}:{n} cites no change"
            b = CITATION.sub("", b)
        assert a == b, f"{path}:{n} drifted from the original"


def test_example_copy_matches_original():
    """``examples/torch_churn_recovery.py``, numpy only, through the port's
    simulator copies."""
    examples = SRC.parent / "examples"
    original = [IMPORT.sub(r"\1\2 repro_torch.", line).replace(
        "examples/churn_recovery.py", "examples/torch_churn_recovery.py")
        for line in (examples / "churn_recovery.py").read_text().splitlines()]
    copy = (examples / "torch_churn_recovery.py").read_text().splitlines()
    assert copy == original


def _nets(seed, stages=3, relays=4, data_nodes=2):
    kw = dict(num_stages=stages, relay_capacities=[2] * (stages * relays),
              num_data_nodes=data_nodes, data_capacity=4)
    return (j_graph.geo_distributed_network(rng=np.random.default_rng(seed), **kw),
            t_graph.geo_distributed_network(rng=np.random.default_rng(seed), **kw))


def _state(rng):
    return rng.bit_generator.state


def test_plans_churn_and_timeline_equal(seed=SEED):
    """Three iterations of plan → churn draw → timeline → crash commit, as
    the trainers run them, through both packages' layers."""
    nets = _nets(seed)
    rngs = [np.random.default_rng(seed + 100) for _ in nets]
    pols = [j_policies.GWTFPolicy(nets[0], rng=rngs[0]),
            t_policies.GWTFPolicy(nets[1], rng=rngs[1])]
    churns = [j_faults.BernoulliChurn(0.2), t_faults.BernoulliChurn(0.2)]
    lines = [j_timeline.FaultTimeline(), t_timeline.FaultTimeline()]
    ctxs = [j_faults.ChurnContext, t_faults.ChurnContext]
    injections = [j_timeline.record_injections, t_timeline.record_injections]
    for it in range(3):
        crashes = [churns[k].sample(ctxs[k](
            net=nets[k], rng=rngs[k], horizon=1.0, iteration=it,
            on_rejoin=pols[k].on_rejoin)) for k in range(2)]
        assert crashes[0] == crashes[1]
        for k in range(2):
            injections[k](lines[k], it, crashes[k], None)
        plans = [[list(c) for c in p.plan()] for p in pols]
        assert plans[0] == plans[1]
        assert (pols[0].protocol.complete_flows()
                == pols[1].protocol.complete_flows())
        assert _state(rngs[0]) == _state(rngs[1])
        for k in range(2):
            for nid in crashes[k]:
                nets[k].kill_node(nid)
                pols[k].on_crash(nid)
    assert lines[0].records                     # churn did strike
    assert ([vars(r) for r in lines[0].records]
            == [vars(r) for r in lines[1].records])


def test_mincost_and_swarm_equal(seed=SEED):
    nets = _nets(seed)
    plans = [j_mincost.solve_training_flow(nets[0]),
             t_mincost.solve_training_flow(nets[1])]
    assert plans[0].flow == plans[1].flow
    assert plans[0].cost == plans[1].cost
    assert plans[0].paths == plans[1].paths
    rngs = [np.random.default_rng(seed) for _ in nets]
    swarm = [j_policies.SwarmPolicy(nets[0], rng=rngs[0]),
             t_policies.SwarmPolicy(nets[1], rng=rngs[1])]
    assert ([list(p) for p in swarm[0].plan()]
            == [list(p) for p in swarm[1].plan()])
    assert _state(rngs[0]) == _state(rngs[1])


def test_data_batches_equal(seed=SEED):
    shards = [mod.DataNodeShard(mod.DataConfig(
        vocab_size=512, seq_len=32, batch_size=8, microbatch_size=2,
        seed=seed), 1, 2) for mod in (j_pipeline, t_pipeline)]
    for _ in range(2):
        a, b = (s.microbatches() for s in shards)
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(x[k], y[k])


def test_serving_engines_equal(seed=SEED):
    """Both packages' ``ServingEngine``s, each from its own scenario
    builder on one spec (Poisson arrivals, Bernoulli churn): the same
    ledgers, chain plans, schedules, timelines and RNG stream."""
    kw = dict(name="t-engine", seed=seed, num_stages=3, relays_per_stage=3,
              num_data_nodes=1, iterations=4, model_layers=2, model_d=32,
              model_vocab=128, seq_len=16, microbatch_size=1,
              arrivals=[{"kind": "poisson", "rate": 2.0}],
              churn=[{"kind": "bernoulli", "p": 0.1}],
              prompt_len=8, gen_tokens=16, serve_batch=2)
    engines = [gen.build_serving_sim(spec(**kw)) for gen, spec in
               ((j_generate, JSpec), (t_generate, TSpec))]
    ledgers = [[vars(m) for m in e.run(kw["iterations"])] for e in engines]
    assert ledgers[0] == ledgers[1]
    assert sum(m["admitted"] for m in ledgers[0]) > 0
    assert engines[0].chain_plans == engines[1].chain_plans
    assert engines[0].traces == engines[1].traces
    assert ([vars(r) for r in engines[0].timeline.records]
            == [vars(r) for r in engines[1].timeline.records])
    assert engines[0].timeline.records             # churn did strike
    assert _state(engines[0].rng) == _state(engines[1].rng)


def test_runtime_builders_equal(seed=SEED):
    """Both packages' ``build_runtime`` on one spec (Bernoulli churn): the
    same data batches, and over one iteration the same counters, chains,
    fault timeline and RNG stream (the parameters are each package's own
    draw, so the losses differ)."""
    kw = dict(name="t-runtime", seed=seed, num_stages=2, relays_per_stage=3,
              num_data_nodes=2, iterations=1, model_layers=2, model_d=32,
              model_vocab=128, seq_len=16, microbatch_size=2, microbatches=2,
              churn=[{"kind": "bernoulli", "p": 0.2}])
    (jt, jb), (tt, tb) = (j_generate.build_runtime(JSpec(**kw)),
                          t_generate.build_runtime(TSpec(**kw), device="cpu"))
    assert sorted(jb) == sorted(tb)
    for dn in jb:
        assert len(jb[dn]) == len(tb[dn]) == 2
        for x, y in zip(jb[dn], tb[dn]):
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(x[k], y[k])
    rj, rt = jt.iteration(jb), tt.iteration(tb)
    for f in ("completed", "launched", "dropped", "rerouted", "requeued"):
        assert getattr(rt, f) == getattr(rj, f), f
    assert rt.completed > 0 and tt.last_chains == jt.last_chains
    assert jt.timeline.records                     # churn did strike
    assert ([vars(r) for r in tt.timeline.records]
            == [vars(r) for r in jt.timeline.records])
    assert _state(jt.rng) == _state(tt.rng)
