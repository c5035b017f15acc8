"""The port's copies of the JAX package's numpy modules against the
originals.

The port imports nothing of ``repro``, so the flow planner, the swarm
router, the fault and routing layers and the data pipeline it trains with
are copies under ``src/repro_torch/``.  Two guards hold them equal:

* each copy matches its original line for line once the original's
  ``repro.`` imports are rewritten to ``repro_torch.``;
* once for each package boundary (a smoke test: the first guard already
  makes the code the same), both packages plan the same complete flows
  with the same RNG stream, draw the same churn, record the same fault
  timeline, solve the same min-cost flow, route the same swarm paths and
  produce the same data batches.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from repro.core.flow import graph as j_graph
from repro.core.flow import mincost as j_mincost
from repro.core.sim import faults as j_faults
from repro.core.sim import policies as j_policies
from repro.core.sim import timeline as j_timeline
from repro.data import pipeline as j_pipeline
from repro_torch.core.flow import graph as t_graph
from repro_torch.core.flow import mincost as t_mincost
from repro_torch.core.sim import faults as t_faults
from repro_torch.core.sim import policies as t_policies
from repro_torch.core.sim import timeline as t_timeline
from repro_torch.data import pipeline as t_pipeline

SRC = Path(__file__).resolve().parents[1] / "src"
COPIES = ["data/pipeline.py", "core/flow/graph.py", "core/flow/decentralized.py",
          "core/flow/mincost.py", "core/swarm.py", "core/sim/faults.py",
          "core/sim/timeline.py", "core/sim/policies.py"]
IMPORT = re.compile(r"^(\s*)(from|import) repro\.")
SEED = 7


@pytest.mark.parametrize("path", COPIES)
def test_copy_matches_original(path):
    original = [IMPORT.sub(r"\1\2 repro_torch.", line) for line in
                (SRC / "repro" / path).read_text().splitlines()]
    copy = (SRC / "repro_torch" / path).read_text().splitlines()
    assert len(copy) == len(original)
    for n, (a, b) in enumerate(zip(copy, original), 1):
        assert a == b, f"{path}:{n} drifted from the original"


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
