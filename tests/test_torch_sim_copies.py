"""The port's copies of the frozen reference simulator, the simulator
shim, node insertion and membership.

* the port's ``SimulationEngine`` (through the shim's
  ``TrainingSimulator``) is metric- and RNG-identical to the port's copy
  of the frozen ``ReferenceTrainingSimulator`` on seeded GWTF runs,
  ``tests/test_sim_engine.py::TestEngineEquivalence``'s contract, and
  both equal the JAX package's reference simulator;
* ``join`` (bottleneck-stage-first insertion, paper Sec. V-B) and
  ``membership`` (the simulated DHT and bully election) give the JAX
  package's results on one seeded case each.

The copies are held line for line by ``test_torch_train_copies.py``.
"""
import numpy as np
import pytest

pytest.importorskip("torch")


from repro.core import join as j_join
from repro.core import membership as j_membership
from repro.core.flow import graph as j_graph
from repro.core.sim.reference import ReferenceTrainingSimulator as JReference
from repro_torch.core import join as t_join
from repro_torch.core import membership as t_membership
from repro_torch.core.flow import graph as t_graph
from repro_torch.core.sim.reference import ReferenceTrainingSimulator
from repro_torch.core.simulator import TrainingSimulator

# the contract's fields (the frozen loop counts no reroutes)
FIELDS = ("duration", "completed", "launched", "comm_time", "wasted_gpu",
          "aggregation_time")


def _net(graph):
    rng = np.random.default_rng(3)
    caps = [int(rng.uniform(1, 4)) for _ in range(16)]
    return graph.geo_distributed_network(
        num_stages=4, relay_capacities=caps, num_data_nodes=2,
        data_capacity=4, compute_cost=0.05, rng=np.random.default_rng(3))


@pytest.mark.parametrize("churn", [0.0, 0.15])
def test_engine_equals_frozen_reference(churn):
    runs = [TrainingSimulator(_net(t_graph), scheduler="gwtf", churn=churn,
                              rng=np.random.default_rng(12)),
            ReferenceTrainingSimulator(_net(t_graph), scheduler="gwtf",
                                       churn=churn,
                                       rng=np.random.default_rng(12)),
            JReference(_net(j_graph), scheduler="gwtf", churn=churn,
                       rng=np.random.default_rng(12))]
    metrics = [sim.run(5) for sim in runs]
    for its in zip(*metrics):
        for f in FIELDS:
            assert len({getattr(m, f) for m in its}) == 1, f
    assert metrics[0][0].completed > 0
    assert (runs[0].rng.bit_generator.state == runs[1].rng.bit_generator.state
            == runs[2].rng.bit_generator.state)
    if churn:                                   # churn did strike
        assert sum(m.reroutes for m in metrics[0]) > 0


def test_join_equals_jax():
    nets = [_net(j_graph), _net(t_graph)]
    flows = [[0, 2, 6, 10, 14, 0], [1, 3, 7, 11, 15, 1], [0, 4, 8, 12, 16, 0]]
    reports = [mod.flood_utilization(net, flows)
               for mod, net in ((j_join, nets[0]), (t_join, nets[1]))]
    assert [vars(r) for r in reports[0]] == [vars(r) for r in reports[1]]
    caps = [1, 9, 5, 3, 7]
    for policy in ("gwtf", "random"):
        got = [mod.assign_joiners(
            [mod.StageReport(**vars(r)) for r in rep], caps, policy=policy,
            rng=np.random.default_rng(4))
            for mod, rep in ((j_join, reports[0]), (t_join, reports[1]))]
        assert got[0] == got[1], policy


def test_membership_equals_jax():
    out = []
    for mod in (j_membership, t_membership):
        dht = mod.DHT(rng=np.random.default_rng(9))
        for nid, stage, cap, data in ((5, -1, 4, True), (2, -1, 4, True),
                                      (7, 0, 2, False), (8, 0, 3, False),
                                      (9, 0, 1, False), (11, 1, 2, False)):
            dht.publish(mod.Contact(nid, stage, cap, is_data=data))
        leaders = [mod.elect_leader(dht)]
        dht.registry[2].alive = False
        leaders.append(mod.elect_leader(dht))
        found = [c.node_id for c in dht.lookup_stage(0, k=2)]
        dht.unpublish(8)
        found += [c.node_id for c in dht.lookup_stage(0)]
        out.append((leaders, found, dht.lookup_time_total,
                    dht.rng.bit_generator.state))
    assert out[0] == out[1]
    assert out[1][0] == [2, 5]
