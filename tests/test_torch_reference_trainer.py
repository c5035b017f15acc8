"""The port's frozen whole-model trainer against the JAX package's.

Both ``ReferenceDecentralizedTrainer``s plan on networks built from one
seed through their own copies of the flow layer, draw churn and crash
budgets from their numpy streams, and train the reduced ``gwtf-llama-300m``
over 2 stages on the same numpy batches, the port from the JAX trainer's
own initial parameters.  Over three iterations at churn 0 and 0.2 the
completed, launched and dropped counts are exactly equal and each
iteration's loss agrees within 2e-4 relative; the churn-0.2 run drops
microbatches, so the silent-drop path is on.
"""
import dataclasses

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs import get_config as jax_config
from repro.core.flow.graph import geo_distributed_network as j_network
from repro.core.runtime.reference import \
    ReferenceDecentralizedTrainer as JReference
from repro_torch.configs import get_config
from repro_torch.core.flow.graph import geo_distributed_network
from repro_torch.core.runtime.reference import ReferenceDecentralizedTrainer
from repro_torch.data.pipeline import DataConfig, DataNodeShard
from repro_torch.tree import tree_map
from repro_torch.weights import _to_tensor

S = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(get):
    return dataclasses.replace(get("gwtf-llama-300m").reduced(
        num_layers=4, d_model=128), vocab_size=256)


def _net(build, seed):
    return build(num_stages=S, relay_capacities=[2] * (3 * S),
                 num_data_nodes=2, data_capacity=4,
                 rng=np.random.default_rng(seed))


def _batches(net, it):
    return {d.id: DataNodeShard(DataConfig(
        vocab_size=256, seq_len=32, batch_size=8, microbatch_size=2,
        seed=100 * it + d.id), d.id, 2).microbatches() for d in net.data_nodes()}


@pytest.mark.parametrize("churn", [0.0, 0.2])
def test_reference_trainer_matches_jax(churn):
    jt = JReference(_cfg(jax_config), _net(j_network, 3), churn=churn,
                    lr=1e-3, seed=0)
    tt = ReferenceDecentralizedTrainer(_cfg(get_config),
                                       _net(geo_distributed_network, 3),
                                       churn=churn, lr=1e-3, seed=0,
                                       device="cpu")
    to_t = lambda tree: tree_map(  # noqa: E731
        lambda a: _to_tensor(a, "cpu"), jax.tree.map(np.asarray, tree))
    tt.stage_params = [to_t(p) for p in jt.stage_params]
    tt.head_params = {d: to_t(p) for d, p in jt.head_params.items()}
    dropped = 0
    for it in range(3):
        rj = jt.iteration(_batches(jt.net, it))
        rt = tt.iteration(_batches(tt.net, it))
        assert (rt.completed, rt.launched, rt.dropped) == (
            rj.completed, rj.launched, rj.dropped), it
        assert rt.completed > 0
        assert abs(rt.loss - rj.loss) <= 2e-4 * abs(rj.loss), (it, rt.loss,
                                                               rj.loss)
        dropped += rt.dropped
    assert tt.losses == [pytest.approx(x, rel=2e-4) for x in jt.losses]
    assert tt.rng.bit_generator.state == jt.rng.bit_generator.state
    assert (dropped > 0) == (churn > 0)


def test_reference_trainer_draws_the_cached_initial_parameters():
    """Without injected parameters, the port's draw (``cache.initial_params``),
    one head per data node from the same tree."""
    from repro_torch.core.runtime import cache
    cfg = _cfg(get_config)
    tt = ReferenceDecentralizedTrainer(cfg, _net(geo_distributed_network, 3),
                                       device="cpu")
    stage_p, head_p = cache.initial_params(cfg, S, 0, "cpu")
    assert all(a is b for a, b in zip(tt.stage_params, stage_p))
    assert all(h is head_p for h in tt.head_params.values())
