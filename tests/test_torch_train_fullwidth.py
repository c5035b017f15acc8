"""The port's trainer against the JAX package's at the full width of
``gwtf-llama-300m``: d_model 1024, 16 heads of 64, d_ff 2816, vocab
32000 and bf16 params, with its depth cut to 2 layers over 2 stages.

Sequences of 1024 tokens take the paths that the reduced tests do not:
the loss in two chunks of 512 (``chunked_xent_loss``) and attention in
two 512-query blocks (``_online_attention``).  Both trainers start from
the JAX package's seeded parameters and train three iterations at churn
0 and lr 1e-3 on the same batches.  Their counters are equal, each loss
agrees within 1e-3 relative (as the reduced bf16 test), and the AdamW
moments within 0.06 of each leaf's largest magnitude (a sound run's
largest: 1.1e-4 relative on the losses, 0.027 on the moments).  Run with
``-s`` to see both loss trajectories.
"""
import dataclasses

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs import get_config as jax_config
from repro.core.flow.graph import geo_distributed_network as j_network
from repro.core.runtime import cache as jcache
from repro.core.runtime.trainer import RuntimeTrainer as JRuntimeTrainer
from repro_torch.configs import get_config
from repro_torch.core.flow.graph import geo_distributed_network
from repro_torch.core.runtime.trainer import RuntimeTrainer
from repro_torch.data.pipeline import DataConfig, DataNodeShard
from repro_torch.tree import leaves
from repro_torch.weights import initial_params_from_jax

S = 2
SEQ = 1024
LOSS_RTOL = 1e-3
MOMENT_RTOL = 0.06
COUNTERS = ("completed", "launched", "dropped", "rerouted", "requeued",
            "fwd_recomputes", "bwd_replays", "wire_bytes")


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """One large test: two threads, not one per core, under several test
    workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _net(build):
    return build(num_stages=S, relay_capacities=[2] * S, num_data_nodes=1,
                 data_capacity=2, rng=np.random.default_rng(0))


def test_full_width_trainer_matches_jax():
    jcfg, tcfg = (dataclasses.replace(get("gwtf-llama-300m"), num_layers=2)
                  for get in (jax_config, get_config))
    assert (tcfg.d_model, tcfg.vocab_size, tcfg.param_dtype) == (
        1024, 32000, "bfloat16")
    jt = JRuntimeTrainer(jcfg, _net(j_network), lr=1e-3, seed=0)
    tt = RuntimeTrainer(tcfg, _net(geo_distributed_network), lr=1e-3, seed=0,
                        device="cpu")
    stage_p, head_p = initial_params_from_jax(
        tcfg, jax.tree.map(np.asarray, jcache.initial_params(jcfg, S, 0)),
        device="cpu")
    tt.stage_params = list(stage_p)
    tt.head_params = {dn: head_p for dn in tt.head_params}
    dn = tt.net.data_nodes()[0].id
    shard = DataNodeShard(DataConfig(vocab_size=32000, seq_len=SEQ,
                                     batch_size=2, microbatch_size=1, seed=0),
                          0, 1)
    for it in range(3):
        batches = {dn: shard.microbatches()}
        rj, rt = jt.iteration(batches), tt.iteration(batches)
        print(f"iteration {it}: loss jax {rj.loss:.6f} port {rt.loss:.6f}")
        for f in COUNTERS:
            assert getattr(rt, f) == getattr(rj, f), (it, f)
        assert rt.completed == 2
        assert abs(rt.loss - rj.loss) <= LOSS_RTOL * abs(rj.loss), it
    for jopt, topt in ((jt.stage_opt, tt.stage_opt),
                       (jt.head_opt[dn], tt.head_opt[dn])):
        for field in ("m", "v"):
            ja = jax.tree.leaves(jax.tree.map(
                lambda o: getattr(o, field), jopt,
                is_leaf=lambda o: hasattr(o, field)))
            ta = leaves([getattr(o, field) for o in topt]
                        if isinstance(topt, list) else getattr(topt, field))
            assert len(ja) == len(ta)
            for a, b in zip(ja, ta):
                a = np.asarray(a, dtype=np.float32)
                err = np.abs(a - b.float().numpy()).max()
                assert err <= MOMENT_RTOL * np.abs(a).max(), (field, err)
