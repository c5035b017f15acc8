"""The port's staged trainer against the JAX package's, and its own
bit-identities.

Both ``RuntimeTrainer``s start from the JAX package's seeded parameters
(carried into the port by ``weights.initial_params_from_jax``), plan on
networks built from the same seed through their own copies of the flow
and sim layers, and train on the same numpy batches.  Over three
iterations at churn 0 and 0.2 (and with a bf16, int8 or top-k wire, and
for ``gwtf-gpt-300m``'s LayerNorm, GELU and tied embeddings), every counter
(completed, launched, dropped, rerouted, requeued, fwd_recomputes,
bwd_replays, wire_bytes), the dispatch snapshot and the ``FaultTimeline``
are exactly equal, and the losses agree within 2e-4 relative on the first
iteration and 1e-3 after (f32, reduced ``gwtf-llama-300m``); with bf16
params, as at full width, within 1e-3 on every iteration.  After the
third iteration, every stage and head tree and its AdamW moments are held
leaf by leaf against JAX's: the moments, which are linear in the
gradients each trainer aggregated, within a share of each leaf's largest
magnitude; the parameters within an absolute bound, since AdamW's first
steps move a weight by about lr times the sign of its gradient, and a
gradient near 0 may take either sign in the two frameworks.  A head
updated from another data node's gradients, or gradients summed twice,
move the moments far outside these bounds.

Inside the port, under ``torch.use_deterministic_algorithms(True)`` (the
embedding's backward accumulates in a nondeterministic order otherwise),
churn 0 equals ``CentralizedTrainer`` and the fused path equals remat,
bit for bit in losses and every parameter.
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
from repro_torch.core.runtime import cache
from repro_torch.core.runtime.trainer import (CentralizedTrainer,
                                              RuntimeTrainer, auto_chunk)
from repro_torch.core.sim.faults import TraceChurn
from repro_torch.data.pipeline import DataConfig, DataNodeShard
from repro_torch.tree import leaves
from repro_torch.weights import initial_params_from_jax

S = 2
COUNTERS = ("completed", "launched", "dropped", "rerouted", "requeued",
            "fwd_recomputes", "bwd_replays", "wire_bytes", "wire_codecs")
LOSS_RTOL = {"float32": (2e-4, 1e-3, 1e-3), "bfloat16": (1e-3, 1e-3, 1e-3)}
# (params absolute, moments relative to each leaf's largest magnitude),
# about twice the largest difference of a sound run (f32: 2.6e-4 and
# 1.7e-4; bf16 wire: 7.9e-3 and 5.2e-3; bf16 params: 1.5e-2 and 6.0e-2)
TREE_TOL = {"float32": (5e-4, 1e-3), "bf16 wire": (1.5e-2, 1e-2),
            "bfloat16": (3e-2, 0.12)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tests' tensors are tiny; under several test workers torch's
    default of one thread per core oversubscribes the host many times."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(param_dtype="float32", arch="gwtf-llama-300m"):
    return tuple(dataclasses.replace(
        get(arch).reduced(num_layers=4, d_model=128),
        vocab_size=256, param_dtype=param_dtype)
        for get in (jax_config, get_config))


def _net(build, seed, data_nodes=1):
    return build(num_stages=S, relay_capacities=[3] * (3 * S),
                 num_data_nodes=data_nodes, data_capacity=4,
                 rng=np.random.default_rng(seed))


def _mbs(seed=0, shard=0, shards=1):
    dc = DataConfig(vocab_size=256, seq_len=64, batch_size=8,
                    microbatch_size=2, seed=seed)
    return DataNodeShard(dc, shard, shards).microbatches()


def _from_jax(trainer, jcfg):
    """Start a port trainer from the JAX package's seeded parameters."""
    stage_p, head_p = initial_params_from_jax(
        trainer.cfg, jax.tree.map(np.asarray, jcache.initial_params(jcfg, S, 0)),
        device="cpu")
    trainer.stage_params = list(stage_p)
    trainer.head_params = {dn: head_p for dn in trainer.head_params}
    return trainer


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def _assert_trees_close(jtree, ttree, atol=None, rtol=None, what=""):
    """Leaf by leaf, in ``jax.tree`` order: within ``atol``, or within
    ``rtol`` of each JAX leaf's largest magnitude."""
    ja = [np.asarray(x, dtype=np.float32) for x in jax.tree.leaves(jtree)]
    ta = [x.float().numpy() for x in leaves(ttree)]
    assert len(ja) == len(ta), what
    for k, (a, b) in enumerate(zip(ja, ta)):
        assert a.shape == b.shape, (what, k)
        bound = atol if atol is not None else rtol * max(np.abs(a).max(), 1e-30)
        assert np.abs(a - b).max() <= bound, (what, k, np.abs(a - b).max(), bound)


def _same(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# the int8 wire's head parameters need the bf16 wire's bounds (int8 at
# 4.2e-3, ROADMAP Queue 3), the top-k wire and gwtf-gpt-300m f32's
@pytest.mark.parametrize("churn,wire,dtype,arch", [
    (0.0, None, "float32", "gwtf-llama-300m"),
    (0.2, None, "float32", "gwtf-llama-300m"),
    (0.2, "bf16", "float32", "gwtf-llama-300m"),
    (0.2, None, "bfloat16", "gwtf-llama-300m"),
    (0.2, None, "float32", "gwtf-gpt-300m"),
    (0.2, "int8", "float32", "gwtf-llama-300m"),
    (0.2, "topk", "float32", "gwtf-llama-300m")],
    ids=["0.0-None-float32", "0.2-None-float32", "0.2-bf16-float32",
         "0.2-None-bfloat16", "0.2-None-float32-gwtf-gpt-300m",
         "0.2-int8-float32", "0.2-topk-float32"])
def test_trainer_matches_jax(churn, wire, dtype, arch):
    jcfg, tcfg = _cfgs(dtype, arch)
    jt = JRuntimeTrainer(jcfg, _net(j_network, 3, 2), churn=churn, lr=3e-3,
                         seed=0, wire_codec=wire)
    tt = _from_jax(RuntimeTrainer(tcfg, _net(geo_distributed_network, 3, 2),
                                  churn=churn, lr=3e-3, seed=0,
                                  wire_codec=wire, device="cpu"), jcfg)
    dns = [d.id for d in tt.net.data_nodes()]
    shards = {dn: DataNodeShard(DataConfig(256, 64, 8, 2, seed=dn), k, 2)
              for k, dn in enumerate(dns)}
    repaired = 0
    for it in range(3):
        batches = {dn: shards[dn].microbatches() for dn in dns}
        rj, rt = jt.iteration(batches), tt.iteration(batches)
        for f in COUNTERS:
            assert getattr(rt, f) == getattr(rj, f), (it, f)
        assert abs(rt.loss - rj.loss) <= LOSS_RTOL[dtype][it] * abs(rj.loss), it
        assert tt.last_chains == jt.last_chains
        repaired += rt.rerouted
    assert tt.stages.snapshot() == jt.stages.snapshot()
    p_tol, m_tol = TREE_TOL["bf16 wire" if wire in ("bf16", "int8")
                            else dtype]
    _assert_trees_close(jt.stage_params, tt.stage_params, atol=p_tol,
                        what="stage params")
    _assert_trees_close(jt.head_params, tt.head_params, atol=p_tol,
                        what="head params")
    for name, jopt, topt in (("stage", jt.stage_opt, tt.stage_opt),
                             ("head", jt.head_opt, tt.head_opt)):
        jopt = jopt if isinstance(jopt, list) else [jopt[k] for k in sorted(jopt)]
        topt = topt if isinstance(topt, list) else [topt[k] for k in sorted(topt)]
        assert [int(o.step) for o in jopt] == [int(o.step) for o in topt]
        for field in ("m", "v"):
            _assert_trees_close([getattr(o, field) for o in jopt],
                                [getattr(o, field) for o in topt],
                                rtol=m_tol, what=f"{name} {field}")
    assert ([vars(r) for r in tt.timeline.records]
            == [vars(r) for r in jt.timeline.records])
    if churn:
        assert repaired > 0 and tt.timeline.records   # churn struck
    if wire:
        assert rt.wire_bytes > 0
    assert tt.losses[-1] < tt.losses[0]


@pytest.mark.parametrize("kw", [{}, {"dispatch_chunk": 2},
                                {"wire_codec": "bf16"}])
def test_zero_churn_bit_identical_to_centralized(deterministic, kw):
    _, tcfg = _cfgs()
    mbs = _mbs()
    net = _net(geo_distributed_network, 0)
    dn = net.data_nodes()[0].id
    rt = RuntimeTrainer(tcfg, net, lr=3e-3, seed=0,
                        churn_model=TraceChurn([]), device="cpu", **kw)
    cen = CentralizedTrainer(tcfg, S, lr=3e-3, seed=0, device="cpu", **kw)
    for _ in range(3):
        assert rt.iteration({dn: mbs}).loss == cen.iteration(mbs)
    assert _same(rt.stage_params, cen.stage_params)
    assert _same(rt.stage_opt, cen.stage_opt)
    assert _same(rt.head_params[dn], cen.head_params)
    assert rt.last_wire_bytes == cen.last_wire_bytes
    if "dispatch_chunk" in kw:
        assert rt.stages.fwd_calls == cen.stages.fwd_calls == [6, 6]


@pytest.mark.parametrize("batched", [True, False])
def test_fused_and_remat_trainers_bit_identical(deterministic, batched):
    _, tcfg = _cfgs()
    mbs = _mbs()
    dn = _net(geo_distributed_network, 0).data_nodes()[0].id
    runs = {remat: RuntimeTrainer(
        tcfg, _net(geo_distributed_network, 0), lr=3e-3, seed=0,
        churn_model=TraceChurn([]), remat=remat, batch_microbatches=batched,
        device="cpu") for remat in (False, True)}
    for _ in range(3):
        rf, rr = (runs[m].iteration({dn: mbs}) for m in (False, True))
        assert rf.loss == rr.loss
    fused, remat = runs[False], runs[True]
    assert fused.stages.snapshot()["fwd"] == remat.stages.snapshot()["fwd"]
    assert fused.stages.snapshot()["bwd"] == remat.stages.snapshot()["bwd"]
    assert fused.stages.remat_recompute_count == 0
    assert remat.stages.remat_recompute_count == sum(remat.stages.bwd_calls)
    assert _same(fused.stage_params, remat.stage_params)
    assert _same(fused.head_params, remat.head_params)
    assert fused.last_store_peak_bytes > remat.last_store_peak_bytes


def test_initial_params_cache_not_mutated_by_training():
    _, tcfg = _cfgs()
    before = [t.clone() for t in leaves(cache.initial_params(tcfg, S, 0, "cpu"))]
    net = _net(geo_distributed_network, 0)
    tr = RuntimeTrainer(tcfg, net, lr=3e-3, seed=0,
                        churn_model=TraceChurn([]), device="cpu")
    tr.iteration({net.data_nodes()[0].id: _mbs()})
    after = leaves(cache.initial_params(tcfg, S, 0, "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert not _same(tr.stage_params, list(cache.initial_params(
        tcfg, S, 0, "cpu")[0]))
    assert cache.cache_info()["initial_params"]["hits"] >= 1


def test_auto_chunk_rule():
    assert auto_chunk(32, 1, 32, 128) == 4
    assert auto_chunk(2, 1, 32, 128) == 2
    assert auto_chunk(8, 2, 512, 512) == 1
    assert auto_chunk(0, 1, 32, 128) >= 1
    # full-width gwtf-llama-300m: 4 x 512 x 1024 bf16 = 4 MB a microbatch
    assert auto_chunk(4, 4, 512, 1024, itemsize=2) == 1
