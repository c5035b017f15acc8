"""Stage-local recovery, requeue, checkpoints, codecs and the gradient
screen of the port's trainer, held against the JAX package's where the
two must agree exactly.

A scripted crash trace drives both packages' trainers: a backward crash
replays exactly one stage (from the stored residuals, no forward
recompute) and a forward crash recomputes exactly one stage, with every
dispatch counter equal to the JAX package's.  Requeue, drop, checkpoint
resume and the rejoin bootstrap behave as in ``tests/test_runtime.py``;
the int8 store and the bf16 wire stay within the JAX tests' loss bounds;
a zeroing or a perturbing adversary (norm outliers by orders of
magnitude, so float differences cannot move the decision) is flagged
exactly as the JAX screen flags it, and a sign-flipping one is missed by
both at this size.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.flow.graph import geo_distributed_network as j_network
from repro.core.runtime import cache as jcache
from repro.core.runtime.trainer import RuntimeTrainer as JRuntimeTrainer
from repro.core.sim.faults import CorruptGradientChurn as JCorrupt
from repro.core.sim.faults import TraceChurn as JTraceChurn
from repro_torch.configs import get_config
from repro_torch.core.executor import DecentralizedTrainer
from repro_torch.core.flow.graph import geo_distributed_network
from repro_torch.core.runtime.trainer import RuntimeTrainer
from repro_torch.core.sim.faults import CorruptGradientChurn, TraceChurn
from repro_torch.core.sim.policies import FixedPolicy
from repro_torch.data.pipeline import DataConfig, DataNodeShard
from repro_torch.tree import leaves
from repro_torch.weights import initial_params_from_jax

S = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tests' tensors are tiny; under several test workers torch's
    default of one thread per core oversubscribes the host many times."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(layers=4, d_model=128, vocab=256):
    return tuple(dataclasses.replace(
        get(name).reduced(num_layers=layers, d_model=d_model),
        vocab_size=vocab) for get, name in ((jax_config, "gwtf-llama-300m"),
                                            (get_config, "gwtf-llama-300m")))


def _net(build=geo_distributed_network, seed=0):
    return build(num_stages=S, relay_capacities=[3] * (3 * S),
                 num_data_nodes=1, data_capacity=4,
                 rng=np.random.default_rng(seed))


def _mbs(seed=0):
    dc = DataConfig(vocab_size=256, seq_len=64, batch_size=8,
                    microbatch_size=2, seed=seed)
    return DataNodeShard(dc, 0, 1).microbatches()


def _from_jax(trainer, jcfg):
    stage_p, head_p = initial_params_from_jax(
        trainer.cfg, jax.tree.map(np.asarray,
                                  jcache.initial_params(jcfg, S, 0)),
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


def _run_with_trace(pick, crash_at, **kw):
    """Healthy and traced trainers of both packages on one seed; the
    traced ones crash the relay ``pick`` chooses from the healthy port
    run's first completed chain at ``crash_at``."""
    jcfg, tcfg = _cfgs()
    mbs = _mbs(1)
    dn = _net(seed=1).data_nodes()[0].id
    base = _from_jax(RuntimeTrainer(tcfg, _net(seed=1), lr=3e-3, seed=0,
                                    churn_model=TraceChurn([]), device="cpu",
                                    **kw), jcfg)
    rb = base.iteration({dn: mbs})
    relay = pick(base.last_resolution.completed[0].chain)
    events = [(0, "crash", relay, crash_at)]
    tr = _from_jax(RuntimeTrainer(tcfg, _net(seed=1), lr=3e-3, seed=0,
                                  churn_model=TraceChurn(events),
                                  device="cpu", **kw), jcfg)
    jt = JRuntimeTrainer(jcfg, _net(j_network, 1), lr=3e-3, seed=0,
                         churn_model=JTraceChurn(events), **kw)
    rt, rj = tr.iteration({dn: mbs}), jt.iteration({dn: mbs})
    return base, rb, tr, rt, jt, rj, relay


@pytest.mark.parametrize("batched", [True, False])
def test_backward_crash_replays_exactly_one_stage(batched):
    base, rb, tr, rt, jt, rj, relay = _run_with_trace(
        lambda chain: chain[2], 0.6, batch_microbatches=batched)
    hit = sum(1 for j in base.last_resolution.completed if j.chain[2] == relay)
    assert hit >= 1
    assert rt.completed == rt.launched
    assert rt.bwd_replays == rj.bwd_replays == hit
    assert rt.fwd_recomputes == rj.fwd_recomputes == 0
    b, t = base.stages, tr.stages
    assert t.bwd_calls[1] - b.bwd_calls[1] == hit
    assert t.bwd_calls[0] == b.bwd_calls[0]
    assert t.fwd_calls == b.fwd_calls
    assert t.remat_recompute_count == 0
    assert t.stage_dispatches - b.stage_dispatches == hit
    assert t.snapshot() == jt.stages.snapshot()
    assert rt.loss == rb.loss                 # recovery is numerically invisible
    assert abs(rt.loss - rj.loss) <= 2e-4 * abs(rj.loss)


def test_forward_crash_recomputes_exactly_one_stage():
    base, rb, tr, rt, jt, rj, relay = _run_with_trace(
        lambda chain: chain[1], 0.1)
    hit = sum(1 for j in base.last_resolution.completed if j.chain[1] == relay)
    assert hit >= 1
    assert rt.completed == rt.launched
    assert rt.fwd_recomputes == rj.fwd_recomputes == hit
    assert rt.bwd_replays == 0
    b, t = base.stages, tr.stages
    assert t.fwd_calls[0] - b.fwd_calls[0] == hit
    assert t.fwd_calls[1] == b.fwd_calls[1]
    assert t.bwd_calls == b.bwd_calls
    assert t.snapshot() == jt.stages.snapshot()
    assert rt.loss == rb.loss
    for job in tr.last_resolution.completed:
        assert job.chain[1] != relay


def _fixed_net():
    """2 stages x 2 relays, 1 data node: ids 0=dn, 1-2=stage0, 3-4=stage1."""
    return geo_distributed_network(
        num_stages=2, relay_capacities=[1, 1, 1, 1], num_data_nodes=1,
        data_capacity=2, rng=np.random.default_rng(7))


@pytest.mark.parametrize("crashed,completed", [((1,), 1), ((1, 2), 0)])
def test_requeue_instead_of_drop(crashed, completed):
    _, tcfg = _cfgs()
    net = _fixed_net()
    tr = RuntimeTrainer(tcfg, net, lr=3e-3, seed=0, device="cpu",
                        policy=FixedPolicy(net, [[0, 1, 3, 0], [0, 2, 4, 0]]),
                        churn_model=TraceChurn([(0, "crash", n, 0.1)
                                                for n in crashed]))
    r = tr.iteration({0: _mbs(3)[:1]})
    assert r.launched == 1 and r.completed == completed
    assert r.dropped == 1 - completed
    assert r.requeued == r.rerouted == completed
    if completed:
        assert tr.last_resolution.completed[0].chain == [0, 2, 4, 0]


def test_checkpoint_resume_round_trip(tmp_path, deterministic):
    _, tcfg = _cfgs()
    mbs = _mbs(4)
    net = _net(seed=4)
    dn = net.data_nodes()[0].id
    tr = DecentralizedTrainer(tcfg, net, churn=0.0, lr=3e-3, seed=0,
                              checkpoint_dir=str(tmp_path),
                              checkpoint_every=2, device="cpu")
    tr.iteration({dn: mbs})
    tr.iteration({dn: mbs})                   # snapshot written at step 2
    fresh = DecentralizedTrainer(tcfg, _net(seed=4), churn=0.0, lr=3e-3,
                                 seed=0, device="cpu")
    assert fresh.restore_checkpoint(str(tmp_path)) == 2
    for a, b in zip(leaves((fresh.stage_params, fresh.stage_opt,
                            fresh.head_params, fresh.head_opt)),
                    leaves((tr.stage_params, tr.stage_opt, tr.head_params,
                            tr.head_opt))):
        assert torch.equal(a, b)
    assert tr.iteration({dn: mbs}).loss == fresh.iteration({dn: mbs}).loss


def test_rejoining_node_bootstraps_from_stage_snapshot(tmp_path):
    _, tcfg = _cfgs()
    net = _net(seed=5)
    dn = net.data_nodes()[0].id
    relay = [n.id for n in net.nodes.values() if not n.is_data][0]
    tr = DecentralizedTrainer(
        tcfg, net, lr=3e-3, seed=0, device="cpu",
        churn_model=TraceChurn([(0, "crash", relay, 0.95),
                                (2, "rejoin", relay)]),
        checkpoint_dir=str(tmp_path), checkpoint_every=1)
    for _ in range(3):
        tr.iteration({dn: _mbs(5)})
    assert tr.joins_bootstrapped == 1
    assert net.nodes[relay].alive


def test_int8_store_and_bf16_wire_within_jax_bounds():
    """The JAX tests' bounds: the int8 store at least 3x smaller with a
    loss within 0.25 of the exact run (``test_fused_runtime.py``); the
    bf16 wire's bytes exact and its loss within 0.1
    (``test_wire_codecs.py``); both still train."""
    _, tcfg = _cfgs()
    mbs = _mbs()
    dn = _net().data_nodes()[0].id
    runs = {kw: RuntimeTrainer(tcfg, _net(), lr=3e-3, seed=0, device="cpu",
                               churn_model=TraceChurn([]), **dict([kw]))
            for kw in (("activation_codec", "fp"),
                       ("activation_codec", "int8"), ("wire_codec", "bf16"))}
    for _ in range(3):
        res = {kw: t.iteration({dn: mbs}) for kw, t in runs.items()}
    fp = res[("activation_codec", "fp")]
    q8 = res[("activation_codec", "int8")]
    bf = res[("wire_codec", "bf16")]
    assert fp.store_peak_bytes / q8.store_peak_bytes >= 3.0
    assert abs(q8.loss - fp.loss) < 0.25
    assert bf.wire_codecs == ("bf16",) and fp.wire_bytes == 0
    assert bf.wire_bytes == bf.completed * 2 * 64 * tcfg.d_model * 2
    assert abs(bf.loss - fp.loss) < 0.1
    for t in runs.values():
        assert t.losses[-1] < t.losses[0]


@pytest.mark.parametrize("mode", ["zero", "perturb", "sign_flip"])
def test_gradient_screen_flags_what_jax_flags(mode):
    """A corrupt relay on one chain of four whose gradients are zeroed or
    swamped in unit noise: the port's screen flags the same contributions
    and accuses the same node as the JAX screen, iteration for iteration.
    Sign-flipped gradients pass both screens at this size (their
    leave-one-out cosine stays above the -0.1 threshold)."""
    jcfg, tcfg = _cfgs(layers=2, d_model=32, vocab=512)
    caps = [2, 1, 2, 2, 2, 2]
    runs = []
    for build, trainer, corrupt, extra in (
            (j_network, JRuntimeTrainer, JCorrupt, {}),
            (geo_distributed_network, RuntimeTrainer, CorruptGradientChurn,
             {"device": "cpu"})):
        net = build(num_stages=2, relay_capacities=caps, num_data_nodes=1,
                    data_capacity=4, rng=np.random.default_rng(0))
        t = trainer(jcfg if trainer is JRuntimeTrainer else tcfg, net,
                    lr=1e-3, seed=0, churn_model=corrupt(
                        [2], mode=mode, seed=7, known_ids=net.nodes.keys()),
                    **extra)
        if trainer is RuntimeTrainer:
            _from_jax(t, jcfg)
        runs.append(t)
    dc = DataConfig(vocab_size=512, seq_len=16, batch_size=4,
                    microbatch_size=1, seed=3)
    shard = DataNodeShard(dc, 0, 1)
    flagged = 0
    for _ in range(2):
        batches = {0: shard.microbatches()}
        rj, rt = (t.iteration(batches) for t in runs)
        assert rt.grads_flagged == rj.grads_flagged
        assert rt.completed == rj.completed
        flagged += rt.grads_flagged
    assert flagged == 0 if mode == "sign_flip" else flagged >= 1
    assert ([vars(r) for r in runs[1].timeline.records]
            == [vars(r) for r in runs[0].timeline.records])
    assert runs[1].net.quarantined(2) == runs[0].net.quarantined(2)
