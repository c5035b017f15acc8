"""Moonlight's layers in the port against the benchmark's plain reference
(``perfbench/reference/mla_moe.py``: the published equations in f32, no
kernel or batching, importing nothing of the port), at a reduced size on
the CPU, with every leaf drawn from a seed (``perfbench/weights.py``:
norm scales 1 + 0.1 n, biases 0.02 n, so that a path that drops a norm or
adds the choice's bias into the weights reads wrong).

* one MLA layer, one sigmoid-routed MoE layer (token-routed and dense
  experts) and a 3-layer Moonlight-shaped model through the staged path (1
  dense + 2 MoE layers, d_model 128, 8 experts top 2, 1 shared): outputs,
  losses and every gradient;
* the token-routed experts equal to the dense ones for reduced
  ``qwen2-moe-a2.7b`` and ``granite-moe-3b-a800m``;
* ``RuntimeTrainer`` at churn 0.2 on the 3-layer model over 3 iterations
  against the reference's GWTF trainer on the microbatches it completed;
* the serving, sharded-step and dry-run paths refuse latent attention;
  the stage trees fit the fused AdamW's table; ``param_count`` counts the
  leaves.

Tolerances: both sides compute in f32 on the CPU and differ only in the
order of their sums (the port attends over query blocks and puts the
routed pairs through sorted groups; the reference takes one softmax and
loops over the experts), so outputs agree to 1e-5 relative (atol 1e-6) and each gradient
entry to 1e-4 relative or 1e-5 of its leaf's largest entry (where a sum
of terms cancels to near nothing, the rounding of the terms remains).
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import weights  # noqa: E402
from perfbench.reference import dense as RD  # noqa: E402
from perfbench.reference import mla_moe as RM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.flow.graph import geo_distributed_network  # noqa: E402
from repro_torch.core.runtime.stages import (embed_fn, init_head_params,  # noqa: E402
                                             init_stage_params, loss_fn,
                                             stage_forward)
from repro_torch.core.runtime.trainer import RuntimeTrainer  # noqa: E402
from repro_torch.data.pipeline import DataConfig, DataNodeShard  # noqa: E402
from repro_torch.kernels.adamw import MAX_LEAVES  # noqa: E402
from repro_torch.models import mla as TMLA  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

SEED = 2**31 + 77
OUT = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5       # the atol a share of the leaf's largest


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(num_layers: int = 3):
    """Moonlight's mechanisms at d_model 128: 1 dense layer, then MoE layers
    of 8 experts (top 2, 1 shared)."""
    return dataclasses.replace(
        get_config("moonlight-16b-a3b"), num_layers=num_layers, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=48, d_ff=64, vocab_size=256, num_experts=8,
        num_experts_per_tok=2, num_shared_experts=1, dense_d_ff=256, kv_lora_rank=64,
        qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32, param_dtype="float32",
        remat=False)


def _grad_leaves(tree):
    for t in leaves(tree):
        t.requires_grad_()
    return tree


def _close_grads(got_tree, want_tree, prefix=""):
    got = weights.flat(got_tree, prefix)
    want = weights.flat(want_tree, prefix)
    assert got.keys() == want.keys()
    for k in got:
        g = got[k].grad if got[k].grad is not None else torch.zeros_like(got[k])
        w = want[k].grad if want[k].grad is not None else torch.zeros_like(want[k])
        torch.testing.assert_close(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * float(w.abs().max()), msg=k)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone().requires_grad_()
            for k, v in tree.items()}


def test_mla_layer_matches_the_reference():
    cfg = _cfg()
    p = _grad_leaves(weights.like(TMLA.init_mla(torch.Generator(), cfg, torch.float32, "cpu"),
                                  "attn", SEED))
    q = _clone(p)
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(1))
    r = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(2))
    got = TMLA.apply_mla(p, x, cfg, positions=torch.arange(24))
    with RD.tf32_off():
        want = RM.attention(q, x, dataclasses.asdict(cfg), RD.F32)
    torch.testing.assert_close(got, want, **OUT)
    (got * r).sum().backward()
    (want * r).sum().backward()
    _close_grads(p, q)


@pytest.mark.parametrize("impl", ["ragged", "dense"])
def test_sigmoid_moe_layer_matches_the_reference(impl):
    cfg = _cfg()
    p = _grad_leaves(weights.like(TM.init_moe(torch.Generator(), cfg, torch.float32, "cpu"),
                                  "moe", SEED))
    assert float(p["bias"].detach().abs().max()) > 0       # drawn away from 0
    q = _clone(p)
    x = torch.randn(3, 16, cfg.d_model, generator=torch.Generator().manual_seed(3))
    r = torch.randn(3, 16, cfg.d_model, generator=torch.Generator().manual_seed(4))
    got, _ = TM.apply_moe(p, x, cfg, impl=impl)
    with RD.tf32_off():
        want = RM.moe(q, x, dataclasses.asdict(cfg), RD.F32)
    torch.testing.assert_close(got, want, **OUT)
    (got * r).sum().backward()
    (want * r).sum().backward()
    _close_grads(p, q)
    assert p["bias"].grad is None                          # only the choice reads it


def test_the_choice_bias_moves_the_choice_not_the_weights():
    """A bias that lifts one expert over all others routes every token to
    it, at the weight its score gives, not the bias's."""
    cfg = dataclasses.replace(_cfg(), num_shared_experts=0, num_experts_per_tok=1)
    p = weights.like(TM.init_moe(torch.Generator(), cfg, torch.float32, "cpu"), "moe", SEED)
    x = torch.randn(1, 8, cfg.d_model, generator=torch.Generator().manual_seed(5))
    p["bias"] = torch.zeros(cfg.num_experts)
    p["bias"][3] = 10.0
    _, topi, topv, _ = TM._route(p, x[0], cfg)
    assert (topi == 3).all()
    torch.testing.assert_close(topv, torch.full_like(topv, cfg.routed_scaling_factor))


def _stage_model(cfg, num_stages=1):
    g = torch.Generator().manual_seed(0)
    stages = [_grad_leaves(weights.like(init_stage_params(cfg, s, num_stages, g), f"stage{s}",
                                        SEED)) for s in range(num_stages)]
    head = _grad_leaves(weights.like(init_head_params(cfg, g), "head", SEED))
    return stages, head


def test_three_layer_model_through_the_stage_matches_the_reference():
    cfg = _cfg()
    (stage,), head = _stage_model(cfg)
    assert sorted(stage) == ["dense", "moe"]
    assert stage["dense"]["mlp"]["w_up"].shape == (1, 128, 256)
    assert stage["moe"]["moe"]["w_up"].shape == (2, 8, 128, 64)
    ref_stage, ref_head = _clone(stage), _clone(head)
    tokens = torch.randint(0, 256, (2, 33), generator=torch.Generator().manual_seed(6))
    x = stage_forward(stage, embed_fn(head, tokens[:, :-1]), cfg)
    got = loss_fn(head, x, tokens[:, 1:], cfg)
    raw = dataclasses.asdict(cfg)
    layers = [("dense", p) for p in RM._unstack(ref_stage["dense"], 1)]
    layers += [("moe", p) for p in RM._unstack(ref_stage["moe"], 2)]
    with RD.tf32_off():
        want = RM.loss(layers, ref_head, tokens[:, :-1], tokens[:, 1:], raw, RD.F32)
    torch.testing.assert_close(got, want, **OUT)
    got.backward()
    want.backward()
    _close_grads(stage, ref_stage)
    _close_grads(head, ref_head)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-moe-3b-a800m"])
def test_token_routed_experts_equal_the_dense_ones(arch):
    cfg = get_config(arch).reduced(num_layers=2, d_model=128, max_experts=16)
    p = _grad_leaves(weights.like(TM.init_moe(torch.Generator(), cfg, torch.float32, "cpu"),
                                  "moe", SEED))
    q = _clone(p)
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator().manual_seed(7))
    r = torch.randn(2, 32, cfg.d_model, generator=torch.Generator().manual_seed(8))
    got, aux_r = TM.apply_moe(p, x, cfg, impl="ragged")
    want, aux_d = TM.apply_moe(q, x, cfg, impl="dense")
    torch.testing.assert_close(got, want, **OUT)
    assert float(aux_r.detach()) == float(aux_d.detach())
    (got * r).sum().backward()
    (want * r).sum().backward()
    _close_grads(p, q)


def test_runtime_trainer_under_churn_follows_the_reference():
    cfg = _cfg()
    net = geo_distributed_network(num_stages=2, relay_capacities=[4] * 6, num_data_nodes=2,
                                  data_capacity=4, rng=np.random.default_rng(3))
    tr = RuntimeTrainer(cfg, net, churn=0.2, lr=1e-3, seed=3, device="cpu")
    opt = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
           "grad_clip": 1.0}
    start = {f"stage{s}": weights.flat(p, "") for s, p in enumerate(tr.stage_params)}
    start.update({f"head{dn}": weights.flat(p, "") for dn, p in tr.head_params.items()})
    start = {n: {k[1:]: t.detach().float().clone() for k, t in tree.items()}
             for n, tree in start.items()}
    done = []
    resolve = tr.recovery.resolve

    def recording(*a, **k):
        res = resolve(*a, **k)
        done.append([job.mb for job in res.completed])
        return res
    tr.recovery.resolve = recording
    dns = sorted(tr.head_params)
    shards = {dn: DataNodeShard(DataConfig(256, 32, 8, 2, seed=dn), k, 2)
              for k, dn in enumerate(dns)}
    ref = RM.Trainer(dataclasses.asdict(cfg), start, opt, 2)
    owner = {}
    results = []
    for it in range(3):
        batches = {dn: shards[dn].microbatches() for dn in dns}
        owner.update({id(mb): dn for dn, mbs in batches.items() for mb in mbs})
        r = tr.iteration(batches)
        results.append(r)
        completed = [(owner[id(mb)], torch.as_tensor(mb["tokens"]).long(),
                      torch.as_tensor(mb["labels"]).long()) for mb in done[-1]]
        assert len(completed) == r.completed
        with RD.tf32_off():
            loss, _ = ref.iteration(completed)
        if completed:
            assert abs(r.loss - loss) <= 1e-4 * abs(loss), it
    assert sum(r.rerouted for r in results) > 0            # the churn was repaired
    for s, p in enumerate(tr.stage_params):
        for k, t in weights.flat(p, "").items():
            name = f"stage{s}"
            got = float(torch.linalg.vector_norm(t.detach() - start[name][k[1:]]))
            want = float(torch.linalg.vector_norm(ref.trees[name][k[1:]].detach()
                                                  - start[name][k[1:]]))
            assert abs(got - want) <= 1e-3 * max(want, 1e-6), (name, k)


def test_serving_and_sharded_paths_refuse_latent_attention():
    from repro_torch.launch import dryrun, serve, steps
    from repro_torch.models.config import INPUT_SHAPES
    from repro_torch.models.transformer import init_cache, init_params
    cfg = _cfg()
    with pytest.raises(NotImplementedError, match="latent attention"):
        init_cache(cfg, 1, 8, device="cpu")
    model = init_params(cfg, torch.Generator(), "cpu")
    with pytest.raises(NotImplementedError, match="init_cache"):
        serve.generate(model, cfg, torch.zeros((1, 4), dtype=torch.long), gen=1, window=None,
                       temperature=0.0, generator=None)
    with pytest.raises(NotImplementedError, match="dry run"):
        dryrun.run_one("moonlight-16b-a3b", INPUT_SHAPES["train_4k"], multi_pod=False,
                       device="cpu", cfg=cfg, verbose=False)
    with pytest.raises(NotImplementedError, match="train step"):
        steps.make_train_step(cfg)


def test_moonlight_stage_trees_fit_the_adamw_table_and_counts_hold():
    cfg = dataclasses.replace(get_config("moonlight-16b-a3b"), num_layers=5)
    g = torch.Generator()
    trees = [init_stage_params(cfg, s, 2, g, "meta") for s in range(2)]
    head = init_head_params(cfg, g, "meta")
    assert [len(leaves(t)) for t in trees + [head]] == [25, 15, 3]
    assert all(len(leaves(t)) <= MAX_LEAVES for t in trees + [head])
    total = sum(t.numel() for tree in trees + [head] for t in leaves(tree))
    # param_count leaves out the final norm's scale
    assert cfg.param_count() == total - cfg.d_model
    full = get_config("moonlight-16b-a3b")
    assert 15.9e9 < full.param_count() < 16.0e9
