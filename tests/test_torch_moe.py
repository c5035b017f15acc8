"""The port's MoE layer and MoE models against the JAX package's.

* ``apply_moe`` in its three implementations (dense, ragged, capacity) on
  the same numpy weights and inputs as ``repro.models.moe.apply_moe``, on
  reduced ``granite-moe-3b-a800m`` (top-8) and ``qwen2-moe-a2.7b`` (top-4
  and a shared expert): outputs within the f32 tolerance (2e-4), the
  auxiliary loss within 1e-6, the routing (top-k indices) equal.  The
  configs keep 16 experts (``reduced(max_experts=16)``): at the default 4,
  granite's top-8 would take every expert and route nothing.  The inputs
  overflow no expert's capacity, where the two packages' capacity paths
  agree (see ``test_capacity_overflow_drops_only_the_overflow``).
* greedy decode of both reduced models from JAX's parameters: prefill and
  step logits within 2e-4, token streams equal;
* bf16 MoE leaves, ``shared`` included, load bit for bit under their JAX
  names;
* the staged runtime trains a reduced MoE model as JAX's does (JAX's
  stage runs the dense experts, the port's the token-routed ones, the same
  function; both drop the auxiliary loss): counters, chains and timelines
  equal, losses within the trainer tests' tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs import get_config as jax_config
from repro.core.flow.graph import geo_distributed_network as j_network
from repro.core.runtime.serving import serving_inputs as jax_serving_inputs
from repro.core.runtime.trainer import RuntimeTrainer as JRuntimeTrainer
from repro.models import moe as JM
from repro_torch.configs import get_config
from repro_torch.core.flow.graph import geo_distributed_network
from repro_torch.core.runtime.trainer import RuntimeTrainer
from repro_torch.data.pipeline import DataConfig, DataNodeShard
from repro_torch.models import moe as TM
from repro_torch.weights import params_from_jax
from test_torch_serve import LOGITS, _run_both
from test_torch_train import COUNTERS, LOSS_RTOL, _from_jax, _net

MOE_ARCHS = ["granite-moe-3b-a800m", "qwen2-moe-a2.7b"]
F32 = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _layer(arch, tokens=32, seed=0):
    """Both configs, JAX's f32 weights, the port's copy of them, and x."""
    jcfg = jax_config(arch).reduced(max_experts=16)
    tcfg = get_config(arch).reduced(max_experts=16)
    p = JM.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    pt = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    x = np.random.default_rng(seed).standard_normal(
        (2, tokens // 2, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, p, pt, x


@pytest.mark.parametrize("impl", ["dense", "ragged", "capacity"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_matches_jax(arch, impl):
    jcfg, tcfg, p, pt, x = _layer(arch)
    want, want_aux = JM.apply_moe(p, jnp.asarray(x), jcfg, impl=impl)
    got, aux = TM.apply_moe(pt, torch.from_numpy(x), tcfg, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    xt = x.reshape(-1, jcfg.d_model)
    _, jtopi, jtopv, _ = JM._route(p, jnp.asarray(xt), jcfg)
    _, topi, topv, _ = TM._route(pt, torch.from_numpy(xt), tcfg)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
    np.testing.assert_allclose(topv.numpy(), np.asarray(jtopv), rtol=1e-6,
                               atol=1e-6)
    # no expert takes more than the capacity path's C: its rows all count
    T, k, E = xt.shape[0], tcfg.num_experts_per_tok, tcfg.num_experts
    assert np.bincount(np.asarray(jtopi).ravel(), minlength=E).max() <= max(
        8, int(2.0 * T * k / E))


def test_capacity_overflow_drops_only_the_overflow():
    """32 equal tokens all pick the same 4 of qwen2-moe's 16 experts, whose
    capacity is C = 2 * 32 * 4 / 16 = 16: the first 16 tokens keep every
    routed expert (the dense path's rows), the other 16 keep only the
    shared expert.  (JAX's path writes the dropped pairs as zeros into
    slot 0 of their experts, where its scatter may zero the first kept
    token: ``TM._expert_mlp_capacity``'s docstring.)"""
    _, tcfg, _, pt, x = _layer("qwen2-moe-a2.7b")
    xs = torch.from_numpy(np.repeat(x[:1, :1], 32, axis=1))
    cap, _ = TM.apply_moe(pt, xs, tcfg, impl="capacity")
    dense, _ = TM.apply_moe(pt, xs, tcfg, impl="dense")
    xt = xs[0]
    sp = pt["shared"]
    shared = (TM._act(xt @ sp["w_gate"], tcfg) * (xt @ sp["w_up"])) @ sp["w_down"]
    torch.testing.assert_close(cap[0, :16], dense[0, :16], **F32)
    torch.testing.assert_close(cap[0, 16:], shared[16:], **F32)
    assert (dense[0, 16:] - shared[16:]).abs().max() > 1.0   # routed part dropped


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_greedy_decode_matches_jax(arch):
    out, want_toks, want_logits = _run_both(
        arch, layers=2, d_model=256, batch=2, prompt_len=16, gen=8)
    assert out.logits.shape == want_logits.shape
    np.testing.assert_allclose(out.logits.numpy(), want_logits, **LOGITS)
    np.testing.assert_array_equal(out.tokens.numpy(), want_toks)


def test_moe_params_load_bit_exact():
    """blocks/moe and blocks/moe/shared: bf16 leaves bit for bit, the f32
    router f32, each under its JAX name."""
    jcfg = dataclasses.replace(jax_config("qwen2-moe-a2.7b").reduced(d_model=128),
                               param_dtype="bfloat16")
    tcfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(d_model=128),
                               param_dtype="bfloat16")
    params, *_ = jax_serving_inputs(jcfg, seed=2, batch=1, prompt_len=4)
    tree = jax.tree.map(np.asarray, params)
    model = params_from_jax(tcfg, tree, device="cpu")
    moe = tree["blocks"]["moe"]
    pairs = [(f"moe.{k}", v) for k, v in moe.items() if k != "shared"]
    pairs += [(f"moe.shared.{k}", v) for k, v in moe["shared"].items()]
    state = model.blocks[1].state_dict()
    assert {n for n in state if n.startswith("moe.")} == {n for n, _ in pairs}
    for name, arr in pairs:
        got = state[name]
        if arr.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          arr[1].view(np.int16))
        else:
            assert got.dtype == torch.float32 and name == "moe.router", name
            np.testing.assert_array_equal(got.numpy(), arr[1])
    assert set(model.blocks[0]._modules) == {"ln1", "attn", "ln2", "moe"}


def test_params_from_jax_checks_nested_layer_axis():
    jcfg = jax_config("qwen2-moe-a2.7b").reduced(d_model=128)
    params, *_ = jax_serving_inputs(jcfg, seed=0, batch=1, prompt_len=4)
    tree = jax.tree.map(np.asarray, params)
    tree["blocks"]["moe"]["shared"]["w_up"] = tree["blocks"]["moe"]["shared"][
        "w_up"][:1]
    with pytest.raises(ValueError, match="blocks/moe/shared/w_up"):
        params_from_jax(get_config("qwen2-moe-a2.7b").reduced(d_model=128),
                        tree, device="cpu")


def test_staged_runtime_trains_moe_as_jax():
    """JAX's ``stage_forward`` runs an MoE block with the dense experts and
    drops the auxiliary loss; the port's runs the token-routed experts,
    which compute the same function, and drops it too.  Reduced qwen2-moe
    (a shared expert, nested under ``moe``) at churn 0.2 over three
    iterations, from JAX's parameters."""
    jcfg, tcfg = (dataclasses.replace(
        get("qwen2-moe-a2.7b").reduced(num_layers=4, d_model=128),
        vocab_size=256) for get in (jax_config, get_config))
    jt = JRuntimeTrainer(jcfg, _net(j_network, 3, 2), churn=0.2, lr=3e-3,
                         seed=0)
    tt = _from_jax(RuntimeTrainer(tcfg, _net(geo_distributed_network, 3, 2),
                                  churn=0.2, lr=3e-3, seed=0, device="cpu"),
                   jcfg)
    dns = [d.id for d in tt.net.data_nodes()]
    shards = {dn: DataNodeShard(DataConfig(256, 64, 8, 2, seed=dn), k, 2)
              for k, dn in enumerate(dns)}
    for it in range(3):
        batches = {dn: shards[dn].microbatches() for dn in dns}
        rj, rt = jt.iteration(batches), tt.iteration(batches)
        for f in COUNTERS:
            assert getattr(rt, f) == getattr(rj, f), (it, f)
        assert abs(rt.loss - rj.loss) <= LOSS_RTOL["float32"][it] * abs(rj.loss), it
        assert tt.last_chains == jt.last_chains
    assert tt.stages.snapshot() == jt.stages.snapshot()
    assert ([vars(r) for r in tt.timeline.records]
            == [vars(r) for r in jt.timeline.records])
    assert tt.losses[-1] < tt.losses[0]
