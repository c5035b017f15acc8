"""Single-program training (``--mode spmd``) in the port against the JAX
package.

``train_loss`` and its gradient through ``launch.steps.loss_and_grads``
against ``jax.value_and_grad(train_loss)``, from JAX's parameters, for a
reduced model of each of the six arch types: dense, MoE (the router's
auxiliary loss included), SSM, hybrid, VLM (two superblocks, nonzero
gates, vision given) and audio (frame embeddings); the loss within 2e-4
relative and every gradient leaf within 2e-4 of its largest magnitude.
``remat=True`` equals ``remat=False`` bit for bit.  ``make_train_step``
with ``grad_accum=2`` against JAX's jitted step: loss, AdamW moments
(within 2e-4 of each leaf's largest magnitude) and parameters (within
1e-4, a tenth of one step's move at lr 1e-3).  The CLI,
``launch.train --mode spmd --reduced --device cpu --steps 3``, from JAX's
initial parameters against JAX's ``run_spmd``: the printed losses within
2e-4 on the first step and 1e-3 after; the port's ``--checkpoint``
restores through JAX's ``repro.checkpoint.store`` into JAX's tree, with
JAX's npz keys, shapes and dtypes.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.checkpoint import store as jstore
from repro.configs import get_config as jax_config
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.configs import get_config
from repro_torch.launch import steps, train
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import leaves, tree_map
from repro_torch.weights import _to_tensor
from test_torch_vlm_audio import AUDIO, VLM, vlm_cfg, with_gates

ARCHS = {"dense": "gwtf-llama-300m", "moe": "qwen2-moe-a2.7b",
         "ssm": "mamba2-130m", "hybrid": "hymba-1.5b", "vlm": VLM,
         "audio": AUDIO}
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cfg_of(get, kind):
    if kind == "vlm":
        return vlm_cfg(get)
    # 8 experts, top 4: the router's auxiliary loss depends on the routing
    return get(ARCHS[kind]).reduced(num_layers=2, d_model=128, max_experts=8)


def jax_params(jcfg, seed=0):
    """JAX's initial parameters as numpy, gates set for a VLM."""
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(seed)))
    return with_gates(tree) if "cross_blocks" in tree else tree


def batch_of(cfg, kind, lead=(), seed=0):
    """numpy batch: tokens (or frame embeddings for audio), labels, and
    vision for the VLM; ``lead`` prepends microbatch axes."""
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab_size, lead + (B, S), dtype=np.int32)}
    if kind == "audio":
        b["embeds"] = rng.standard_normal(
            lead + (B, S, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, lead + (B, S), dtype=np.int32)
    if kind == "vlm":
        b["vision"] = rng.standard_normal(
            lead + (B, cfg.num_image_tokens, cfg.vision_dim)).astype(np.float32)
    return b


def to_torch(tree):
    return tree_map(lambda a: _to_tensor(a, "cpu"), tree)


def assert_leaves_close(jtree, ttree, rtol, what=""):
    """Leaf by leaf, in ``jax.tree`` order, within ``rtol`` of each JAX
    leaf's largest magnitude."""
    ja = [np.asarray(x, np.float32) for x in jax.tree.leaves(jtree)]
    ta = [x.float().numpy() for x in leaves(ttree)]
    assert len(ja) == len(ta), what
    for k, (a, b) in enumerate(zip(ja, ta)):
        assert a.shape == b.shape, (what, k)
        bound = rtol * max(np.abs(a).max(), 1e-30)
        assert np.abs(a - b).max() <= bound, (what, k, np.abs(a - b).max(), bound)


@pytest.mark.parametrize("kind", list(ARCHS))
def test_train_loss_and_grads_match_jax(kind):
    jcfg, tcfg = cfg_of(jax_config, kind), cfg_of(get_config, kind)
    tree, batch = jax_params(jcfg), batch_of(tcfg, kind)
    want_loss, want_g = jax.value_and_grad(JT.train_loss)(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch), jcfg)
    loss, grads = steps.loss_and_grads(to_torch(tree), to_torch(batch), tcfg)
    assert abs(float(loss) - float(want_loss)) <= 2e-4 * abs(float(want_loss))
    assert_leaves_close(want_g, grads, 2e-4, kind)
    if kind == "moe":
        # the auxiliary loss is in: without it the loss moves
        plain = dataclasses.replace(tcfg, router_aux_coef=0.0)
        loss0, _ = steps.loss_and_grads(to_torch(tree), to_torch(batch), plain)
        assert abs(float(loss) - float(loss0)) > 1e-4
    if kind == "vlm":
        # every cross-block leaf has a gradient: the cross layers ran
        assert all(g.abs().max() > 0 for g in leaves(grads["cross_blocks"]))


@pytest.mark.parametrize("kind", ["dense", "vlm", "moe"])
def test_remat_equals_no_remat(kind):
    """A layer (a VLM's superblock) recomputed in the backward gives the
    same loss and gradients, bit for bit."""
    tcfg = cfg_of(get_config, kind)
    tree, batch = to_torch(jax_params(cfg_of(jax_config, kind))), to_torch(
        batch_of(tcfg, kind))
    runs = [steps.loss_and_grads(tree, batch, dataclasses.replace(tcfg, remat=r))
            for r in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(leaves(runs[0][1]), leaves(runs[1][1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_train_step_with_grad_accum_matches_jax(kind):
    """Two microbatches a step, two steps: the loss, the AdamW moments and
    the parameters against JAX's jitted step."""
    jcfg, tcfg = cfg_of(jax_config, kind), cfg_of(get_config, kind)
    tree = jax_params(jcfg)
    jp = jax.tree.map(jnp.asarray, tree)
    jopt = JAdamW(lr=1e-3)
    jstate = jopt.init(jp)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt, grad_accum=2))
    tp = to_torch(tree)
    opt = AdamW(lr=1e-3)
    tstate = opt.init(tp)
    tstep = steps.make_train_step(tcfg, opt, grad_accum=2)
    for i in range(2):
        batch = batch_of(tcfg, kind, lead=(2,), seed=i)
        jp, jstate, jloss = jstep(jp, jstate, jax.tree.map(jnp.asarray, batch))
        tp, tstate, tloss = tstep(tp, tstate, to_torch(batch))
        assert abs(float(tloss) - float(jloss)) <= 2e-4 * abs(float(jloss))
    assert int(tstate.step) == int(jstate.step) == 2
    assert_leaves_close(jstate.m, tstate.m, 2e-4, "m")
    assert_leaves_close(jstate.v, tstate.v, 2e-4, "v")
    # a step moves a weight by about lr (1e-3) times the sign of its
    # moments' ratio; the two frameworks' ratios differ in their last bits
    for a, b in zip(jax.tree.leaves(jp), leaves(tp)):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-4


def _losses(text: str):
    return [float(ln.split("loss ")[1].split()[0]) for ln in text.splitlines()
            if ln.startswith("step")]


def test_spmd_cli_matches_jax_run_spmd(tmp_path, monkeypatch, capsys):
    """Three steps of the reduced ``gwtf-llama-300m``, both from JAX's
    initial parameters; then both checkpoints through JAX's store."""
    argv = ["--mode", "spmd", "--reduced", "--steps", "3", "--log-every", "1",
            "--seq-len", "32"]
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--checkpoint",
                                      str(tmp_path / "jax")])
    jtrain.main()
    want = _losses(capsys.readouterr().out)

    jcfg = jax_config("gwtf-llama-300m").reduced(num_layers=4, d_model=256)
    init = jax_params(jcfg)
    monkeypatch.setattr(train, "spmd_params",
                        lambda cfg, seed, device: to_torch(init))
    final = train.main([*argv, "--device", "cpu", "--checkpoint",
                        str(tmp_path / "port")])
    out = capsys.readouterr().out
    got = _losses(out)
    assert len(got) == len(want) == 3
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) <= (2e-4 if i == 0 else 1e-3) * abs(b) + 1e-4, (i, a, b)
    assert final == pytest.approx(got[-1], abs=1e-4)
    assert "checkpoint ->" in out and "ms" in out and "tok/s" in out

    jz, tz = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(jz.files) == sorted(tz.files)
    for k in jz.files:
        assert jz[k].shape == tz[k].shape and jz[k].dtype == tz[k].dtype, k
    like = JT.init_params(jcfg, jax.random.PRNGKey(0))
    mine, step = jstore.restore(str(tmp_path / "port"), like)
    theirs, _ = jstore.restore(str(tmp_path / "jax"), like)
    assert step == 3
    for a, b in zip(jax.tree.leaves(theirs), jax.tree.leaves(mine)):
        assert np.abs(a - b).max() <= 2e-3           # 2 lr: a sign flip at most


@pytest.mark.parametrize("kind", ["vlm", "audio"])
def test_prefill_and_decode_steps(kind):
    """``make_prefill_step`` and ``make_decode_step`` give what
    ``prefill`` and ``decode_step`` give (a bf16 cache, as in JAX)."""
    tcfg = cfg_of(get_config, kind)
    model = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    b = to_torch(batch_of(tcfg, kind))
    b.pop("labels")
    logits, cache = steps.make_prefill_step(tcfg, S + 1)(model, b)
    assert logits.shape == (B, tcfg.vocab_size)
    assert next(iter(cache["attn"].values())).dtype == torch.bfloat16
    tok = logits.argmax(-1)[:, None]
    step_in = {"tokens": tok, "vision": b.get("vision"), "cache": cache,
               "index": S}
    out, _ = steps.make_decode_step(tcfg)(model, step_in)
    assert out.shape == (B, tcfg.vocab_size) and torch.isfinite(out).all()
