"""The port's AdamW and SGD against the JAX package's on the same trees.

One stage tree of the staged runtime (blocks stacked along a leading
axis, so the norm scales are (L, D)) plus a data-node head, in bf16 and
in f32, with gradients drawn from a numpy seed: two updates through
both packages agree within one bf16 ulp on bf16 leaves and 1e-6 on f32
leaves and moments.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.runtime import cache as jcache
from repro.optim.adamw import SGD as JSGD
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.optim.adamw import SGD, AdamW
from repro_torch.tree import flatten, leaves, tree_map
from repro_torch.weights import _to_tensor


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tests' tensors are tiny; under several test workers torch's
    default of one thread per core oversubscribes the host many times."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _trees(param_dtype):
    cfg = dataclasses.replace(
        jax_config("gwtf-llama-300m").reduced(num_layers=4, d_model=64),
        param_dtype=param_dtype)
    stage_p, head_p = jcache.initial_params(cfg, 2, 0)
    return {"stage": stage_p[0], "head": head_p}


def _grads(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape) * 3.0, dtype=p.dtype), tree)


def _torch(tree):
    return tree_map(lambda a: _to_tensor(np.asarray(a), "cpu"),
                    jax.tree.map(np.asarray, tree))


def _close(t, j, before=None):
    """One bf16 ulp on bf16 leaves, at the magnitude of the operands (the
    leaf before the update and both results: where an update cancels a
    parameter to near zero, the f32 rounding of the operands is what
    differs), 1e-6 on f32."""
    a = t.detach().float().numpy().astype(np.float64)
    b = np.asarray(j, np.float64)
    if t.dtype == torch.bfloat16:
        mag = np.maximum(np.abs(a), np.abs(b))
        if before is not None:
            mag = np.maximum(mag, np.abs(np.asarray(before, np.float64)))
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
        assert (np.abs(a - b) <= ulp).all(), np.abs(a - b).max()
    else:
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("param_dtype", ["bfloat16", "float32"])
def test_adamw_matches_jax(param_dtype):
    jtree = _trees(param_dtype)
    assert jtree["stage"]["ln1"]["scale"].ndim == 2      # stacked (L, D)
    jopt, topt = JAdamW(lr=1e-2), AdamW(lr=1e-2)
    jp, tp = jtree, _torch(jtree)
    js, ts = jopt.init(jp), topt.init(tp)
    for seed in (1, 2):
        g = _grads(jp, seed)
        before = jax.tree.leaves(jp)
        jp, js = jopt.update(g, js, jp)
        tp, ts = topt.update(_torch(g), ts, tp)
        for t, j, b in zip(leaves(tp), jax.tree.leaves(jp), before):
            assert t.dtype == {"bfloat16": torch.bfloat16,
                               "float32": torch.float32}[str(j.dtype)]
            _close(t, j, b)
        for t, j in zip(leaves((ts.m, ts.v)), jax.tree.leaves((js.m, js.v))):
            _close(t, j)
        assert int(ts.step) == int(js.step)


def test_adamw_decays_stacked_norm_scales_and_clips_per_tree():
    """With zero gradients only decay moves a leaf: a stacked (L, D) norm
    scale moves by lr * wd * p, a 1-D leaf stays; and one clip norm spans
    the tree given to one update (the trainers update each stage tree and
    each head on its own, so each is clipped on its own)."""
    opt = AdamW(lr=1e-2, weight_decay=0.1)
    p = {"scale": torch.ones(4, 8), "bias": torch.ones(8)}
    new_p, _ = opt.update(tree_map(torch.zeros_like, p), opt.init(p), p)
    torch.testing.assert_close(new_p["scale"], torch.full((4, 8), 1 - 1e-3))
    assert torch.equal(new_p["bias"], p["bias"])

    rng = np.random.default_rng(0)
    a = {"w": torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32))}
    ga = {"w": torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32))}
    huge = {"w": ga["w"] * 1e4}
    alone, _ = opt.update(ga, opt.init(a), a)
    both, _ = opt.update({"a": ga, "b": huge}, opt.init({"a": a, "b": a}),
                         {"a": a, "b": a})
    assert not torch.equal(alone["w"], both["a"]["w"])   # one clip norm


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_jax(momentum):
    jtree = _trees("float32")["stage"]
    jopt, topt = JSGD(lr=1e-2, momentum=momentum), SGD(lr=1e-2,
                                                       momentum=momentum)
    jp, tp = jtree, _torch(jtree)
    js, ts = jopt.init(jp), topt.init(tp)
    for seed in (3, 4):
        g = _grads(jp, seed)
        jp, js = jopt.update(g, js, jp)
        tp, ts = topt.update(_torch(g), ts, tp)
    for t, j in zip(leaves(tp), jax.tree.leaves(jp)):
        _close(t, j)


def test_leaf_order_is_jax_tree_flatten_order():
    jtree = _trees("float32")
    jleaves = jax.tree.leaves(jtree)
    tleaves, _ = flatten(_torch(jtree))
    assert [tuple(t.shape) for t in tleaves] == [j.shape for j in jleaves]
    for t, j in zip(tleaves, jleaves):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
