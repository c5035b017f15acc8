"""The port's stage compute against the JAX package's on shared weights.

The JAX package's seeded stage and head trees are carried into the port
(``weights.initial_params_from_jax``, stacked layout kept); both packages
run the same numpy inputs.  The stage forward, its ``(dparams, dx)``
against ``jax.vjp`` of the reference stage, ``head_loss`` and
``embed_backward`` agree within 2e-4 of the largest magnitude (f32,
reduced ``gwtf-llama-300m``).  Inside the port, the fused path equals the
rematerialising one bit for bit, and neither reaches the flash kernel,
nor, for SSM and hybrid stages, the SSD kernel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs import get_config as jax_config
from repro.core.runtime import cache as jcache
from repro.core.runtime.stages import StageCompute as JStageCompute
from repro.core.runtime.stages import stage_forward as j_stage_forward
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.core.runtime.stages import StageCompute, stage_bounds
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as TL
from repro_torch.tree import leaves
from repro_torch.weights import initial_params_from_jax

TOL = 2e-4
S = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tests' tensors are tiny; under several test workers torch's
    default of one thread per core oversubscribes the host many times."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs():
    j = dataclasses.replace(
        jax_config("gwtf-llama-300m").reduced(num_layers=4, d_model=128),
        vocab_size=256)
    t = dataclasses.replace(
        get_config("gwtf-llama-300m").reduced(num_layers=4, d_model=128),
        vocab_size=256)
    return j, t


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jp = jcache.initial_params(jcfg, S, 0)
    tp = initial_params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    return jcfg, tcfg, jp, tp


def _close(t, j):
    a = t.detach().double().numpy() if isinstance(t, torch.Tensor) else t
    b = np.asarray(j, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= TOL * max(np.abs(b).max(), 1e-30)


def _np(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("stage", range(S))
def test_stage_forward_and_vjp_match_jax(setup, stage):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(stage)
    x, g = _np(rng, 4, 16, 128), _np(rng, 4, 16, 128)
    out, vjp = jax.vjp(lambda p, xx: j_stage_forward(p, xx, jcfg),
                       jp[0][stage], jnp.asarray(x))
    jdp, jdx = vjp(jnp.asarray(g))
    sc = StageCompute(tcfg, S)
    tout, resid = sc.forward_fused(stage, tp[0][stage], torch.from_numpy(x))
    dp, dx = sc.backward_from_residuals(stage, resid, torch.from_numpy(g))
    _close(tout, out)
    _close(dx, jdx)
    assert len(leaves(dp)) == len(jax.tree.leaves(jdp))
    for a, b in zip(leaves(dp), jax.tree.leaves(jdp)):
        _close(a, b)
    lo, hi = stage_bounds(tcfg, stage, S)
    assert tp[0][stage]["ln1"]["scale"].shape == (hi - lo, 128)


def test_head_loss_and_embed_backward_match_jax(setup):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(5)
    hidden = _np(rng, 3, 2, 16, 128)
    labels = rng.integers(0, 256, (3, 2, 16))
    tokens = rng.integers(0, 256, (6, 16))
    g = _np(rng, 6, 16, 128)
    jsc, sc = JStageCompute(jcfg, S, donate=False), StageCompute(tcfg, S)
    jl, jgh, jgx = jsc.head_loss(jp[1], jnp.asarray(hidden),
                                 jnp.asarray(labels))
    tl, tgh, tgx = sc.head_loss(tp[1], torch.from_numpy(hidden),
                                torch.from_numpy(labels))
    _close(tl, jl)
    _close(tgx, jgx)
    for a, b in zip(leaves(tgh), jax.tree.leaves(jgh)):
        _close(a, b)
    jemb = jsc.embed_backward(jp[1], jnp.asarray(tokens), jnp.asarray(g))
    temb = sc.embed_backward(tp[1], torch.from_numpy(tokens), torch.from_numpy(g))
    for a, b in zip(leaves(temb), jax.tree.leaves(jemb)):
        _close(a, b)
    _close(sc.embed(tp[1], torch.from_numpy(tokens)),
           jsc.embed(jp[1], jnp.asarray(tokens)))
    assert sc.snapshot() == dict(fwd=[0, 0], bwd=[0, 0], remat=[0, 0],
                                 embed=1, embed_bwd=1, head=1)


@pytest.mark.parametrize("S_len,chunk", [(16, 16), (32, 8), (24, 16)])
def test_chunked_xent_loss_matches_jax(setup, S_len, chunk):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(S_len)
    x = _np(rng, 2, S_len, 128)
    labels = rng.integers(0, 256, (2, S_len))
    want = JL.chunked_xent_loss(jp[1]["embed"], jnp.asarray(x),
                                jnp.asarray(labels), jcfg, chunk=chunk)
    got = TL.chunked_xent_loss(tp[1]["embed"], torch.from_numpy(x),
                               torch.from_numpy(labels), tcfg, chunk=chunk)
    _close(got, want)


def test_fused_bitwise_matches_remat_and_replays(setup):
    """The fused output equals the plain forward bit for bit; the backward
    from residuals equals the rematerialising backward bit for bit; the
    residuals serve a second backward (the crash replay); the counters
    tell the modes apart."""
    _, tcfg, _, tp = setup
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_np(rng, 4, 16, 128))
    g = torch.from_numpy(_np(rng, 4, 16, 128))
    sc = StageCompute(tcfg, S)
    plain = sc.forward(0, tp[0][0], x)
    fused, resid = sc.forward_fused(0, tp[0][0], x)
    assert torch.equal(plain, fused)
    dp_f, dx_f = sc.backward_from_residuals(0, resid, g)
    dp_r, dx_r = sc.backward(0, tp[0][0], x, g)
    dp_2, dx_2 = sc.backward_from_residuals(0, resid, g)
    assert torch.equal(dx_f, dx_r) and torch.equal(dx_f, dx_2)
    for a, b, c in zip(leaves(dp_f), leaves(dp_r), leaves(dp_2)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert sc.fwd_calls[0] == 2 and sc.bwd_calls[0] == 3
    assert sc.remat_recomputes[0] == 1 and sc.remat_recompute_count == 1
    assert sc.stage_dispatches == 5


def test_training_path_never_reaches_the_flash_kernel(setup, monkeypatch):
    """``use_kernel=False`` (the stages) takes ``_online_attention``; the
    flash kernel, which has no backward, is only for serving."""
    _, tcfg, _, tp = setup

    def refuse(*a, **k):
        raise AssertionError("the training path called the flash kernel")

    rng = np.random.default_rng(2)
    x = torch.from_numpy(_np(rng, 2, 16, 128))
    layer = {name: {k: v[0] for k, v in sub.items()}
             for name, sub in tp[0][0].items()}
    pos = torch.arange(16)
    want, _ = TL.apply_attention(layer["attn"], x, tcfg, positions=pos)
    monkeypatch.setattr(kops, "flash_attention", refuse)
    got, _ = TL.apply_attention(layer["attn"], x, tcfg, positions=pos,
                                use_kernel=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    sc = StageCompute(tcfg, S)
    _, resid = sc.forward_fused(0, tp[0][0], x)
    sc.backward_from_residuals(0, resid, torch.ones_like(x))
    with pytest.raises(AssertionError, match="flash kernel"):
        TL.apply_attention(layer["attn"], x, tcfg, positions=pos)


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_training_path_never_reaches_the_ssd_kernel(monkeypatch, arch):
    """The stages scan an SSM layer with ``ssd_chunked``, which autograd
    differentiates, never with the SSD kernel, which has no backward: on
    the card the kernel's output would cut the scan's gradient.  The
    backward reaches every SSM parameter."""
    from repro_torch.core.runtime import cache as tcache

    cfg = get_config(arch).reduced(num_layers=2, d_model=64)

    def refuse(*a, **k):
        raise AssertionError("the training path called the SSD kernel")

    monkeypatch.setattr(kops, "ssd_scan", refuse)
    stage_p, _ = tcache.initial_params(cfg, 1, 0, "cpu")
    x = torch.from_numpy(_np(np.random.default_rng(3), 2, 16, 64))
    sc = StageCompute(cfg, 1)
    _, resid = sc.forward_fused(0, stage_p[0], x)
    grads, _ = sc.backward_from_residuals(0, resid, torch.ones_like(x))
    for leaf in ("in_proj", "A_log", "dt_bias", "conv_w"):
        assert grads["mamba"][leaf].abs().max() > 0, leaf


def test_dropped_residuals_free_their_saved_tensors(setup):
    """Once the store and the caller let go of a residual graph, every
    tensor it saved is freed (no reference cycle through the graph), so a
    trainer's memory does not grow from chunk to chunk."""
    import gc
    import weakref

    from repro_torch.core.runtime.activations import ActivationStore

    _, tcfg, _, tp = setup
    x = torch.from_numpy(_np(np.random.default_rng(3), 2, 16, 128))
    sc, store = StageCompute(tcfg, S), ActivationStore()
    _, resid = sc.forward_fused(0, tp[0][0], x)
    store.put_residuals(0, (0,), resid)
    refs = [weakref.ref(s.enc) for s in resid.saved]
    assert refs
    sc.backward_from_residuals(0, store.residuals(0, (0,)), torch.ones_like(x))
    store.drop(0, (0,))
    del resid
    gc.collect()
    assert not [r for r in refs if r() is not None]
