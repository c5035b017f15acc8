"""The training flash pair on the card: ``flash_attention_fwd_lse`` (the
sm90 forward that also writes the rows' log-sum-exp) and the hand-written
backward ``kernels/csrc/flash_attention_bwd_sm90.cu``.

Every test needs a CUDA card (marker ``card``; they skip elsewhere):

* the forward's output and log-sum-exp, and dQ, dK and dV, against
  ``layers._online_attention`` and its autograd at the GPT-like training
  cells' shape (8 x 1,024, 16 heads of 64), the 7B cell's (2 x 512, 36/4
  heads of 128, window 4,096) and ragged S, one with a short window (S up
  to 512, where ``_online_attention`` takes a ragged S): the output
  within bf16 resolution, lse within f32 rounding, each gradient at least
  as close to the exact one (the same function in f64, autograd) as
  ``_online_attention``'s is, within 1.1 times its relative RMS error;
* two backward runs bit-equal, one count a call, no host sync;
* the serving forward's output bit-equal to the training forward's at the
  serve cells' prefill shapes (the lse store is the only difference);
* one training iteration of each GPT-like cell, built as the benchmark
  builds it, calling the forward once a layer of each stage forward
  (fused, or remat's recompute) and the backward once a layer of each
  stage backward.

Run them there with ``python3 -m pytest --noconftest -q -p no:cacheprovider
tests/test_torch_flash_train_sm90.py`` (the card has no JAX, which the
directory's conftest imports).
"""
import pytest

pytest.importorskip("torch")

import torch

from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops
from repro_torch.models import layers

SHAPES = {  # (B, S, H, KH, D, window)
    "gpt-like": (8, 1024, 16, 16, 64, None),
    "7b": (2, 512, 36, 4, 128, 4096),
    "ragged-window": (2, 500, 6, 2, 64, 100),
    "ragged-128": (1, 200, 4, 4, 128, None),
}
SERVE_PREFILLS = {"serve-decode": (64, 1024, 36, 4, 128),
                  "serve-long": (32, 4032, 36, 4, 128)}


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(shape, seed=0):
    B, S, H, KH, D = shape[:5]
    g = torch.Generator(device="cuda").manual_seed(seed + S)
    q, dout = (torch.randn(B, S, H, D, generator=g, device="cuda").bfloat16()
               for _ in range(2))
    k, v = (torch.randn(B, S, KH, D, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    return q, k, v, dout


def _grads(fn, q, k, v, g):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, g)


def _exact(window):
    def fn(q, k, v):
        B, S, H, D = q.shape
        rep = H // k.shape[2]
        k, v = (t.double().repeat_interleave(rep, dim=2) for t in (k, v))
        s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k) * D ** -0.5
        s = s.masked_fill(~ops._train_mask(S, window, q.device), -1e30)
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return fn


def _error(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


@pytest.mark.card
@pytest.mark.parametrize("name", SHAPES)
def test_the_forward_and_its_lse_match_the_reference(card, name):
    B, S, H, KH, D, window = SHAPES[name]
    q, k, v, _ = _inputs(SHAPES[name])
    before = ops.flash_attention.launches
    out, lse = ops.flash_attention_lse(q, k, v, window=window)
    assert ops.flash_attention.launches == before + 1
    assert lse.shape == (B, H, kfa.padded(S)) and lse.dtype == torch.float32
    want = layers._online_attention(q, k, v, 0, causal=True, window=window)
    assert _error(out, want) < 1e-2
    assert float((out.float() - want.float()).abs().max()) < 2e-2
    _, want_lse = ops.flash_attention_lse_plain(q, k, v, window=window)
    torch.testing.assert_close(lse[..., :S], want_lse, rtol=1e-5, atol=1e-4)
    assert bool(torch.isfinite(lse).all())


@pytest.mark.card
@pytest.mark.parametrize("name", SHAPES)
def test_the_gradients_match_autograd_of_online_attention(card, name):
    window = SHAPES[name][5]
    q, k, v, g = _inputs(SHAPES[name], seed=1)
    before = ops.flash_attention_bwd.launches
    _, got = _grads(lambda q, k, v: ops.flash_attention_train(q, k, v, window=window),
                    q, k, v, g)
    assert ops.flash_attention_bwd.launches == before + 1
    _, ref = _grads(lambda q, k, v: layers._online_attention(
        q, k, v, 0, causal=True, window=window), q, k, v, g)
    _, exact = _grads(_exact(window), q, k, v, g.double())
    for name_, a, b, e in zip("qkv", got, ref, exact):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name_
        err, err_ref = _error(a, e), _error(b, e)
        assert err <= 1.1 * err_ref, (name_, err, err_ref)
        assert _error(a, b) < 1e-2, name_
    del exact
    torch.cuda.empty_cache()


@pytest.mark.card
def test_two_backward_runs_are_bit_equal_counted_and_sync_free(card):
    q, k, v, g = _inputs(SHAPES["gpt-like"], seed=2)
    out, lse = ops.flash_attention_lse(q, k, v)
    before = ops.flash_attention_bwd.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runs = [ops.flash_attention_bwd(q, k, v, out, lse, g) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ops.flash_attention_bwd.launches == before + 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("name", SERVE_PREFILLS)
def test_the_serving_forward_equals_the_training_forward(card, name):
    q, k, v, _ = _inputs(SERVE_PREFILLS[name] + (None,), seed=3)
    served = ops.flash_attention(q, k, v, causal=True)
    trained, _ = ops.flash_attention_lse(q, k, v)
    assert torch.equal(served, trained)


@pytest.mark.card
@pytest.mark.parametrize("over, match", [
    (dict(dtype=torch.float32), "bf16"),
    (dict(D=256), "head_dim"),
])
def test_the_pair_refuses_what_it_does_not_take(card, over, match):
    D = over.get("D", 64)
    dtype = over.get("dtype", torch.bfloat16)
    q = torch.zeros((1, 64, 2, D), dtype=dtype, device="cuda")
    with pytest.raises(ValueError, match=match):
        kfa.launch_lse(q, q, q, window=None)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["gpt300m-train-calm", "gpt300m-train-churn10"])
def test_a_training_iteration_of_a_gpt_like_cell_takes_the_pair(card, cell):
    from perfbench import harness
    from perfbench.drivers import train as drv
    from repro_torch.core.runtime.stages import stage_bounds
    from repro_torch.launch import train as T
    run = harness.Run(device="cuda", seed=2718281828, seconds=0, trace=False, t0=0.0)
    trainer, feed = drv.build(harness.load_cell(cell), run)
    compute, cfg = trainer.stages, trainer.cfg
    n = len(compute.fwd_calls)
    layers_of = [hi - lo for lo, hi in (stage_bounds(cfg, s, n) for s in range(n))]
    fwd0 = (list(compute.fwd_calls), list(compute.remat_recomputes))
    bwd0 = list(compute.bwd_calls)
    f0, b0 = ops.flash_attention.launches, ops.flash_attention_bwd.launches
    r, _, _ = T.train_iteration(trainer, feed(0))
    assert r.completed > 0
    fwd = sum(L * (f + m - f_ - m_) for L, f, m, f_, m_ in zip(
        layers_of, compute.fwd_calls, compute.remat_recomputes, *fwd0))
    bwd = sum(L * (b - b_) for L, b, b_ in zip(layers_of, compute.bwd_calls, bwd0))
    assert bwd > 0
    assert ops.flash_attention.launches - f0 == fwd
    assert ops.flash_attention_bwd.launches - b0 == bwd
    del trainer, feed
    torch.cuda.empty_cache()
