"""Training attention through the flash pair (``kops.flash_attention_train``),
on the CPU.

The pair is an autograd function over ``flash_attention_lse`` and
``flash_attention_bwd``; on the CPU each runs its plain version, whose
backward is written out by hand in the card kernel's arithmetic (P
recomputed from the log-sum-exp, D = rowsum(dO * O), dS in f32 entering
its products as three bf16 terms).  Here it is held against autograd of
``layers._online_attention``, the path the training stages took before,
on the same bf16 inputs: the forward bit for bit, and each gradient at
least as close to the exact one (the same function in f64, autograd) as
``_online_attention``'s own gradient is (relative RMS error, within 1.1
times).
``_online_attention`` rounds dP to bf16 in its backward (the cast of P
to v's dtype before P V passes the gradient back in bf16); the pair keeps
dP in f32, so it is the closer of the two.  Cases: MHA and 9:1 GQA,
causal with and without a window shorter than S, S a multiple of 64 and
not, head dims 64 and 128.

Also the route: CPU, meta, fake-CUDA and DTensor tensors, f32, MLA's q 192
/ v 128, head dim 256 and cross-attention keep ``_online_attention``;
bf16 self-attention of head dim 64 or 128 on plain CUDA tensors takes the
pair (the device half of the rule stood in for on the CPU, where only its
shape half can be seen), through ``apply_attention`` and a training
stage's fused forward and backward.  The card tests are in
``tests/test_torch_flash_train_sm90.py``.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config
from repro_torch.core.runtime import stages
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.tree import flatten


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed, B, S, H, KH, D, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    q, g = (torch.from_numpy(rng.standard_normal((B, S, H, D), dtype=np.float32)).to(dtype)
            for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, KH, D), dtype=np.float32)).to(dtype)
            for _ in range(2))
    return q, k, v, g


def _grads(fn, q, k, v, g):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, g)


def _online(window):
    return lambda q, k, v: layers._online_attention(q, k, v, 0, causal=True,
                                                    window=window)


def _exact(window):
    """The function in f64, P unrounded: the gradients' yardstick."""
    def fn(q, k, v):
        B, S, H, D = q.shape
        rep = H // k.shape[2]
        k, v = (t.double().repeat_interleave(rep, dim=2) for t in (k, v))
        s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k) * D ** -0.5
        s = s.masked_fill(~ops._train_mask(S, window, q.device), -1e30)
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return fn


def _error(got, want):
    """Relative root-mean-square error: the gradients are rounded to bf16
    last, so an elementwise maximum reads that rounding alone."""
    return float((got.double() - want).norm() / want.norm())


CASES = [  # (B, S, H, KH, D, window)
    (2, 128, 2, 2, 64, None),
    (1, 128, 9, 1, 64, None),
    (2, 100, 2, 2, 64, None),
    (1, 130, 9, 1, 64, 48),
    (1, 128, 2, 2, 64, 40),
    (1, 96, 2, 1, 128, None),
    (1, 70, 4, 2, 128, 33),
]


@pytest.mark.parametrize("B, S, H, KH, D, window", CASES,
                         ids=[f"{c[0]}x{c[1]}-{c[2]}/{c[3]}-d{c[4]}-w{c[5]}" for c in CASES])
def test_the_plain_pair_matches_autograd_of_online_attention(B, S, H, KH, D, window):
    q, k, v, g = _inputs(B * S + H, B, S, H, KH, D)
    before = ops.flash_attention_bwd.launches
    out, got = _grads(lambda q, k, v: ops.flash_attention_train(q, k, v, window=window),
                      q, k, v, g)
    out_ref, ref = _grads(_online(window), q, k, v, g)
    assert ops.flash_attention_bwd.launches == before   # the CPU runs the plain pair
    assert torch.equal(out, out_ref)
    _, exact = _grads(_exact(window), q, k, v, g.double())
    for name, a, b, e in zip("qkv", got, ref, exact):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        err, err_ref = _error(a, e), _error(b, e)
        assert err <= 1.1 * err_ref, (name, err, err_ref)
        # and close to the reference's gradient itself, at bf16's resolution
        assert _error(a, b.double()) < 1e-2, name


def test_the_plain_backward_repeats_the_forward_lse():
    """lse is the rows' natural log-sum-exp of the scaled, masked scores,
    and P recomputed from it sums to 1 over each row's keys."""
    q, k, v, _ = _inputs(3, 1, 100, 4, 2, 64)
    _, lse = ops.flash_attention_lse(q, k, v, window=30)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(2, dim=2)) * 64 ** -0.5
    mask = ops._train_mask(100, 30, q.device)
    assert torch.allclose(lse, torch.logsumexp(s.masked_fill(~mask, -1e30), -1))
    p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0)
    assert torch.allclose(p.sum(-1), torch.ones(()), atol=1e-5)


@pytest.mark.parametrize("seed", range(4))
def test_split3_holds_an_f32_value_exactly(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * 10.0 ** rng.uniform(-20, 20, 4096)).astype(np.float32))
    hi, mid, lo = ops.split3(x)
    assert all(t.dtype == torch.bfloat16 for t in (hi, mid, lo))
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)
    assert not torch.equal(hi.float(), x)       # the three terms are needed


@pytest.mark.parametrize("dtype, dq, dv, takes", [
    (torch.bfloat16, 64, 64, True),
    (torch.bfloat16, 128, 128, True),
    (torch.float32, 64, 64, False),
    (torch.bfloat16, 192, 128, False),          # MLA: q 192, v 128
    (torch.bfloat16, 256, 256, False),
    (torch.bfloat16, 32, 32, False),
], ids=["bf16-64", "bf16-128", "f32", "mla-192-128", "d256", "d32"])
def test_the_kernels_take_bf16_of_head_dim_64_or_128(dtype, dq, dv, takes):
    q = torch.zeros((2, 8, 4, dq), dtype=dtype)
    k = torch.zeros((2, 8, 2, dq), dtype=dtype)
    v = torch.zeros((2, 8, 2, dv), dtype=dtype)
    assert kfa.train_shapes(q, k, v) is takes
    assert ops.flash_attention_train_route(q, k, v) is False    # on the CPU


@pytest.mark.parametrize("kind", ["cpu", "meta", "fake_cuda", "dtensor"])
def test_only_plain_cuda_tensors_take_the_pair(kind):
    shape = (1, 8, 2, 64)

    def route(make):
        return ops.flash_attention_train_route(*(make() for _ in range(3)))
    if kind == "cpu":
        assert route(lambda: torch.zeros(shape, dtype=torch.bfloat16)) is False
    elif kind == "meta":
        assert route(lambda: torch.zeros(shape, dtype=torch.bfloat16,
                                         device="meta")) is False
    elif kind == "fake_cuda":
        with FakeTensorMode():
            ts = [torch.empty(shape, dtype=torch.bfloat16, device="cuda")
                  for _ in range(3)]
            assert all(t.is_cuda for t in ts)
            assert ops.flash_attention_train_route(*ts) is False
    else:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate, distribute_tensor
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            mesh = init_device_mesh("cpu", (1,))
            assert route(lambda: distribute_tensor(
                torch.zeros(shape, dtype=torch.bfloat16), mesh,
                [Replicate()])) is False
        finally:
            dist.destroy_process_group()


@pytest.fixture()
def as_if_on_cuda(monkeypatch):
    """The route as on the card for tensors of the right dtype and shape,
    each call of the pair counted (the pair itself runs its plain version)."""
    calls = []
    pair = ops.flash_attention_train
    monkeypatch.setattr(ops, "flash_attention_train_route", kfa.train_shapes)

    def counted(q, k, v, *, window=None):
        calls.append((tuple(q.shape), window))
        return pair(q, k, v, window=window)
    monkeypatch.setattr(ops, "flash_attention_train", counted)
    return calls


def _attention_cfg(head_dim: int, dtype: str, heads=(4, 2)):
    cfg = get_config("gwtf-llama-300m").reduced(num_layers=2, d_model=128)
    return dataclasses.replace(cfg, num_heads=heads[0], num_kv_heads=heads[1],
                               head_dim=head_dim, param_dtype=dtype)


@pytest.mark.parametrize("case, calls", [
    ("self-64", 1), ("self-128", 1), ("window", 1), ("f32", 0), ("d256", 0),
    ("cross", 0), ("prefill", 0), ("serving", 0),
])
def test_apply_attention_routes_training_self_attention(as_if_on_cuda, case, calls):
    head_dim = {"self-128": 128, "d256": 256}.get(case, 64)
    dtype = "float32" if case == "f32" else "bfloat16"
    cfg = _attention_cfg(head_dim, dtype)
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(0)
    p = layers.init_attention(gen, cfg, dt, "cpu",
                              kv_in_dim=32 if case == "cross" else None)
    x = torch.randn((2, 80, cfg.d_model), generator=gen).to(dt)
    kw = dict(positions=torch.arange(80), use_kernel=False)
    if case == "window":
        kw["window"] = 24
    if case == "cross":
        kw.update(causal=False, kv_x=torch.randn((2, 12, 32), generator=gen).to(dt))
    if case == "prefill":
        kw.update(cache={n: torch.zeros((2, 96, cfg.kv_dim)) for n in "kv"},
                  write_index=0, kv_valid=80)
    if case == "serving":
        kw["use_kernel"] = True
    out, _ = layers.apply_attention(p, x, cfg, **kw)
    assert len(as_if_on_cuda) == calls
    if calls:
        assert as_if_on_cuda[0][1] == kw.get("window")
    assert out.shape == x.shape and bool(torch.isfinite(out.float()).all())


def test_a_stage_trains_through_the_pair_where_the_route_admits_it(as_if_on_cuda):
    """A bf16 stage's fused forward (saved tensors through the store's
    hooks) and its backward from the residuals: the forward bit for bit
    ``_online_attention``'s, the gradients within bf16 resolution of it,
    the pair called once a layer."""
    cfg = _attention_cfg(64, "bfloat16")
    gen = torch.Generator().manual_seed(1)
    params = stages.init_stage_params(cfg, 0, 1, gen)
    x = (torch.randn((2, 96, cfg.d_model), generator=gen) * 0.5).to(torch.bfloat16)
    g = torch.randn((2, 96, cfg.d_model), generator=gen).to(torch.bfloat16)
    out, resid = stages._forward_residuals(cfg, params, x)
    grads, gx = stages._backward_residuals(resid, g)
    assert len(as_if_on_cuda) == cfg.num_layers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "flash_attention_train_route", lambda q, k, v: False)
        out_ref, resid_ref = stages._forward_residuals(cfg, params, x)
        grads_ref, gx_ref = stages._backward_residuals(resid_ref, g)
    assert len(as_if_on_cuda) == cfg.num_layers
    assert torch.equal(out, out_ref)
    pairs = list(zip(flatten(grads)[0], flatten(grads_ref)[0])) + [(gx, gx_ref)]
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _error(a, b.double()) < 1e-2
