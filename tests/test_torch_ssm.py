"""The port's SSD scan and Mamba2 block against the JAX package.

Same numpy inputs through both packages.  On the CPU
``repro_torch.kernels.ops.ssd_scan`` runs its plain version
(``ssd_chunked`` with the JAX model's chunk rule); the JAX side runs the
Pallas kernel in interpret mode, its sequential oracle, or the model's
``ssd_chunked``.  The CUDA kernel itself is held against the plain version
on the card by ``chip_smoke.py``.

Tolerances: 2e-3 where the two sides chunk the sequence differently (as
``tests/test_kernels.py`` holds the Pallas kernel to its oracle), 10x
the bf16 2e-2 for bf16 inputs (as there), 2e-4 for f32 layers that
associate their sums alike, and 2e-2 for the outputs of the
bf16-params / f32-cache block, about one bf16 ulp of O(1) values (its f32
states are held at 2e-4).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs import get_config as jax_config
from repro.kernels.ref import ssd_scan_reference as jax_ssd_scan_reference
from repro.kernels.ssd_scan import ssd_scan_bhsp
from repro.models import ssm as JS
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels.ref import ssd_reference, ssd_scan_reference
from repro_torch.models import ssm as TS

SCAN = dict(rtol=2e-3, atol=2e-3)
SCAN_BF16 = dict(rtol=2e-1, atol=2e-1)
LAYER = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _scan_inputs(seed, B, S, H, P, N):
    """Model-layout numpy inputs drawn as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, N), dtype=np.float32)
    return x, dt, A, Bm, Cm


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **tol)


# ---------------------------------------------------------------------------
# SSD scan: the op against the Pallas kernel, its oracle and ssd_chunked
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(128, 32), (256, 64), (256, 128)])
@pytest.mark.parametrize("N", [16, 64])
def test_ssd_scan_matches_jax_kernel(S, chunk, N):
    x, dt, A, Bm, Cm = _scan_inputs(S + N, 2, S, 3, 32, N)
    jx = jnp.asarray(x.transpose(0, 2, 1, 3))          # kernel layout (B,H,S,P)
    jdt = jnp.asarray(dt.transpose(0, 2, 1))
    args = (jnp.asarray(A), jnp.asarray(Bm), jnp.asarray(Cm))
    y_k, h_k = ssd_scan_bhsp(jx, jdt, *args, chunk=chunk, interpret=True)
    y_r, h_r = jax_ssd_scan_reference(jx, jdt, *args)
    y, h = ops.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)))
    assert y.shape == x.shape and h.shape == (2, 3, 32, N)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    for want_y, want_h in ((y_k, h_k), (y_r, h_r)):
        _close(y, np.asarray(want_y).transpose(0, 2, 1, 3), SCAN)
        _close(h, want_h, SCAN)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_dtypes_match_jax_kernel(dtype):
    """x, Bm, Cm in ``dtype``, dt and A f32; y comes back in ``dtype``."""
    x, dt, A, Bm, Cm = _scan_inputs(1, 1, 128, 2, 16, 16)
    jdt = getattr(jnp, dtype)
    jx = jnp.asarray(x.transpose(0, 2, 1, 3), jdt)
    jB, jC = jnp.asarray(Bm, jdt), jnp.asarray(Cm, jdt)
    y_k, _ = ssd_scan_bhsp(jx, jnp.asarray(dt.transpose(0, 2, 1)),
                           jnp.asarray(A), jB, jC, chunk=64, interpret=True)
    tdt = getattr(torch, dtype)
    y, h = ops.ssd_scan(torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
                        torch.from_numpy(A), torch.from_numpy(Bm).to(tdt),
                        torch.from_numpy(Cm).to(tdt))
    assert y.dtype == tdt and h.dtype == torch.float32
    tol = SCAN if dtype == "float32" else SCAN_BF16
    _close(y, np.asarray(y_k, np.float32).transpose(0, 2, 1, 3), tol)


@pytest.mark.parametrize("S,h0", [(100, False), (100, True), (192, True)])
def test_ssd_scan_matches_jax_ssd_chunked(S, h0):
    """A ragged S runs as one chunk, as JAX's apply_mamba runs it; a
    non-zero initial state is carried in."""
    x, dt, A, Bm, Cm = _scan_inputs(S, 2, S, 3, 16, 8)
    h0_np = (np.random.default_rng(5).standard_normal((2, 3, 16, 8))
             .astype(np.float32) if h0 else None)
    ck = 64 if S % 64 == 0 else S
    y_j, h_j = JS.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                              h0=None if h0_np is None else jnp.asarray(h0_np),
                              chunk=ck)
    y, h = ops.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
                        h0=None if h0_np is None else torch.from_numpy(h0_np))
    _close(y, y_j, LAYER)
    _close(h, h_j, LAYER)


@pytest.mark.parametrize("h0", [False, True])
def test_ssd_reference_matches_jax(h0):
    x, dt, A, Bm, Cm = _scan_inputs(3, 2, 40, 3, 8, 8)
    h0_np = (np.random.default_rng(6).standard_normal((2, 3, 8, 8))
             .astype(np.float32) if h0 else None)
    y_j, h_j = JS.ssd_reference(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                                h0=None if h0_np is None else jnp.asarray(h0_np))
    y, h = ssd_reference(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
                         h0=None if h0_np is None else torch.from_numpy(h0_np))
    _close(y, y_j, LAYER)
    _close(h, h_j, LAYER)
    # and the chunked scan with a state agrees with the sequential one
    yc, hc = ops.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
                          h0=None if h0_np is None else torch.from_numpy(h0_np))
    _close(yc, y.numpy(), SCAN)
    _close(hc, h.numpy(), SCAN)


def test_ssd_scan_reference_layout_matches_jax():
    x, dt, A, Bm, Cm = _scan_inputs(4, 1, 32, 2, 8, 8)
    xk, dtk = x.transpose(0, 2, 1, 3).copy(), dt.transpose(0, 2, 1).copy()
    y_j, h_j = jax_ssd_scan_reference(*(jnp.asarray(a) for a in (xk, dtk, A, Bm, Cm)))
    y, h = ssd_scan_reference(*(torch.from_numpy(a) for a in (xk, dtk, A, Bm, Cm)))
    _close(y, y_j, LAYER)
    _close(h, h_j, LAYER)


def test_ssd_scan_reads_strided_slices():
    """The op takes x, Bm, Cm as strided views of one tensor, as
    apply_mamba hands them over, and gives what contiguous copies give."""
    x, dt, A, Bm, Cm = _scan_inputs(8, 2, 64, 2, 8, 4)
    packed = torch.cat([torch.from_numpy(x).reshape(2, 64, 16),
                        torch.from_numpy(Bm), torch.from_numpy(Cm)], dim=-1)
    xv, Bv, Cv = torch.split(packed, [16, 4, 4], dim=-1)
    got = ops.ssd_scan(xv.reshape(2, 64, 2, 8), torch.from_numpy(dt),
                       torch.from_numpy(A), Bv, Cv)
    want = ops.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)))
    assert not xv.is_contiguous()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cpu_path_never_launches_the_kernel():
    before = ops.ssd_scan.launches
    ops.ssd_scan(*(torch.from_numpy(a) for a in _scan_inputs(1, 1, 64, 2, 8, 8)))
    assert ops.ssd_scan.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The launcher takes CUDA tensors only: it never runs the plain
    version in the kernel's place."""
    args = [torch.from_numpy(a) for a in _scan_inputs(1, 1, 64, 2, 8, 8)]
    with pytest.raises(ValueError, match="CUDA"):
        tssd.launch(*args)


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def _cfg(arch="mamba2-130m", **kw):
    return get_config(arch).reduced(**kw)


def _mamba_params(rng, cfg):
    D, di, N, H, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    conv_dim = di + 2 * N

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"in_proj": normal((D, 2 * di + 2 * N + H), D ** -0.5),
            "conv_w": normal((K, conv_dim), K ** -0.5),
            "conv_b": normal((conv_dim,), 0.1),
            "A_log": np.log(np.linspace(1.0, 16.0, H)).astype(np.float32),
            "D": normal((H,), 0.2) + 1.0,
            "dt_bias": normal((H,), 0.5),
            "norm_scale": normal((di,), 0.1) + 1.0,
            "out_proj": normal((di, D), di ** -0.5)}


BF16_LEAVES = ("in_proj", "conv_w", "conv_b", "out_proj")


def _both(params, dtype="float32"):
    """numpy params -> (jax, torch); the matrices and conv in ``dtype``,
    A_log, D, dt_bias, norm_scale f32, as init_mamba makes them."""
    jp, tp = {}, {}
    for k, a in params.items():
        d = dtype if k in BF16_LEAVES else "float32"
        jp[k] = jnp.asarray(a, getattr(jnp, d))
        tp[k] = torch.from_numpy(a).to(getattr(torch, d))
    return jp, tp


def _cache(cfg, B, rng=None):
    """(jax cache, torch cache) of f32, zero or drawn from ``rng``."""
    base = TS.init_mamba_cache(cfg, B, torch.float32, device="cpu")
    arrays = {k: (rng.standard_normal(tuple(v.shape)).astype(np.float32) * 0.5
                  if rng is not None else np.zeros(tuple(v.shape), np.float32))
              for k, v in base.items()}
    return ({k: jnp.asarray(a) for k, a in arrays.items()},
            {k: torch.from_numpy(a.copy()) for k, a in arrays.items()})


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    state = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    y_j, s_j = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               None if state is None else jnp.asarray(state))
    y, s = TS._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b),
                           None if state is None else torch.from_numpy(state))
    _close(y, y_j, dict(rtol=1e-6, atol=1e-6))
    _close(s, s_j, dict(rtol=0, atol=0))


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(12)
    b, H, P, N = 2, 3, 8, 4
    h = rng.standard_normal((b, H, P, N)).astype(np.float32)
    xt = rng.standard_normal((b, H, P)).astype(np.float32)
    dtt = np.log1p(np.exp(rng.standard_normal((b, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bt = rng.standard_normal((b, N)).astype(np.float32)
    Ct = rng.standard_normal((b, N)).astype(np.float32)
    h_j, y_j = JS.ssd_decode_step(*(jnp.asarray(a) for a in (h, xt, dtt, A, Bt, Ct)))
    h_t, y_t = TS.ssd_decode_step(*(torch.from_numpy(a) for a in (h, xt, dtt, A, Bt, Ct)))
    _close(h_t, h_j, dict(rtol=1e-6, atol=1e-6))
    _close(y_t, y_j, dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("S", [16, 64, 100])
def test_apply_mamba_no_cache_matches_jax(S):
    cfg = _cfg()
    rng = np.random.default_rng(13)
    jp, tp = _both(_mamba_params(rng, cfg))
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    want, jc = JS.apply_mamba(jp, jnp.asarray(x), cfg)
    got, tc = TS.apply_mamba(tp, torch.from_numpy(x), cfg)
    assert jc is None and tc is None
    _close(got, want, LAYER)


@pytest.mark.parametrize("dtype,tol", [("float32", LAYER), ("bfloat16", BF16)])
def test_apply_mamba_cache_prefill_then_decode(dtype, tol):
    """Prefill with an f32 cache, then one decode step.  With bf16 params
    the f32 conv state promotes the conv, the scan and y to f32 in
    prefill, and decode rounds y to bf16 before the D skip: both
    packages do both."""
    cfg = dataclasses.replace(_cfg(), param_dtype=dtype)
    rng = np.random.default_rng(14)
    jp, tp = _both(_mamba_params(rng, cfg), dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcache, tcache = _cache(cfg, 2)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    want, jcache = JS.apply_mamba(jp, jnp.asarray(x, jdt), cfg, cache=jcache)
    got, tcache = TS.apply_mamba(tp, torch.from_numpy(x).to(tdt), cfg,
                                 cache=tcache)
    assert got.dtype == tdt and want.dtype == jdt
    assert tcache["conv"].dtype == torch.float32 and tcache["ssm"].dtype == torch.float32
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    _close(got / scale, np.asarray(want, np.float32) / scale, tol)
    # the f32 states agree to f32 precision: a bf16 conv or scan would
    # miss by ~1e-1 here while the bf16 outputs stayed within 2e-2
    for k in ("conv", "ssm"):
        _close(tcache[k], jcache[k], LAYER)

    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    want, jcache = JS.apply_mamba(jp, jnp.asarray(x1, jdt), cfg, cache=jcache)
    got, tcache = TS.apply_mamba(tp, torch.from_numpy(x1).to(tdt), cfg,
                                 cache=tcache)
    _close(got / scale, np.asarray(want, np.float32) / scale, tol)
    for k in ("conv", "ssm"):
        _close(tcache[k], jcache[k], LAYER)


def test_apply_mamba_prefill_carries_a_nonzero_cache():
    """A multi-token step on a live cache: the conv state pads the
    sequence and the SSM state enters the scan as h0."""
    cfg = _cfg()
    rng = np.random.default_rng(15)
    jp, tp = _both(_mamba_params(rng, cfg))
    jcache, tcache = _cache(cfg, 2, rng)
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    want, jcache = JS.apply_mamba(jp, jnp.asarray(x), cfg, cache=jcache)
    got, tcache = TS.apply_mamba(tp, torch.from_numpy(x), cfg, cache=tcache)
    _close(got, want, LAYER)
    for k in ("conv", "ssm"):
        _close(tcache[k], jcache[k], LAYER)


def test_init_mamba_scales_and_dtypes():
    cfg = dataclasses.replace(get_config("mamba2-130m"), num_layers=1)
    g = torch.Generator().manual_seed(0)
    p = TS.init_mamba(g, cfg, torch.bfloat16, "cpu")
    want = jax_config("mamba2-130m")
    di, N, H = want.d_inner, want.ssm_state, want.ssm_heads
    assert p["in_proj"].shape == (768, 2 * di + 2 * N + H)
    assert p["conv_w"].shape == (4, di + 2 * N)
    for k in BF16_LEAVES:
        assert p[k].dtype == torch.bfloat16, k
    for k in ("A_log", "D", "dt_bias", "norm_scale"):
        assert p[k].dtype == torch.float32, k
    assert abs(p["conv_w"].float().std().item() - 0.5) < 0.01
    assert abs(p["in_proj"].float().std().item() - 768 ** -0.5) < 1e-3
    np.testing.assert_allclose(p["A_log"].numpy(), np.log(np.linspace(1, 16, H)),
                               rtol=1e-6)
    assert p["conv_b"].abs().max() == 0 and p["dt_bias"].abs().max() == 0
