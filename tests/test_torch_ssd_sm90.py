"""The tensor-core SSD scan's arithmetic, on the CPU.

``csrc/ssd_scan.cu`` runs only on the card.  Here a test-local emulation
repeats its decomposition: C Bᵀ formed once per (batch, chunk) in f32 and
shared by every head, the state cut into tiles of P rows that run
independently, M formed in f32 before it is split, and the three chunk
products (C hᵀ, each row then scaled by exp(L), M x and (x w)ᵀ B) in
3xTF32: each f32 operand split into hi, a cut to TF32's 10 mantissa bits
(its low 13 bits cleared), and lo = a - hi, which the tensor core reads at
TF32 precision (its low 13 bits cleared here too), with hi·hi in one sum
and hi·lo + lo·hi in another, both f32.  The emulation is held
against JAX's ``ssd_chunked`` and ``ssd_reference`` on the same numpy
inputs, at the f32 tolerance ``chip_smoke.py`` holds the kernel to, before
the card sees it; one case shows why the split is there: single-pass TF32
misses that tolerance by far.  The kernel itself is held against the plain
version on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from _tf32 import mm_3xtf32, mm_tf32, split, tf32
from repro.models import ssm as JS

CHUNK = 64
TOL = dict(rtol=2e-3, atol=2e-3)    # f32, as chip_smoke.py's SSD cases


def kernel_emulation(x, dt, A, Bm, Cm, h0=None, *, mm=mm_3xtf32, tile_p=32):
    """x (b, S, H, P), dt (b, S, H), A (H,), Bm, Cm (b, S, N), h0
    (b, H, P, N) or None, all f32 -> y (b, S, H, P), h_final (b, H, P, N)."""
    b, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // CHUNK)
    pad = nc * CHUNK - S                 # rows past S load as zeros
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad)).reshape(b, nc, CHUNK, N)
    Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad)).reshape(b, nc, CHUNK, N)
    causal = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool))
    # the first kernel: C B^T once per (batch, chunk), f32 on the CUDA cores
    cb = torch.where(causal, Cm @ Bm.transpose(-1, -2), 0.0)
    y = torch.zeros(b, nc * CHUNK, H, P)
    h_final = torch.zeros(b, H, P, N)
    for p0 in range(0, P, tile_p):       # one block per tile of P rows
        xs = x[..., p0:p0 + tile_p].reshape(b, nc, CHUNK, H, -1)
        h = (torch.zeros(b, H, xs.shape[-1], N) if h0 is None
             else h0[:, :, p0:p0 + tile_p].clone())
        for c in range(nc):
            dtc = dt[:, c * CHUNK:(c + 1) * CHUNK].transpose(1, 2)     # (b, H, Q)
            L = torch.cumsum(dtc * A[None, :, None], dim=-1)
            delta = torch.where(causal, L[..., :, None] - L[..., None, :], 0.0)
            M = torch.where(causal, cb[:, c, None] * torch.exp(delta)
                            * dtc[..., None, :], 0.0)                   # (b, H, t, s)
            xc = xs[:, c].transpose(1, 2)                              # (b, H, s, pt)
            yc = (torch.exp(L)[..., None] * mm(Cm[:, c, None], h.transpose(-1, -2))
                  + mm(M, xc))
            w = torch.exp(L[..., -1:] - L) * dtc
            h = (torch.exp(L[..., -1])[..., None, None] * h
                 + mm((xc * w[..., None]).transpose(-1, -2), Bm[:, c, None]))
            y[:, c * CHUNK:(c + 1) * CHUNK, :, p0:p0 + tile_p] = yc.transpose(1, 2)
        h_final[:, :, p0:p0 + tile_p] = h
    return y[:, :S], h_final


def _inputs(seed, b, S, H, P, N, h0):
    """chip_smoke.py's distribution: normal x, B, C and h0, dt softplus of
    a normal, A minus the exp of one."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((b, S, N), dtype=np.float32)
    Cm = rng.standard_normal((b, S, N), dtype=np.float32)
    h = rng.standard_normal((b, H, P, N), dtype=np.float32) if h0 else None
    return x, dt, A, Bm, Cm, h


def _emulate(arrays, **kw):
    x, dt, A, Bm, Cm, h0 = arrays
    y, h = kernel_emulation(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
                            h0=None if h0 is None else torch.from_numpy(h0), **kw)
    return y.numpy(), h.numpy()


def _jax(fn, arrays, **kw):
    x, dt, A, Bm, Cm, h0 = arrays
    y, h = fn(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
              h0=None if h0 is None else jnp.asarray(h0), **kw)
    return np.asarray(y, np.float32), np.asarray(h, np.float32)


@pytest.mark.parametrize("S,h0", [(192, False), (100, True), (256, True)],
                         ids=["S192", "ragged-S100-h0", "S256-h0"])
@pytest.mark.parametrize("P", [48, 64])
@pytest.mark.parametrize("N", [16, 128])
def test_3xtf32_emulation_matches_jax(N, P, S, h0):
    """The kernel's decomposition and rounding against JAX's chunked SSD
    (one chunk of all S when S is ragged, as JAX's apply_mamba runs it)
    and its sequential oracle."""
    arrays = _inputs(S + P + N, 1, S, 2, P, N, h0)
    y, h = _emulate(arrays)
    chunk = CHUNK if S % CHUNK == 0 else S
    for want_y, want_h in (_jax(JS.ssd_chunked, arrays, chunk=chunk),
                           _jax(JS.ssd_reference, arrays)):
        np.testing.assert_allclose(y, want_y, **TOL)
        np.testing.assert_allclose(h, want_h, **TOL)


@pytest.mark.parametrize("tile_p", [16, 64])
def test_p_tiles_are_independent(tile_p):
    """Any tile of P rows gives what the 32-row tile gives: each block's
    state rows depend on its own columns of x alone."""
    arrays = _inputs(3, 2, 128, 2, 64, 32, True)
    want = _emulate(arrays, tile_p=32)
    got = _emulate(arrays, tile_p=tile_p)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_3xtf32_error_is_far_below_single_pass_tf32():
    """Why the kernel splits its operands: at mamba2-130m's N = 128 the
    split's error is at least 100x below single-pass TF32's, which misses
    the f32 tolerance."""
    arrays = _inputs(11, 1, 256, 2, 64, 128, True)
    want_y, want_h = _jax(JS.ssd_reference, arrays)
    err = {}
    for name, mm in (("3xtf32", mm_3xtf32), ("tf32", mm_tf32)):
        y, h = _emulate(arrays, mm=mm)
        err[name] = max(np.abs(y - want_y).max(), np.abs(h - want_h).max())
    assert err["3xtf32"] * 100 <= err["tf32"], err
    assert err["3xtf32"] < TOL["atol"] < err["tf32"], err


def test_split_keeps_f32_products():
    """hi is TF32 within 2^-10 of a, lo = a - hi is exact in f32, and what
    the tensor core reads of the pair is within 2^-20 of a."""
    a = torch.from_numpy(np.random.default_rng(1).standard_normal(
        100000, dtype=np.float32) * 100)
    hi, lo = split(a)
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)
    assert torch.all(lo.view(torch.int32) & 0x1FFF == 0)
    assert torch.all((a - hi).abs() <= a.abs() * 2**-10)
    assert torch.equal((a - hi) + hi, a)
    err = (hi.double() + lo.double() - a.double()).abs()
    assert torch.all(err <= a.abs().double() * 2**-20)


def test_tf32_rounds_to_nearest_ties_away():
    a = torch.tensor([1.0, 1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 1 + 3 * 2**-11,
                      -3.0e-3, 0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + 2**-10, -(1 + 2**-10), 1.0, 1 + 2**-9,
                         tf32(torch.tensor([-3.0e-3])).item(), 0.0])
    got = tf32(a)
    assert torch.equal(got, want)
    assert torch.all(got.view(torch.int32) & 0x1FFF == 0)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(1000,
                                                                  dtype=np.float32))
    assert torch.all((tf32(r) - r).abs() <= r.abs() * 2**-11)
