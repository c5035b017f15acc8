"""The f32 flash body's 3xTF32 decomposition, on the CPU.

``csrc/flash_attention.cu`` runs only on the card.  Here a test-local
emulation repeats its decomposition: blocks of 16·RW query rows, each 16
of them DS warps, each with D/DS columns of Q Kᵀ's reduction (the partial
scores added in warp order) and of the output; the block's KV tiles of BK
keys from the window's edge to the causal frontier, dealt round-robin to
KS groups, a warp skipping any tile none of its rows attends and masking
only tiles that straddle a boundary; Q scaled by D**-0.5·log2(e), the online softmax in log2 units with exp2
over each group's tiles, then the groups' (m, l, acc) merged; the
reduction index of Q Kᵀ (d) and of P V (the key) permuted within each
8-wide k-step as the kernel's fragments read them; and both products in
3xTF32, Q, K, P and V each split into hi + lo (``_tf32.split``), the row
sum adding the unsplit P.  RW, DS, KS and BK per head dim are the
kernel's ``Config<D>``.

The emulation is held against JAX's ``attention_reference`` and the
Pallas kernel in interpret mode on the same numpy inputs, at the f32
tolerance ``chip_smoke.py`` holds the kernel to; one case shows why the
split is there: single-pass TF32 misses that tolerance.  The kernel itself
is held against the plain version on the card by ``chip_smoke.py``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from _tf32 import mm_3xtf32, mm_tf32
from repro.kernels.flash_attention import flash_attention_bhsd
from repro.kernels.ref import attention_reference as jax_reference
from repro_torch.kernels import flash_attention as tfa

TOL = dict(rtol=2e-4, atol=2e-4)     # f32, as chip_smoke.py's f32 cases
NEG_INF = -1e30
LOG2E = 1.4426950408889634
# (RW, DS, KS, BK) per D, as csrc/flash_attention.cu's Config<D>
CONFIG = {64: (2, 1, 2, 32), 128: (2, 1, 2, 16), 256: (2, 2, 2, 16)}
# within each k-step of 8, fragment slot t reads index 2t and slot t + 4
# index 2t + 1: the order of the indices along the mma's k
SLOTS = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def _permuted(n: int) -> torch.Tensor:
    """The kernel's order of n reduction indices, k-step by k-step."""
    return (torch.arange(0, n, 8)[:, None] + SLOTS[None, :]).reshape(-1)


def tc32_emulation(q, k, v, *, causal, window, mm=mm_3xtf32, config=None):
    """The f32 body's decomposition: q (B, S, H, D), k, v (B, S, KH, D) f32
    -> (B, S, H, D) f32."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    RW, DS, KS, BK = config or CONFIG[D]
    BQ = 16 * RW
    heads = torch.arange(H) // (H // KH)
    pad_k = -S % BK                      # rows past S load as zeros
    qh = (q * (D ** -0.5 * LOG2E)).transpose(1, 2)[..., _permuted(D)]
    kh = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))[:, :, heads]
    kh = kh.transpose(1, 2)[..., _permuted(D)]
    vh = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))[:, :, heads].transpose(1, 2)
    out = torch.zeros(B, H, S, D)
    for q0 in range(0, S, BQ):
        q_last = min(q0 + BQ, S) - 1
        kv_end = q_last + 1 if causal else S
        kv_begin = max(0, q0 - window + 1) if window else 0
        kt0 = kv_begin // BK
        n_tiles = -(-kv_end // BK) - kt0
        for r0 in range(q0, min(q0 + BQ, S), 16):       # one warp's rows
            rows = torch.arange(r0, r0 + 16)[:, None]
            qw = torch.nn.functional.pad(qh[:, :, r0:r0 + 16],
                                         (0, 0, 0, 16 - min(16, S - r0)))
            states = []
            for group in range(KS):
                m = torch.full((B, H, 16, 1), NEG_INF)
                l = torch.zeros(B, H, 16, 1)
                acc = torch.zeros(B, H, 16, D)
                for tile in range(group, n_tiles, KS):
                    k0 = (kt0 + tile) * BK
                    if causal and k0 > r0 + 15:
                        continue
                    if window and k0 + BK - 1 <= r0 - window:
                        continue
                    # the DS warps' partial scores over their D/DS columns,
                    # added in warp order
                    kt = kh[:, :, k0:k0 + BK].transpose(-1, -2)
                    part = D // DS
                    s = mm(qw[..., :part], kt[..., :part, :])
                    for j in range(1, DS):
                        cols = slice(j * part, (j + 1) * part)
                        s = s + mm(qw[..., cols], kt[..., cols, :])
                    if (k0 + BK > S or (causal and k0 + BK - 1 > r0)
                            or (window and k0 <= r0 + 15 - window)):
                        keys = torch.arange(k0, k0 + BK)[None, :]
                        keep = keys < S
                        if causal:
                            keep = keep & (keys <= rows)
                        if window:
                            keep = keep & (keys > rows - window)
                        s = torch.where(keep, s, torch.tensor(NEG_INF))
                    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(s - m_new)
                    l = alpha * l + p.sum(-1, keepdim=True)
                    keys = _permuted(BK)
                    acc = alpha * acc + mm(p[..., keys],
                                           vh[:, :, k0:k0 + BK][:, :, keys])
                    m = m_new
                states.append((m, l, acc))
            m, l, acc = states[0]
            for mo, lo, ao in states[1:]:
                m_new = torch.maximum(m, mo)
                a, b = torch.exp2(m - m_new), torch.exp2(mo - m_new)
                l, acc, m = a * l + b * lo, a * acc + b * ao, m_new
            n = min(16, S - r0)
            out[:, :, r0:r0 + n] = (acc / torch.clamp(l, min=1e-30))[:, :, :n]
    return out.transpose(1, 2)


def _inputs(seed, B, S, H, KH, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D))]


def _emulate(arrays, **kw):
    return tc32_emulation(*(torch.from_numpy(a) for a in arrays), **kw).numpy()


def _bhsd(a, H):
    """(B, S, heads, D) numpy -> (B*H, S, D), GQA heads repeated."""
    B, S, heads, D = a.shape
    a = np.repeat(a, H // heads, axis=2)
    return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * H, S, D))


def _jax(arrays, *, causal, window, pallas):
    """JAX's reference, or the Pallas kernel in interpret mode (S a
    multiple of its 64-row blocks)."""
    q, k, v = arrays
    B, S, H, D = q.shape
    jq, jk, jv = (_bhsd(a, H) for a in arrays)
    if pallas:
        out = flash_attention_bhsd(jq, jk, jv, causal=causal, window=window,
                                   block_q=64, block_k=64, interpret=True)
    else:
        out = jax_reference(jq, jk, jv, causal=causal, window=window)
    return np.asarray(out, np.float32).reshape(B, H, S, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 32)],
                         ids=["causal", "non-causal", "window32"])
@pytest.mark.parametrize("heads", [(2, 2), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_emulation_matches_jax_and_pallas(D, heads, causal, window):
    """S = 128: the reference and the Pallas kernel in interpret mode."""
    H, KH = heads
    arrays = _inputs(D + H + (window or 0) + causal, 1, 128, H, KH, D)
    got = _emulate(arrays, causal=causal, window=window)
    for pallas in (False, True):
        want = _jax(arrays, causal=causal, window=window, pallas=pallas)
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 32),
                                           (False, 32)],
                         ids=["causal", "non-causal", "window32",
                              "non-causal-window32"])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_emulation_ragged_gqa_matches_jax(D, causal, window):
    """Ragged S (the Pallas kernel asserts S % block == 0, its oracle does
    not), GQA 8/2 as chip_smoke.py's windowed f32 cases at S = 200; S = 100
    ends inside a warp's 16 rows and inside a tile."""
    for S in (100, 200):
        arrays = _inputs(S + D, 2 if S == 100 else 1, S, 8, 2, D)
        got = _emulate(arrays, causal=causal, window=window)
        want = _jax(arrays, causal=causal, window=window, pallas=False)
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("S", [1, 8, 17])
def test_emulation_short_sequences(S):
    """Shorter than one warp's rows, as the reduced serves prefill (S = 8)."""
    arrays = _inputs(S, 1, S, 4, 4, 64)
    got = _emulate(arrays, causal=True, window=None)
    want = _jax(arrays, causal=True, window=None, pallas=False)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("config", [(4, 1, 1, 32), (1, 1, 4, 16), (2, 1, 3, 8),
                                    (2, 4, 2, 16)],
                         ids=["one-group", "four-groups", "three-groups",
                              "four-dim-splits"])
def test_groups_and_tiles_change_only_rounding(config):
    """The deal of KV tiles to groups and the merge, and the split of the
    head dim between warps, are reassociations: any (RW, DS, KS, BK) gives
    the kernel's result within rounding."""
    arrays = _inputs(5, 1, 160, 2, 2, 64)
    want = _emulate(arrays, causal=True, window=48)
    got = _emulate(arrays, causal=True, window=48, config=config)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_key_permutation_is_a_reassociation():
    """P's C fragment read as the A fragment, with V's rows permuted to
    match, gives P V: the permuted k order sums the same products."""
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.random((16, 32), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((32, 64), dtype=np.float32))
    keys = _permuted(32)
    assert sorted(keys.tolist()) == list(range(32))
    got = mm_3xtf32(p[:, keys], v[keys])
    torch.testing.assert_close(got, mm_3xtf32(p, v), rtol=1e-6, atol=1e-6)
    exact = p.double() @ v.double()
    assert torch.all((got.double() - exact).abs()
                     <= 2**-19 * (p.double().abs() @ v.double().abs()))
    # the fragment identity: C slots (2t, 2t+1) are A slots (t, t+4)
    for t in range(4):
        assert SLOTS[t] == 2 * t and SLOTS[t + 4] == 2 * t + 1


def test_3xtf32_meets_the_tolerance_where_single_pass_tf32_misses():
    """Why the kernel splits its operands: at D = 128 the split's error is
    far below single-pass TF32's, which misses the f32 tolerance."""
    arrays = _inputs(11, 1, 128, 2, 2, 128)
    want = _jax(arrays, causal=True, window=None, pallas=False)
    err = {name: np.abs(_emulate(arrays, causal=True, window=None, mm=mm)
                        - want).max()
           for name, mm in (("3xtf32", mm_3xtf32), ("tf32", mm_tf32))}
    assert err["3xtf32"] * 20 <= err["tf32"], err
    assert err["3xtf32"] < TOL["atol"] < err["tf32"], err


def test_emulation_config_is_the_kernels():
    """CONFIG repeats Config<D> of csrc/flash_attention.cu."""
    source = tfa.LIBRARY.source.read_text()
    found = {}
    for D, body in re.findall(r"struct Config<(\d+)> \{(.*?)\};", source, re.S):
        values = dict(re.findall(r"\b(RW|DS|KS|BK) = (\d+)", body))
        found[int(D)] = tuple(int(values[n]) for n in ("RW", "DS", "KS", "BK"))
    assert found == CONFIG
