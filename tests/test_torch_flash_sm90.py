"""The bf16 tensor-core flash kernel's arithmetic, and every kernel's C
interface against its ctypes binding, on the CPU.

``csrc/flash_attention_sm90.cu`` runs only on the card.  Here a test-local
emulation repeats its rounding points (64 x 64 tiles over the same KV
range, scores in f32 scaled in log2 units, online softmax in f32, P
rounded to bf16 before P V, output rounded to bf16) and is held against
JAX's ``attention_reference`` on the same numpy inputs, so the one new
rounding point (P in bf16, where the JAX kernel multiplies P in f32) is
shown to stay inside the bf16 tolerance before the card sees it.  The
kernel itself is held against the plain version on the card by
``chip_smoke.py``.

The binding test parses the ``extern "C"`` declarations of every
``kernels/csrc/*.cu`` and holds the number and kind of their parameters
against the ``argtypes`` its library's ``_bind`` sets: a mismatch there
shows only on the card, as a cut pointer.
"""
import ctypes
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.kernels.ref import attention_reference as jax_reference
from repro_torch.kernels import adamw as tadamw
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd_scan as tssd

# bf16, as tests/test_kernels.py and chip_smoke.py
TOL = dict(rtol=2e-2, atol=2e-2)
TILE = 64
NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _bf16(a):
    return torch.as_tensor(a).to(torch.bfloat16).float()


def sm90_emulation(q, k, v, *, causal, window):
    """The bf16 kernel's arithmetic: q (B, S, H, D), k, v (B, S, KH, D)
    bf16-valued f32 tensors -> (B, S, H, D) bf16-valued f32."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    pad = -S % TILE                      # TMA fills rows past S with zeros
    heads = torch.arange(H) // (H // KH)
    qh = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad)).transpose(1, 2)
    kh = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))[:, :, heads].transpose(1, 2)
    vh = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))[:, :, heads].transpose(1, 2)
    scale_log2 = D ** -0.5 * LOG2E
    out = torch.zeros_like(qh)
    for q0 in range(0, S, TILE):
        q_last = min(q0 + TILE, S) - 1
        kv_end = q_last + 1 if causal else S
        kv_begin = max(0, q0 - window + 1) if window else 0
        qpos = torch.arange(q0, q0 + TILE)[:, None]
        m = torch.full((B, H, TILE, 1), NEG_INF)
        l = torch.zeros((B, H, TILE, 1))
        acc = torch.zeros((B, H, TILE, D))
        for k0 in range(kv_begin // TILE * TILE, kv_end, TILE):
            kt = kh[:, :, k0:k0 + TILE]
            s = qh[:, :, q0:q0 + TILE] @ kt.transpose(-1, -2) * scale_log2
            edge = (k0 + TILE > S or (causal and k0 + TILE - 1 > q0)
                    or (window and k0 <= q0 + TILE - 1 - window))
            if edge:
                kpos = torch.arange(k0, k0 + TILE)[None, :]
                keep = kpos < S
                if causal:
                    keep = keep & (kpos <= qpos)
                if window:
                    keep = keep & (kpos > qpos - window)
                s = torch.where(keep, s, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + _bf16(p) @ vh[:, :, k0:k0 + TILE]
            m = m_new
        out[:, :, q0:q0 + TILE] = acc / torch.clamp(l, min=1e-30)
    return _bf16(out[:, :, :S].transpose(1, 2))


def _inputs(seed, B, S, H, KH, D):
    rng = np.random.default_rng(seed)
    return [_bf16(rng.standard_normal(shape, dtype=np.float32))
            for shape in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D))]


def _jax(q, k, v, *, causal, window):
    """JAX's reference on the same bf16 values, GQA heads repeated."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]

    def bhsd(t):
        a = np.repeat(t.numpy(), rep, axis=2) if t.shape[2] != H else t.numpy()
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * H, S, D),
                           jnp.bfloat16)

    out = jax_reference(bhsd(q), bhsd(k), bhsd(v), causal=causal, window=window)
    return np.asarray(out, np.float32).reshape(B, H, S, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("heads", [(2, 2), (6, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S", [100, 512])
def test_sm90_rounding_matches_jax_reference(S, D, heads, window):
    H, KH = heads
    q, k, v = _inputs(S + D + H + (window or 0), 1, S, H, KH, D)
    got = sm90_emulation(q, k, v, causal=True, window=window)
    want = _jax(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("S", [100, 512])
def test_sm90_rounding_matches_jax_reference_noncausal(S):
    q, k, v = _inputs(S, 1, S, 4, 2, 64)
    got = sm90_emulation(q, k, v, causal=False, window=None)
    want = _jax(q, k, v, causal=False, window=None)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bodies_route_by_dtype():
    """bf16 goes to the tensor-core source, f32 to the CUDA-core one."""
    assert tfa.BODIES[torch.bfloat16].source.name == "flash_attention_sm90.cu"
    assert tfa.BODIES[torch.float32].source.name == "flash_attention.cu"
    assert all(body.source.exists() for body in tfa.BODIES.values())


DECLARATION = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')
CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
          "long long": ctypes.c_longlong}


def _ctype(param: str):
    """ctypes type for one C parameter ``[const] type [*] name``."""
    if "*" in param:
        return ctypes.c_void_p
    words = [w for w in param.split()[:-1] if w != "const"]
    return CTYPES[" ".join(words)]


def _libraries():
    return [lib for module in (tfa, tssd, tadamw, tdec) for lib in vars(module).values()
            if isinstance(lib, build.KernelLibrary)]


class _RecordingLib:
    """Stands in for a ``ctypes.CDLL``: records what ``_bind`` sets."""

    def __init__(self):
        self.functions = {}

    def __getattr__(self, name):
        return self.functions.setdefault(name, types.SimpleNamespace())


def test_every_source_has_a_library():
    sources = {lib.source for lib in _libraries()}
    assert sources == set(build.CSRC.glob("*.cu"))


@pytest.mark.parametrize("source", sorted(p.name for p in build.CSRC.glob("*.cu")))
def test_ctypes_argtypes_match_the_c_declarations(source):
    lib, = [lib for lib in _libraries() if lib.source.name == source]
    declared = DECLARATION.findall(lib.source.read_text())
    assert declared, f"{source} declares no extern \"C\" int function"
    recorded = _RecordingLib()
    lib.bind(recorded)
    assert set(recorded.functions) == {name for name, _ in declared}
    for name, params in declared:
        want = [_ctype(" ".join(p.split())) for p in params.split(",")]
        fn = recorded.functions[name]
        assert fn.restype is ctypes.c_int, name
        assert len(fn.argtypes) == len(want), (name, len(fn.argtypes), len(want))
        assert list(fn.argtypes) == want, name


def test_emulation_keeps_the_bf16_rounding_of_p():
    """The emulation is not the reference in disguise: its rounding
    points move the output, by less than the tolerance."""
    q, k, v = _inputs(7, 1, 128, 2, 2, 64)
    got = sm90_emulation(q, k, v, causal=True, window=None).numpy()
    want = _jax(q, k, v, causal=True, window=None)
    diff = np.abs(got - want).max()
    assert 0 < diff < TOL["atol"]
