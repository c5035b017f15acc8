"""The port's flash-attention wrapper against the JAX package's kernel.

On the CPU ``repro_torch.kernels.ops.flash_attention`` runs its plain
version; the JAX side runs the Pallas kernel in interpret mode and its
jnp oracle, on the same numpy inputs.  The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py``.  Also the
shared build helper (``kernels/build.py``), with a stand-in for nvcc.
"""
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_bhsd
from repro.kernels.ref import attention_reference as jax_reference
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_reference

# f32: as tests/test_kernels.py.  bf16: both sides compute in f32 and
# round once to bf16, so they differ by at most about one bf16 ulp of
# outputs of magnitude < 2 (2^-7 ~ 0.008), inside tests/test_kernels.py's
# 2e-2.
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(seed, B, S, H, KH, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, KH, D), dtype=np.float32)
    v = rng.standard_normal((B, S, KH, D), dtype=np.float32)
    return q, k, v


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _bhsd(a):
    """(B, S, H, D) numpy -> (B*H, S, D) numpy."""
    B, S, H, D = a.shape
    return a.transpose(0, 2, 1, 3).reshape(B * H, S, D)


def _np(t):
    return t.float().numpy()


def _port(q, k, v, dtype, **kw):
    out = ops.flash_attention(_torch(q, dtype), _torch(k, dtype),
                              _torch(v, dtype), **kw)
    assert out.dtype == getattr(torch, dtype)
    return _bhsd(_np(out))


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax(S, D, dtype):
    q, k, v = _inputs(S + D, 1, S, 2, 2, D)
    jq, jk, jv = (jnp.asarray(_bhsd(a), getattr(jnp, dtype)) for a in (q, k, v))
    kernel = np.asarray(flash_attention_bhsd(jq, jk, jv, causal=True,
                                             block_q=64, block_k=64,
                                             interpret=True), np.float32)
    ref = np.asarray(jax_reference(jq, jk, jv, causal=True), np.float32)
    out = _port(q, k, v, dtype, causal=True)
    np.testing.assert_allclose(out, kernel, **TOL[dtype])
    np.testing.assert_allclose(out, ref, **TOL[dtype])


@pytest.mark.parametrize("window", [32, 64])
def test_flash_attention_window_matches_jax(window):
    q, k, v = _inputs(window, 1, 256, 2, 2, 64)
    jq, jk, jv = (jnp.asarray(_bhsd(a)) for a in (q, k, v))
    kernel = np.asarray(flash_attention_bhsd(jq, jk, jv, causal=True,
                                             window=window, block_q=64,
                                             block_k=64, interpret=True))
    ref = np.asarray(jax_reference(jq, jk, jv, causal=True, window=window))
    out = _port(q, k, v, "float32", causal=True, window=window)
    np.testing.assert_allclose(out, kernel, **TOL["float32"])
    np.testing.assert_allclose(out, ref, **TOL["float32"])


def test_flash_attention_gqa_matches_jax():
    B, S, H, KH, D = 2, 128, 8, 2, 64
    q, k, v = _inputs(0, B, S, H, KH, D)
    want = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), block_q=64,
                                           block_k=64))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v))
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL["float32"])


@pytest.mark.parametrize("window", [None, 32])
def test_flash_attention_ragged_matches_reference(window):
    """Any S: the JAX kernel asserts S % block == 0, its oracle does not."""
    q, k, v = _inputs(100, 1, 100, 2, 2, 64)
    jq, jk, jv = (jnp.asarray(_bhsd(a)) for a in (q, k, v))
    ref = np.asarray(jax_reference(jq, jk, jv, causal=True, window=window))
    out = _port(q, k, v, "float32", causal=True, window=window)
    np.testing.assert_allclose(out, ref, **TOL["float32"])


def test_attention_reference_matches_jax_noncausal():
    q, k, v = (_bhsd(a) for a in _inputs(3, 1, 64, 2, 2, 64))
    want = np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=False))
    got = attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL["float32"])


def test_cpu_path_never_launches_the_kernel():
    before = ops.flash_attention.launches
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 64, 2, 2, 64))
    ops.flash_attention(q, k, v)
    assert ops.flash_attention.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The launcher takes CUDA tensors only: it never runs the plain
    version in the kernel's place."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 64, 2, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.launch(q, k, v, causal=True, window=None)


def test_empty_window_is_refused():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 64, 2, 2, 64))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=0)


def _fake_nvcc(tmp_path, body):
    """A stand-in for nvcc: a shell script with ``body`` (``$out`` is the
    path after -o)."""
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\nwhile [ \"$1\" != -o ]; do shift; done\n"
                      f"out=$2\n{body}\n")
    script.chmod(0o755)
    return str(script)


def _libraries(tmp_path, monkeypatch, names, nvcc):
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    csrc.mkdir(exist_ok=True)
    for name in names:
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build, "_nvcc", lambda: nvcc)
    return [build.KernelLibrary(name, bind=None) for name in names]


def test_build_helper_builds_each_source_once(tmp_path, monkeypatch):
    """One library per source, keyed by its hash; a built one is reused."""
    from repro_torch.kernels import build
    nvcc = _fake_nvcc(tmp_path, 'echo "ptxas info : Used 8 registers"; '
                                'echo built > "$out"')
    libs = _libraries(tmp_path, monkeypatch, ["one", "two"], nvcc)
    assert libs[0].path().parent != libs[1].path().parent
    for lib in libs:
        lib.build()
    for lib in libs:
        assert lib.path().read_text() == "built\n"
        assert lib.build_seconds is not None and "registers" in lib.build_log
        assert lib.lib is None                       # built, not loaded
    again = build.KernelLibrary("one", bind=None)
    again.build()
    assert again.build_seconds is None
    built = again.path()
    (tmp_path / "csrc" / "one.cu").write_text("// changed\n")
    assert again.path() != built


def test_a_changed_header_keys_a_new_build(tmp_path, monkeypatch):
    """A source's library is keyed by the shared headers of ``csrc/`` too,
    which nvcc finds there."""
    argv = tmp_path / "argv"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f'#!/bin/sh\necho "$@" > {argv}\n'
                    'while [ "$1" != -o ]; do shift; done\necho built > "$2"\n')
    nvcc.chmod(0o755)
    lib, = _libraries(tmp_path, monkeypatch, ["one"], str(nvcc))
    (tmp_path / "csrc" / "common.cuh").write_text("// shared\n")
    before = lib.path()
    (tmp_path / "csrc" / "common.cuh").write_text("// shared, changed\n")
    assert lib.path() != before
    lib.build()
    assert f"-I {tmp_path / 'csrc'} " in argv.read_text()


def test_build_helper_raises_with_the_nvcc_log(tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, 'echo "error: no such intrinsic"; exit 2')
    lib, = _libraries(tmp_path, monkeypatch, ["bad"], nvcc)
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        lib.load()
    assert lib.lib is None and not lib.path().exists()
    assert not list(lib.path().parent.iterdir())    # no partial output left
