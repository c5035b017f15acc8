"""The port's activation codecs and store against the JAX package's.

Each codec's encoded ``nbytes`` of a given tensor equals JAX's, and its
error stays within its bound (int8 ``scale/2``, bf16 ``2**-8`` relative,
top-k the smallest kept magnitude).  Boundary bytes of the store equal
JAX's; residual bytes count what autograd saves, so they are held only
within the port (the int8 store is at least 3x smaller, and a backward
through int8 residuals stays close to the exact one).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.core.runtime import activations as J
from repro_torch.configs import get_config
from repro_torch.core.runtime import activations as T
from repro_torch.core.runtime.cache import initial_params
from repro_torch.core.runtime.stages import StageCompute
from repro_torch.tree import leaves

SHAPES = [((64, 32), 1.0), ((8, 128), 37.5), ((100,), 1e-4), ((3, 5, 7), 1e3)]
CODECS = ["fp", "int8", "bf16", "topk"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tests' tensors are tiny; under several test workers torch's
    default of one thread per core oversubscribes the host many times."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(shape, mag, dtype, seed=0):
    a = (np.random.default_rng(seed).normal(size=shape) * mag).astype(np.float32)
    j = jnp.asarray(a, dtype=dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype])
    return t, j


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_codec_nbytes_equal_jax_and_error_bounded(name, dtype):
    tc, jc = T.make_codec(name), J.make_codec(name)
    for shape, mag in SHAPES:
        t, j = _inputs(shape, mag, dtype)
        te, je = tc.encode(t), jc.encode(j)
        assert tc.nbytes(te) == jc.nbytes(je)
        dq = tc.decode(te)
        assert dq.dtype == t.dtype and dq.shape == t.shape
        x = t.double()
        err = (x - dq.double()).abs()
        if name == "fp":
            assert torch.equal(dq, t)
        elif name == "int8":
            # a bf16 tensor dequantises into bf16: half a bf16 ulp more
            scale = float(x.abs().max()) / 127.0
            extra = 2.0 ** -8 * x.abs() if t.dtype == torch.bfloat16 else 0
            assert (err <= scale / 2 * (1 + 1e-6) + 1e-12 + extra).all()
        elif name == "bf16":
            assert (err <= 2.0 ** -8 * x.abs()).all()
            np.testing.assert_array_equal(
                dq.float().numpy(), np.asarray(jc.decode(je), np.float32))
        else:
            kept = te.vals.double().abs().min()
            assert float(err.max()) <= float(kept)
    ints = torch.arange(10, dtype=torch.int32)
    assert tc.encode(ints) is ints


def test_int8_matches_jax_dequantisation():
    """Same scale, same round-half-to-even: the dequantised tensors are
    the JAX package's, bit for bit."""
    for shape, mag in SHAPES:
        t, j = _inputs(shape, mag, jnp.float32, seed=3)
        got = T.Int8Codec().decode(T.Int8Codec().encode(t))
        want = J.Int8Codec().decode(J.Int8Codec().encode(j))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    zero = torch.zeros(4, 4)
    assert torch.equal(T.Int8Codec().decode(T.Int8Codec().encode(zero)), zero)


@pytest.mark.parametrize("name", CODECS)
def test_store_boundary_bytes_equal_jax(name):
    stores = T.ActivationStore(codec=name), J.ActivationStore(codec=name)
    t, j = _inputs((6, 16, 32), 2.0, jnp.float32, seed=1)
    for store, x in zip(stores, (t, j)):
        store.put(0, (0, 1, 2), x)
        store.put(1, (3,), x[:2])
    assert stores[0].nbytes() == stores[1].nbytes()
    assert stores[0].peak_bytes == stores[1].peak_bytes
    for k in range(3):
        np.testing.assert_allclose(stores[0].get(0, k).numpy(),
                                   np.asarray(stores[1].get(0, k)), atol=1e-6)
    np.testing.assert_allclose(stores[0].stacked(0, (2, 0)).numpy(),
                               np.asarray(stores[1].stacked(0, (2, 0))),
                               atol=1e-6)
    with pytest.raises(KeyError):
        stores[0].get(2, 0)
    stores[0].drop(0, (0, 1, 2))
    stores[1].drop(0, (0, 1, 2))
    assert stores[0].nbytes() == stores[1].nbytes() > 0
    assert len(stores[0]) == len(stores[1]) == 1


def test_int8_residual_store_shrinks_and_replays_close():
    cfg = dataclasses.replace(
        get_config("gwtf-llama-300m").reduced(num_layers=4, d_model=128),
        vocab_size=256)
    stage_p, _ = initial_params(cfg, 2, 0, device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 16, 128)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(4, 16, 128)).astype(np.float32))
    sc = StageCompute(cfg, 2)
    grads, sizes = {}, {}
    for name in ("fp", "int8"):
        store = T.ActivationStore(codec=name)
        _, resid = sc.forward_fused(0, stage_p[0], x)
        store.put_residuals(0, (0,), resid)
        sizes[name] = store.nbytes()
        dp, dx = sc.backward_from_residuals(0, store.residuals(0, (0,)), g)
        again = sc.backward_from_residuals(0, store.residuals(0, (0,)), g)
        assert torch.equal(dx, again[1])             # replayable
        grads[name] = leaves((dp, dx))
        store.drop(0, (0,))
        assert len(store) == 0 and store.nbytes() == 0
        assert store.peak_bytes == sizes[name]
    assert sizes["fp"] / sizes["int8"] >= 3.0
    for a, b in zip(grads["int8"], grads["fp"]):
        assert float((a - b).abs().max()) <= 0.05 * float(b.abs().max())


def test_unknown_codec_rejected_and_aliases():
    with pytest.raises(ValueError, match="unknown activation codec"):
        T.make_codec("fp8")
    assert isinstance(T.make_codec("fp32"), T.NullCodec)
    assert isinstance(T.make_codec("top-k"), T.TopKCodec)
    assert isinstance(T.make_codec(None), T.NullCodec)
