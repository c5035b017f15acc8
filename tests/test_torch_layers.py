"""Each ported layer function against its JAX counterpart.

Same numpy inputs and weights through ``repro.models.layers`` and
``repro_torch.models.layers``, for the reduced ``gwtf-gpt-300m``
(layernorm, tanh-gelu, tied head) and ``gwtf-llama-300m`` (rmsnorm,
swiglu, untied head), plus GQA.  Tolerances: f32 single layers 1e-5,
f32 attention 2e-4, bf16 2e-2 (about one bf16 ulp of O(1) values).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.models.config import port_only_defaults
from repro_torch.models import layers as TL

LAYER = dict(rtol=1e-5, atol=1e-5)
ATTN = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)

ARCHS = ["gwtf-gpt-300m", "gwtf-llama-300m", "tinyllama-1.1b"]
PORTED_ARCHS = ARCHS + ["mamba2-130m", "hymba-1.5b"]


def _cfg(arch):
    return get_config(arch).reduced(num_layers=2, d_model=256)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(tree):
    """numpy tree -> (jax tree, torch tree)."""
    if isinstance(tree, dict):
        pairs = {k: _both(v) for k, v in tree.items()}
        return ({k: a for k, (a, _) in pairs.items()},
                {k: b for k, (_, b) in pairs.items()})
    return jnp.asarray(tree), torch.from_numpy(np.array(tree))


def _attn_params(rng, cfg):
    D = cfg.d_model
    return {"wq": _normal(rng, (D, cfg.q_dim), D ** -0.5),
            "wk": _normal(rng, (D, cfg.kv_dim), D ** -0.5),
            "wv": _normal(rng, (D, cfg.kv_dim), D ** -0.5),
            "wo": _normal(rng, (cfg.q_dim, D), cfg.q_dim ** -0.5)}


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **tol)


def test_port_configs_equal_jax_configs():
    for arch in PORTED_ARCHS:
        assert dataclasses.asdict(get_config(arch)) == {
            **dataclasses.asdict(jax_config(arch)), **port_only_defaults()}
        assert dataclasses.asdict(_cfg(arch)) == {
            **dataclasses.asdict(jax_config(arch).reduced(num_layers=2, d_model=256)),
            **port_only_defaults()}


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError, match="no-such-arch"):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_apply_norm(arch):
    cfg = _cfg(arch)
    rng = _rng(1)
    p = {"scale": _normal(rng, (cfg.d_model,)) + 1.0}
    if cfg.norm_type == "layernorm":
        p["bias"] = _normal(rng, (cfg.d_model,))
    jp, tp = _both(p)
    x = _normal(rng, (2, 8, cfg.d_model), 3.0) + 0.5
    jx, tx = _both(x)
    _close(TL.apply_norm(tp, tx, cfg), JL.apply_norm(jp, jx, cfg), LAYER)


@pytest.mark.parametrize("positions", ["prefix", "offset"])
def test_apply_rope(positions):
    rng = _rng(2)
    x = _normal(rng, (2, 16, 4, 64))
    pos = np.arange(16) + (0 if positions == "prefix" else 1000)
    jx, tx = _both(x)
    want = JL.apply_rope(jx, jnp.asarray(pos), 10000.0)
    _close(TL.apply_rope(tx, torch.from_numpy(pos), 10000.0), want, LAYER)


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_apply_mlp(arch):
    cfg = _cfg(arch)
    rng = _rng(3)
    D, Fd = cfg.d_model, cfg.d_ff
    p = {"w_up": _normal(rng, (D, Fd), D ** -0.5),
         "w_down": _normal(rng, (Fd, D), Fd ** -0.5)}
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = _normal(rng, (D, Fd), D ** -0.5)
    jp, tp = _both(p)
    jx, tx = _both(_normal(rng, (2, 8, D)))
    _close(TL.apply_mlp(tp, tx, cfg), JL.apply_mlp(jp, jx, cfg), LAYER)


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_embed_and_lm_logits(arch):
    cfg = _cfg(arch)
    rng = _rng(4)
    p = {"table": _normal(rng, (cfg.vocab_size, cfg.d_model), 0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal(rng, (cfg.d_model, cfg.vocab_size),
                               cfg.d_model ** -0.5)
    jp, tp = _both(p)
    toks = rng.integers(0, cfg.vocab_size, (2, 8))
    _close(TL.embed_tokens(tp, torch.from_numpy(toks)),
           JL.embed_tokens(jp, jnp.asarray(toks)), LAYER)
    jx, tx = _both(_normal(rng, (2, 3, cfg.d_model)))
    _close(TL.lm_logits(tp, tx, cfg), JL.lm_logits(jp, jx, cfg), LAYER)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("causal,window", [(True, None), (True, 16),
                                           (False, None)])
def test_apply_attention_no_cache(arch, causal, window):
    """Causal: the flash op (its plain version here); non-causal: the
    port's _online_attention, as in JAX."""
    cfg = _cfg(arch)
    rng = _rng(5)
    jp, tp = _both(_attn_params(rng, cfg))
    jx, tx = _both(_normal(rng, (2, 64, cfg.d_model)))
    pos = np.arange(64)
    want, _ = JL.apply_attention(jp, jx, cfg, positions=jnp.asarray(pos),
                                 causal=causal, window=window)
    got, cache = TL.apply_attention(tp, tx, cfg,
                                    positions=torch.from_numpy(pos),
                                    causal=causal, window=window)
    assert cache is None
    _close(got, want, ATTN)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_attention_cache_prefill_then_decode(arch):
    """Prefill writes the cache and attends over its own K/V; one decode
    token then attends over every live slot.  Cache contents and outputs
    match JAX."""
    cfg = _cfg(arch)
    rng = _rng(6)
    jp, tp = _both(_attn_params(rng, cfg))
    B, P, C = 2, 12, 16
    jcache = {"k": jnp.zeros((B, C, cfg.kv_dim)), "v": jnp.zeros((B, C, cfg.kv_dim))}
    tcache = {"k": torch.zeros((B, C, cfg.kv_dim)), "v": torch.zeros((B, C, cfg.kv_dim))}
    jx, tx = _both(_normal(rng, (B, P, cfg.d_model)))
    want, jcache = JL.apply_attention(jp, jx, cfg, positions=jnp.arange(P),
                                      cache=jcache, write_index=0)
    got, tcache = TL.apply_attention(tp, tx, cfg, positions=torch.arange(P),
                                     cache=tcache, write_index=0)
    _close(got, want, ATTN)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], LAYER)

    jx, tx = _both(_normal(rng, (B, 1, cfg.d_model)))
    want, jcache = JL.apply_attention(jp, jx, cfg, positions=jnp.arange(P, P + 1),
                                      cache=jcache, write_index=P,
                                      kv_valid=P + 1)
    got, tcache = TL.apply_attention(tp, tx, cfg, positions=torch.arange(P, P + 1),
                                     cache=tcache, write_index=P,
                                     kv_valid=P + 1)
    _close(got, want, ATTN)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], LAYER)


def test_apply_attention_ring_slot_write():
    """A full ring buffer: the new token overwrites slot index % C and
    every slot is live."""
    cfg = _cfg("tinyllama-1.1b")
    rng = _rng(7)
    jp, tp = _both(_attn_params(rng, cfg))
    B, C, index = 2, 8, 21
    ck = _normal(rng, (B, C, cfg.kv_dim))
    cv = _normal(rng, (B, C, cfg.kv_dim))
    jx, tx = _both(_normal(rng, (B, 1, cfg.d_model)))
    want, jcache = JL.apply_attention(
        jp, jx, cfg, positions=jnp.asarray([index]),
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        write_index=index % C, kv_valid=C)
    tcache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    got, tcache = TL.apply_attention(
        tp, tx, cfg, positions=torch.tensor([index]), cache=tcache,
        write_index=index % C, kv_valid=C)
    _close(got, want, ATTN)
    _close(tcache["k"], jcache["k"], LAYER)


@pytest.mark.parametrize("kv_valid", [5, 64])
@pytest.mark.parametrize("KH", [8, 2])
def test_decode_attention_chunks(kv_valid, KH):
    """Several chunks (block 16 of C=64), partially live cache, GQA."""
    rng = _rng(8)
    B, H, hd, C = 2, 8, 64, 64
    q = _normal(rng, (B, 1, H, hd))
    ck = _normal(rng, (B, C, KH * hd))
    cv = _normal(rng, (B, C, KH * hd))
    want = JL._decode_attention(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                kv_valid, KH, hd, block=16)
    got = TL._decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                               torch.from_numpy(cv), kv_valid, KH, hd, block=16)
    _close(got, want, ATTN)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_attention_mixed_dtypes(cache_dtype):
    """Full-width serving decodes a bf16 q against an f32 cache: JAX
    promotes the products to f32, the port casts explicitly."""
    rng = _rng(9)
    B, H, KH, hd, C = 2, 4, 4, 64, 32
    q = _normal(rng, (B, 1, H, hd))
    ck = _normal(rng, (B, C, KH * hd))
    cv = _normal(rng, (B, C, KH * hd))
    jq = jnp.asarray(q, jnp.bfloat16)
    jck = jnp.asarray(ck, getattr(jnp, cache_dtype))
    jcv = jnp.asarray(cv, getattr(jnp, cache_dtype))
    want = JL._decode_attention(jq, jck, jcv, 20, KH, hd, block=16)
    tdt = getattr(torch, cache_dtype)
    got = TL._decode_attention(torch.from_numpy(q).bfloat16(),
                               torch.from_numpy(ck).to(tdt),
                               torch.from_numpy(cv).to(tdt), 20, KH, hd,
                               block=16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want, BF16)


@pytest.mark.parametrize("causal,window,q_offset", [(True, None, 0),
                                                    (True, 8, 4),
                                                    (False, None, 0)])
def test_online_attention(causal, window, q_offset):
    rng = _rng(10)
    B, Sq, Sk, H, KH, hd = 2, 16, 24, 4, 2, 64
    q = _normal(rng, (B, Sq, H, hd))
    k = _normal(rng, (B, Sk, KH, hd))
    v = _normal(rng, (B, Sk, KH, hd))
    want = JL._online_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                q_offset, causal, window, kv_len_valid=20,
                                q_block=8)
    got = TL._online_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), q_offset, causal, window,
                               kv_len_valid=20, q_block=8)
    _close(got, want, ATTN)


def test_dense_init_scales():
    g = torch.Generator().manual_seed(0)
    w = TL.dense_init(g, (1024, 512), torch.bfloat16, "cpu")
    assert w.dtype == torch.bfloat16
    assert abs(w.float().std().item() - 1024 ** -0.5) < 1e-3
    t = TL.dense_init(g, (512, 64), torch.float32, "cpu", scale=0.02)
    assert abs(t.std().item() - 0.02) < 1e-3
