"""The VLM (gated cross-attention) and audio models in the port against the
JAX package.

``llama-3.2-vision-90b`` reduced to two superblocks of one cross and one
self layer (``cross_attn_every=2`` over 4 layers, so the two-level unstack
of ``self_blocks`` runs) and ``musicgen-medium`` reduced, from JAX's
weights.  A cross block's gates initialise to 0, and tanh(0) = 0 would
hide a wrong cross-attention, so every VLM test first sets both gates of
each superblock to distinct nonzero values in the numpy tree both
packages load.  ``apply_attention`` with ``kv_x`` and ``_apply_cross_block``
against JAX's, f32, within 2e-4; the VLM's prefill and 8 greedy decode
steps with vision and without it (cross layers skipped, as the serving
trainer runs it); musicgen's prefill from frame embeddings then token
decode, also in a wrapping ring buffer; logits within 2e-4, greedy
streams equal.  Also the serving CLI on both, ``params_to_jax`` as the
exact inverse of ``params_from_jax``, and the parameter count of every
config's model against JAX's, on the meta device.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.core.runtime.serving import serving_inputs as jax_serving_inputs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.core.runtime.serving import serving_aux_inputs
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.weights import params_from_jax, params_to_jax

TOL = dict(rtol=2e-4, atol=2e-4)
VLM, AUDIO = "llama-3.2-vision-90b", "musicgen-medium"
# (gate_attn, gate_mlp) of each superblock
GATES = np.array([[0.7, -0.4], [-0.3, 0.55]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def vlm_cfg(get, **kw):
    """Two superblocks of (cross, self) at d_model 128: 2 heads of 64."""
    return dataclasses.replace(get(VLM).reduced(num_layers=4, d_model=128),
                               cross_attn_every=2, **kw)


def audio_cfg(get):
    return get(AUDIO).reduced(num_layers=2, d_model=128)


def with_gates(tree):
    """The numpy tree with each superblock's gates set to ``GATES``."""
    tree["cross_blocks"]["gate_attn"] = GATES[:, 0].copy()
    tree["cross_blocks"]["gate_mlp"] = GATES[:, 1].copy()
    return tree


def jax_inputs(jcfg, batch, prompt_len, seed=0):
    """JAX's params (numpy, gates set where the model has them) and its
    vision and frame embeddings."""
    params, _, vision, embeds, _ = jax_serving_inputs(
        jcfg, seed=seed, batch=batch, prompt_len=prompt_len)
    tree = jax.tree.map(np.asarray, params)
    if "cross_blocks" in tree:
        tree = with_gates(tree)
    aux = [None if a is None else np.array(a) for a in (vision, embeds)]
    return tree, *aux


def _jax_generate(cfg, params, prompt, gen, window, vision=None, embeds=None):
    B, P = prompt.shape
    cache = JT.init_cache(cfg, B, window or P + gen, dtype=jnp.float32)
    vis = None if vision is None else jnp.asarray(vision)
    if embeds is not None:
        logits, cache = JT.prefill(params, cfg, embeds=jnp.asarray(embeds),
                                   cache=cache)
    else:
        logits, cache = JT.prefill(params, cfg, tokens=jnp.asarray(prompt),
                                   vision=vis, cache=cache)
    step = jax.jit(lambda p, tok, c, i: JT.decode_step(
        p, cfg, tokens=tok, vision=vis, cache=c, index=i, window=window))
    tok = jnp.argmax(logits, -1)[:, None]
    toks, all_logits = [tok], [logits]
    for i in range(gen):
        logits, cache = step(params, tok, cache, jnp.int32(P + i))
        tok = jnp.argmax(logits, -1)[:, None]
        toks.append(tok)
        all_logits.append(logits)
    return (np.asarray(jnp.concatenate(toks, axis=1)),
            np.stack([np.asarray(x, np.float32) for x in all_logits]))


def _serve_both(jcfg, tcfg, *, batch=2, prompt_len=16, gen=8, window=None,
                use_vision=True, use_embeds=False):
    tree, vision, embeds = jax_inputs(jcfg, batch, prompt_len)
    vision = vision if use_vision else None
    embeds = embeds if use_embeds else None
    prompt = np.random.default_rng(3).integers(0, tcfg.vocab_size,
                                               (batch, prompt_len))
    params = jax.tree.map(jnp.asarray, tree)
    want_toks, want_logits = _jax_generate(jcfg, params, prompt, gen, window,
                                           vision, embeds)
    model = params_from_jax(tcfg, tree, device="cpu")
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    out = tserve.generate(model, tcfg, torch.from_numpy(prompt), gen=gen,
                          window=window, temperature=0.0, generator=None,
                          vision=t(vision), embeds=t(embeds))
    np.testing.assert_allclose(out.logits.numpy(), want_logits, **TOL)
    np.testing.assert_array_equal(out.tokens.numpy(), want_toks)
    return out


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("kv_in", [None, 96])
def test_cross_attention_matches_jax(kv_in):
    """Queries over 12 rows against 20 memory rows, GQA 4/2, f32; K/V
    from a memory of another width when ``kv_in`` is given; no RoPE, no
    mask."""
    cfg = dataclasses.replace(vlm_cfg(get_config).reduced(d_model=256),
                              num_heads=4, num_kv_heads=2, head_dim=32,
                              qkv_bias=True)
    rng = np.random.default_rng(0)
    D, Dv = cfg.d_model, kv_in or cfg.d_model
    p = {"wq": _normal(rng, (D, cfg.q_dim), D ** -0.5),
         "wk": _normal(rng, (Dv, cfg.kv_dim), Dv ** -0.5),
         "wv": _normal(rng, (Dv, cfg.kv_dim), Dv ** -0.5),
         "wo": _normal(rng, (cfg.q_dim, D), cfg.q_dim ** -0.5),
         "bq": _normal(rng, (cfg.q_dim,)), "bk": _normal(rng, (cfg.kv_dim,)),
         "bv": _normal(rng, (cfg.kv_dim,))}
    x, mem = _normal(rng, (2, 12, D)), _normal(rng, (2, 20, Dv))
    want, _ = JL.apply_attention(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                 cfg, positions=None, causal=False,
                                 kv_x=jnp.asarray(mem))
    got, _ = TL.apply_attention({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x), cfg, positions=None,
                                causal=False, kv_x=torch.from_numpy(mem))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert TL.init_attention(torch.Generator(), cfg, torch.float32, "cpu",
                             kv_in_dim=kv_in)["wk"].shape == (Dv, cfg.kv_dim)


def test_cross_attention_takes_no_cache():
    cfg = vlm_cfg(get_config)
    p = TL.init_attention(torch.Generator().manual_seed(0), cfg,
                          torch.float32, "cpu")
    cache = {"k": torch.zeros(1, 8, cfg.kv_dim), "v": torch.zeros(1, 8, cfg.kv_dim)}
    with pytest.raises(ValueError, match="cross-attention"):
        TL.apply_attention(p, torch.zeros(1, 1, cfg.d_model), cfg,
                           positions=None, kv_x=torch.zeros(1, 4, cfg.d_model),
                           cache=cache, write_index=0, kv_valid=1)


@pytest.mark.parametrize("superblock", [0, 1])
def test_cross_block_matches_jax(superblock):
    """One cross block of JAX's params with its nonzero gates, on the
    projected vision memory, f32."""
    jcfg, tcfg = vlm_cfg(jax_config), vlm_cfg(get_config)
    tree, vision, _ = jax_inputs(jcfg, batch=2, prompt_len=8)
    cross = jax.tree.map(lambda a: a[superblock], tree["cross_blocks"])
    x = _normal(np.random.default_rng(1), (2, 8, jcfg.d_model))
    mem = vision @ tree["vision_proj"]["w_proj"]
    want = JT._apply_cross_block(jax.tree.map(jnp.asarray, cross),
                                 jnp.asarray(x), jnp.asarray(mem), jcfg)
    model = params_from_jax(tcfg, tree, device="cpu")
    got = TT._apply_cross_block(model.cross_blocks[superblock],
                                torch.from_numpy(x), torch.from_numpy(mem), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    # the gates took: the block moves x
    assert np.abs(np.asarray(want) - x).max() > 1e-2


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_vlm_decode_with_vision_matches_jax():
    out = _serve_both(vlm_cfg(jax_config), vlm_cfg(get_config))
    assert out.logits.shape == (9, 2, 512)


def test_vlm_decode_without_vision_matches_jax():
    """No vision: both packages skip the cross layers."""
    _serve_both(vlm_cfg(jax_config), vlm_cfg(get_config), use_vision=False)


def test_vision_moves_the_logits():
    """With nonzero gates, the patch embeddings change what the model says:
    a cross-attention that read nothing would pass the tests above only if
    JAX's did too."""
    tcfg = vlm_cfg(get_config)
    tree, vision, _ = jax_inputs(vlm_cfg(jax_config), batch=2, prompt_len=8)
    model = params_from_jax(tcfg, tree, device="cpu")
    prompt = torch.zeros(2, 8, dtype=torch.long)
    cache = lambda: TT.init_cache(  # noqa: E731
        tcfg, 2, 8, torch.float32, device="cpu")
    a, _ = TT.prefill(model, tcfg, tokens=prompt, cache=cache())
    b, _ = TT.prefill(model, tcfg, tokens=prompt,
                      vision=torch.from_numpy(vision), cache=cache())
    assert (a - b).abs().max() > 1e-2


def test_audio_decode_from_embeds_matches_jax():
    _serve_both(audio_cfg(jax_config), audio_cfg(get_config), use_embeds=True)


def test_audio_ring_buffer_decode_matches_jax():
    """musicgen from frame embeddings, a ring of 8 slots, prompt 6, gen 14:
    the ring wraps twice."""
    _serve_both(audio_cfg(jax_config), audio_cfg(get_config), prompt_len=6,
                gen=14, window=8, use_embeds=True)


def test_vlm_cache_keeps_the_jax_layout():
    cfg = vlm_cfg(get_config)
    jcache = JT.init_cache(vlm_cfg(jax_config), 3, 10)
    cache = TT.init_cache(cfg, 3, 10, device="cpu")
    assert set(cache) == {"attn"}
    for name in ("k", "v"):
        assert tuple(cache["attn"][name].shape) == jcache["attn"][name].shape
        assert tuple(cache["attn"][name].shape) == (2, 1, 3, 10, cfg.kv_dim)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_serve_cli_runs_on_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--reduced", "--layers", "2", "--d-model",
                 "64", "--batch", "1", "--prompt-len", "8", "--gen", "2",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill: bs=1 len=8" in out and "decoded 2 steps" in out


def test_aux_inputs_leave_the_other_draws_alone():
    """A fourth generator of the same seed: the model, prompt and sampling
    draws stay as they were; each input has JAX's shape."""
    cfg = vlm_cfg(get_config)
    vision, embeds = serving_aux_inputs(cfg, seed=3, batch=2, prompt_len=5,
                                        device="cpu")
    assert embeds is None and tuple(vision.shape) == (2, 16, 128)
    vision2, _ = serving_aux_inputs(cfg, seed=3, batch=2, prompt_len=5,
                                    device="cpu")
    assert torch.equal(vision, vision2)
    acfg = audio_cfg(get_config)
    vision, embeds = serving_aux_inputs(acfg, seed=3, batch=2, prompt_len=5,
                                        device="cpu")
    assert vision is None and tuple(embeds.shape) == (2, 5, acfg.d_model)
    _, _, jv, je, _ = jax_serving_inputs(audio_cfg(jax_config), seed=3,
                                         batch=2, prompt_len=5)
    assert jv is None and je.shape == tuple(embeds.shape)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg_of", [
    lambda get: vlm_cfg(get, param_dtype="bfloat16"),
    lambda get: dataclasses.replace(audio_cfg(get), param_dtype="bfloat16"),
    lambda get: get("qwen2-moe-a2.7b").reduced(d_model=128),
    lambda get: get("hymba-1.5b").reduced(d_model=128)],
    ids=["vlm-bf16", "audio-bf16", "moe", "hybrid"])
def test_params_to_jax_inverts_params_from_jax(cfg_of):
    """Bit for bit, every leaf, in JAX's names and stacked shapes (bf16
    as its uint16 bits)."""
    tree, _, _ = jax_inputs(cfg_of(jax_config), batch=1, prompt_len=4)
    back = params_to_jax(cfg_of(get_config),
                         params_from_jax(cfg_of(get_config), tree, device="cpu"))
    want, want_def = jax.tree.flatten(tree)
    got, got_def = jax.tree.flatten(back)
    assert got_def == want_def
    for a, b in zip(want, got):
        a = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_params_from_jax_names_the_leaf_it_rejects():
    tree, _, _ = jax_inputs(vlm_cfg(jax_config), batch=1, prompt_len=4)
    tree["cross_blocks"]["xattn"]["wq"] = tree["cross_blocks"]["xattn"]["wq"][:1]
    with pytest.raises(ValueError, match="cross_blocks/xattn/wq"):
        params_from_jax(vlm_cfg(get_config), tree, device="cpu")
    tree, _, _ = jax_inputs(vlm_cfg(jax_config), batch=1, prompt_len=4)
    tree["self_blocks"]["ln1"]["scale"] = tree["self_blocks"]["ln1"]["scale"][:, :0]
    with pytest.raises(ValueError, match="self_blocks/ln1/scale"):
        params_from_jax(vlm_cfg(get_config), tree, device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_equals_jax(arch):
    """The port's model at full size, built on the meta device, holds as
    many parameters as JAX's (``jax.eval_shape``), leaf for leaf in
    shape, and within 2 % of ``cfg.param_count()``, the analytic count
    JAX's own test holds its model to (it leaves out the final norm, for
    one)."""
    cfg = get_config(arch)
    model = TT.init_params(cfg, torch.Generator(), device="meta")
    shapes = jax.eval_shape(lambda: JT.init_params(jax_config(arch),
                                                   jax.random.PRNGKey(0)))
    want = [tuple(x.shape) for x in jax.tree.leaves(shapes)]
    got = [tuple(x.shape) for x in jax.tree.leaves(
        TT.stack_params(cfg, model))]
    assert got == want
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s)) for s in want)
    assert abs(n - cfg.param_count()) / cfg.param_count() < 0.02
