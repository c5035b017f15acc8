"""The port's serving path against the JAX package on shared weights.

The JAX package's ``serving_inputs`` draws the params; ``params_from_jax``
loads them into the port; both packages prefill the same numpy prompt
and decode greedily.  Prefill and per-step logits agree within the f32
attention tolerance (2e-4) and the greedy token streams are equal.  Also
the port's CLI end to end on the CPU, and its refusal to run on the CPU
when the GPU was asked for.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs import get_config as jax_config
from repro.core.runtime.serving import serving_inputs as jax_serving_inputs
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.weights import params_from_jax

LOGITS = dict(rtol=2e-4, atol=2e-4)


def _jax_generate(cfg, params, prompt, gen, window):
    B, P = prompt.shape
    cache_len = window if window is not None else P + gen
    cache = JT.init_cache(cfg, B, cache_len, dtype=jnp.float32)
    logits, cache = JT.prefill(params, cfg, tokens=jnp.asarray(prompt),
                               cache=cache)
    step = jax.jit(lambda p, tok, c, i: JT.decode_step(
        p, cfg, tokens=tok, cache=c, index=i, window=window))
    tok = jnp.argmax(logits, -1)[:, None]
    toks, all_logits = [tok], [logits]
    for i in range(gen):
        logits, cache = step(params, tok, cache, jnp.int32(P + i))
        tok = jnp.argmax(logits, -1)[:, None]
        toks.append(tok)
        all_logits.append(logits)
    return (np.asarray(jnp.concatenate(toks, axis=1)),
            np.stack([np.asarray(x, np.float32) for x in all_logits]))


def _run_both(arch, *, layers, d_model, batch, prompt_len, gen, window=None,
              param_dtype=None):
    jcfg = jax_config(arch).reduced(num_layers=layers, d_model=d_model)
    tcfg = get_config(arch).reduced(num_layers=layers, d_model=d_model)
    if param_dtype:
        jcfg = dataclasses.replace(jcfg, param_dtype=param_dtype)
        tcfg = dataclasses.replace(tcfg, param_dtype=param_dtype)
    params, *_ = jax_serving_inputs(jcfg, seed=0, batch=batch,
                                    prompt_len=prompt_len)
    prompt = np.random.default_rng(0).integers(0, tcfg.vocab_size,
                                               (batch, prompt_len))
    want_toks, want_logits = _jax_generate(jcfg, params, prompt, gen, window)
    model = params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    out = tserve.generate(model, tcfg, torch.from_numpy(prompt), gen=gen,
                          window=window, temperature=0.0, generator=None)
    return out, want_toks, want_logits


@pytest.mark.parametrize("arch,d_model", [("gwtf-gpt-300m", 256),
                                          ("gwtf-llama-300m", 256),
                                          ("tinyllama-1.1b", 512),
                                          ("mamba2-130m", 256),
                                          ("hymba-1.5b", 640)])
def test_greedy_decode_matches_jax(arch, d_model):
    """Dense, SSM and hybrid; hymba at d_model 640 has 10/5 heads (GQA)."""
    out, want_toks, want_logits = _run_both(
        arch, layers=2, d_model=d_model, batch=2, prompt_len=16, gen=8)
    assert out.logits.shape == want_logits.shape
    np.testing.assert_allclose(out.logits.numpy(), want_logits, **LOGITS)
    np.testing.assert_array_equal(out.tokens.numpy(), want_toks)


def test_ring_buffer_decode_matches_jax():
    """--long --window 16, prompt 8, gen 24: the ring wraps twice."""
    out, want_toks, want_logits = _run_both(
        "tinyllama-1.1b", layers=2, d_model=128, batch=2, prompt_len=8,
        gen=24, window=16)
    np.testing.assert_allclose(out.logits.numpy(), want_logits, **LOGITS)
    np.testing.assert_array_equal(out.tokens.numpy(), want_toks)


def test_hybrid_ring_buffer_decode_matches_jax():
    """hymba with --long --window 16, prompt 8, gen 24: the attention ring
    wraps twice while the SSM state runs on."""
    out, want_toks, want_logits = _run_both(
        "hymba-1.5b", layers=2, d_model=128, batch=2, prompt_len=8,
        gen=24, window=16)
    np.testing.assert_allclose(out.logits.numpy(), want_logits, **LOGITS)
    np.testing.assert_array_equal(out.tokens.numpy(), want_toks)


def test_ssm_cache_holds_no_attention_slots():
    cfg = get_config("mamba2-130m").reduced()
    cache = TT.init_cache(cfg, 2, 40, dtype=torch.float32, device="cpu")
    assert set(cache) == {"ssm"}
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    assert cache["ssm"]["conv"].shape == (2, 2, cfg.ssm_conv - 1, di + 2 * N)
    assert cache["ssm"]["ssm"].shape == (2, 2, H, di // H, N)
    hybrid = get_config("hymba-1.5b").reduced()
    assert set(TT.init_cache(hybrid, 2, 40, device="cpu")) == {"attn", "ssm"}


def test_ssm_params_load_bit_exact():
    """blocks/mamba: bf16 leaves load bit for bit, f32 leaves stay f32."""
    jcfg = dataclasses.replace(jax_config("hymba-1.5b").reduced(d_model=128),
                               param_dtype="bfloat16")
    tcfg = dataclasses.replace(get_config("hymba-1.5b").reduced(d_model=128),
                               param_dtype="bfloat16")
    params, *_ = jax_serving_inputs(jcfg, seed=2, batch=1, prompt_len=4)
    tree = jax.tree.map(np.asarray, params)
    model = params_from_jax(tcfg, tree, device="cpu")
    for leaf, arr in tree["blocks"]["mamba"].items():
        got = model.blocks[1].mamba[leaf].detach()
        if arr.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, leaf
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          arr[1].view(np.int16))
        else:
            assert got.dtype == torch.float32, leaf
            np.testing.assert_array_equal(got.numpy(), arr[1])
    assert set(model.blocks[0]._modules) == {"ln1", "attn", "mamba", "ln2", "mlp"}


def test_bf16_params_load_bit_exact_and_decode_close():
    """bf16 params (ml_dtypes in numpy, and their uint16 bits) load bit
    for bit; with an f32 cache the mixed-dtype decode stays within bf16
    tolerance of JAX's (2e-2 relative on the logits' scale)."""
    jcfg = dataclasses.replace(
        jax_config("gwtf-llama-300m").reduced(num_layers=2, d_model=128),
        param_dtype="bfloat16")
    tcfg = dataclasses.replace(
        get_config("gwtf-llama-300m").reduced(num_layers=2, d_model=128),
        param_dtype="bfloat16")
    params, *_ = jax_serving_inputs(jcfg, seed=1, batch=1, prompt_len=4)
    tree = jax.tree.map(np.asarray, params)
    wq = tree["blocks"]["attn"]["wq"]
    assert wq.dtype.name == "bfloat16"
    model = params_from_jax(tcfg, tree, device="cpu")
    got = model.blocks[1].attn["wq"].detach()
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  wq[1].view(np.int16))
    bits = jax.tree.map(lambda a: a.view(np.uint16)
                        if a.dtype.name == "bfloat16" else a, tree)
    model_bits = params_from_jax(tcfg, bits, device="cpu")
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              model_bits.state_dict().items()):
        assert torch.equal(a, b), n

    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 16))
    want_toks, want_logits = _jax_generate(jcfg, params, prompt, 2, None)
    out = tserve.generate(model, tcfg, torch.from_numpy(prompt), gen=2,
                          window=None, temperature=0.0, generator=None)
    scale = np.abs(want_logits).max()
    np.testing.assert_allclose(out.logits.numpy() / scale, want_logits / scale,
                               rtol=2e-2, atol=2e-2)


def test_params_from_jax_checks_layer_axis():
    cfg = get_config("gwtf-llama-300m").reduced(num_layers=2, d_model=128)
    params, *_ = jax_serving_inputs(jax_config("gwtf-llama-300m").reduced(
        num_layers=3, d_model=128), seed=0, batch=1, prompt_len=4)
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")


def test_port_cli_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "tinyllama-1.1b", "--reduced", "--layers", "2",
        "--d-model", "64", "--batch", "1", "--prompt-len", "8", "--gen", "2",
        "--device", "cpu"])
    tserve.main()
    out = capsys.readouterr().out
    assert "prefill: bs=1 len=8" in out
    assert "decoded 2 steps" in out
    assert "sample:" in out


def test_port_cli_long_mode_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "gwtf-gpt-300m", "--reduced", "--layers", "2",
        "--d-model", "64", "--batch", "1", "--prompt-len", "8", "--gen", "20",
        "--long", "--window", "16", "--device", "cpu"])
    tserve.main()
    assert "ring-buffer" in capsys.readouterr().out


def test_port_cli_runs_ssm_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "mamba2-130m", "--reduced", "--batch", "1",
        "--prompt-len", "8", "--gen", "2", "--device", "cpu"])
    tserve.main()
    out = capsys.readouterr().out
    assert "prefill: bs=1 len=8" in out and "decoded 2 steps" in out


def test_port_cli_without_gpu_raises(monkeypatch):
    """Without --device cpu and without a GPU the CLI raises; it never
    quietly runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "tinyllama-1.1b", "--reduced", "--layers", "2",
        "--d-model", "64", "--batch", "1", "--prompt-len", "8", "--gen", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main()


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("gwtf-llama-300m").reduced(num_layers=2, d_model=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_cache(cfg, 1, 8)


def test_temperature_sampling_stays_in_vocab():
    """Temperature sampling draws from the given generator; torch cannot
    reproduce jax.random.categorical, so only its range is checked."""
    from repro_torch.core.runtime.serving import serving_inputs
    cfg = get_config("gwtf-llama-300m").reduced(num_layers=2, d_model=64)
    model, prompt, g = serving_inputs(cfg, seed=3, batch=2, prompt_len=8,
                                      device="cpu")
    out = tserve.generate(model, cfg, prompt, gen=4, window=None,
                          temperature=1.0, generator=g)
    assert out.tokens.shape == (2, 5)
    assert int(out.tokens.min()) >= 0 and int(out.tokens.max()) < cfg.vocab_size
    assert torch.isfinite(out.logits).all()
