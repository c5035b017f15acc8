"""The rest of the dense family in the port against the JAX package.

``qwen1.5-4b`` (qkv bias), ``starcoder2-7b`` (LayerNorm, tanh GELU, GQA,
qkv bias), ``gwtf-llama-7b`` (the paper's 7B model) and ``gemma-7b``
(GeGLU, tied embeddings, head_dim 256), reduced, from JAX's parameters:
prefill and step logits within the f32 attention tolerance (2e-4), greedy
streams equal.  Also a windowed ring-buffer decode, a ``gemma-7b``
variant that keeps head_dim 256 (d_model 512, 2 heads of 256: the flash
kernel's widest head), every arch id of the registry, and the copied
config modules against JAX's, field by field and line for line; and
the serving CLI on each new config, dense and MoE, reduced on the cpu.

``gemma-7b`` takes no ``sqrt(d_model)`` embedding scale in either package:
the port copies the reference, not upstream Gemma.
"""
import dataclasses
import re
from pathlib import Path

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.core.runtime.serving import serving_inputs as jax_serving_inputs
from repro_torch.configs import ARCH_IDS as PORT_IDS, get_config
from repro_torch.launch import serve as tserve
from repro_torch.models.config import (PORT_ONLY_FIELDS, ModelConfig,
                                       port_only_defaults)
from repro_torch.weights import params_from_jax
from test_torch_serve import LOGITS, _jax_generate, _run_both

DENSE = ["qwen1.5-4b", "starcoder2-7b", "gwtf-llama-7b", "gemma-7b"]
NEW = ["qwen1_5_4b", "starcoder2_7b", "gwtf_llama_7b", "gemma_7b",
       "granite_moe_3b_a800m", "qwen2_moe_a2_7b", "musicgen_medium",
       "llama3_2_vision_90b"]
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_decode_matches_jax(arch):
    out, want_toks, want_logits = _run_both(
        arch, layers=2, d_model=256, batch=2, prompt_len=16, gen=8)
    assert out.logits.shape == want_logits.shape
    np.testing.assert_allclose(out.logits.numpy(), want_logits, **LOGITS)
    np.testing.assert_array_equal(out.tokens.numpy(), want_toks)


def test_ring_buffer_decode_matches_jax():
    """``qwen1.5-4b`` with an 8-slot window, prompt 6, gen 14: the ring
    wraps twice."""
    out, want_toks, want_logits = _run_both(
        "qwen1.5-4b", layers=2, d_model=128, batch=2, prompt_len=6, gen=14,
        window=8)
    np.testing.assert_allclose(out.logits.numpy(), want_logits, **LOGITS)
    np.testing.assert_array_equal(out.tokens.numpy(), want_toks)


def head_dim_256(cfg: ModelConfig) -> ModelConfig:
    """``gemma-7b`` reduced to 2 layers of d_model 512 with its head_dim
    256 kept (``reduced`` caps head_dim at 64)."""
    return dataclasses.replace(cfg.reduced(num_layers=2, d_model=512),
                               num_heads=2, num_kv_heads=2, head_dim=256)


def test_head_dim_256_variant_matches_jax():
    jcfg, tcfg = head_dim_256(jax_config("gemma-7b")), head_dim_256(
        get_config("gemma-7b"))
    assert tcfg.head_dim == 256 and tcfg.tie_embeddings
    params, *_ = jax_serving_inputs(jcfg, seed=0, batch=2, prompt_len=24)
    prompt = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 24))
    want_toks, want_logits = _jax_generate(jcfg, params, prompt, 8, None)
    model = params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    out = tserve.generate(model, tcfg, torch.from_numpy(prompt), gen=8,
                          window=None, temperature=0.0, generator=None)
    np.testing.assert_allclose(out.logits.numpy(), want_logits, **LOGITS)
    np.testing.assert_array_equal(out.tokens.numpy(), want_toks)


def test_get_config_every_arch_id():
    """Every id of the JAX registry: all 13 configs equal JAX's, field for
    field, the port-only fields at their defaults; none is refused."""
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == {
            **dataclasses.asdict(jax_config(arch)), **port_only_defaults()}
    assert PORT_IDS == ARCH_IDS                   # the same ids, in order
    for alias in ("qwen1.5-4b", "gemma-7b", "starcoder2-7b", "gwtf-llama-7b",
                  "granite-moe-3b-a800m", "qwen2-moe-a2.7b", "musicgen-medium",
                  "llama-3.2-vision-90b"):
        assert get_config(alias).name == alias
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", DENSE + ["granite-moe-3b-a800m",
                                          "qwen2-moe-a2.7b"])
def test_serve_cli_runs_each_new_arch_on_cpu(arch, capsys):
    """``launch/serve.py --arch`` takes every new config, reduced, with no
    new flag."""
    tserve.main(["--arch", arch, "--reduced", "--layers", "2", "--d-model",
                 "64", "--batch", "1", "--prompt-len", "8", "--gen", "2",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill: bs=1 len=8" in out and "decoded 2 steps" in out


@pytest.mark.parametrize("module", NEW)
def test_copied_config_equals_jax(module):
    """Field by field, reduced too, and line for line once the import is
    rewritten."""
    cfg, jcfg = get_config(module), jax_config(module)
    for f in dataclasses.fields(ModelConfig):
        want = port_only_defaults()[f.name] if f.name in PORT_ONLY_FIELDS \
            else getattr(jcfg, f.name)
        assert getattr(cfg, f.name) == want, f.name
    assert dataclasses.asdict(cfg.reduced()) == {
        **dataclasses.asdict(jcfg.reduced()), **port_only_defaults()}
    original = re.sub(r"^from repro\.", "from repro_torch.",
                      (SRC / "repro" / "configs" / f"{module}.py").read_text(),
                      flags=re.M)
    assert (SRC / "repro_torch" / "configs" / f"{module}.py").read_text() == original
