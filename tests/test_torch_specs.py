"""The port's abstract inputs, parameters and analytic memory against JAX's.

``input_specs`` gives JAX's shapes and dtypes for every assigned arch and
input shape (at every ``grad_accum`` the dry run takes); ``abstract_params``
JAX's leaves and shapes for all 13 configs, within JAX's 2 % of
``param_count``; ``dryrun.analytic_memory`` JAX's numbers to the float for
every arch x shape x production mesh; ``init_cache(kv_heads_override=)``
JAX's padded cache.  JAX runs in its own process
(``tests/_jax_launch.py``).  Then, in the port alone, a decode step
against a head-padded cache gives the logits of the unpadded one.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.dryrun import analytic_memory  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import INPUT_SHAPES  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_sharding import ASSIGNED, flat, grad_accum, jax_part  # noqa: E402

DTYPES = {torch.int32: "int32", torch.bfloat16: "bfloat16",
          torch.float32: "float32"}


def shape_dtype(t):
    return [list(t.shape), DTYPES[t.dtype]]


@pytest.fixture(scope="module")
def jax_specs():
    return jax_part("specs")


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_input_specs_equal_jax(arch, shape, jax_specs):
    cfg = get_config(arch)
    s = INPUT_SHAPES[shape]
    for ga in sorted({1, grad_accum(cfg, s, False), grad_accum(cfg, s, True)}):
        mine = specs.input_specs(cfg, shape, grad_accum=ga)
        assert all(t.device.type == "meta" for t in leaves(mine))
        assert flat(mine, shape_dtype) == jax_specs["inputs"][f"{arch}|{shape}|{ga}"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_equal_jax(arch, jax_specs):
    """Leaf for leaf (count, shapes, dtypes), nothing allocated, and the
    analytic count within 2 %, as JAX's test holds it."""
    cfg = get_config(arch)
    mine = specs.abstract_params(cfg)
    assert all(t.device.type == "meta" for t in leaves(mine))
    theirs = jax_specs["params"][arch]
    assert flat(mine, shape_dtype) == theirs["leaves"]
    n = sum(t.numel() for t in leaves(mine))
    assert cfg.param_count() == theirs["count"]
    assert abs(n - cfg.param_count()) / cfg.param_count() < 0.02


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_analytic_memory_equals_jax(arch, shape, multi_pod, jax_specs):
    cfg, s = get_config(arch), INPUT_SHAPES[shape]
    mine = analytic_memory(cfg, s, chips=512 if multi_pod else 256,
                           grad_accum=grad_accum(cfg, s, multi_pod))
    assert mine == jax_specs["memory"][f"{arch}|{shape}|{multi_pod}"]


@pytest.mark.parametrize("arch", ASSIGNED)
def test_padded_cache_equals_jax(arch, jax_specs):
    cfg = get_config(arch)
    theirs = jax_specs["cache"][arch]
    assert specs.pad_kv_heads(cfg) == theirs["pad"]
    cache = TT.init_cache(cfg, 2, 8, device="meta",
                          kv_heads_override=theirs["pad"] or None)
    assert flat(cache, shape_dtype) == theirs["leaves"]


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "musicgen-medium"])
def test_decode_with_padded_heads_equals_unpadded(arch):
    """The two configs ``pad_kv_heads`` pads (20 -> 32, 24 -> 32 KV heads),
    reduced to 4 layers of 5 (6) heads of 16, padded to 8: a prefill and
    three decode steps against the padded cache give the unpadded logits,
    within f32 rounding (the padded heads are zeros; the real heads'
    arithmetic is the same)."""
    base = get_config(arch)
    heads = base.num_kv_heads // 4
    cfg = dataclasses.replace(base.reduced(num_layers=4, d_model=heads * 16),
                              num_heads=heads, num_kv_heads=heads,
                              head_dim=16)
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    if cfg.audio_frontend:
        prompt = dict(embeds=torch.randn(2, 6, cfg.d_model, generator=gen))
    else:
        prompt = dict(tokens=torch.randint(0, cfg.vocab_size, (2, 6),
                                           generator=gen))
    outs = []
    for pad in (None, 8):
        cache = TT.init_cache(cfg, 2, 12, dtype=torch.float32, device="cpu",
                              kv_heads_override=pad)
        logits, cache = TT.prefill(model, cfg, cache=cache, **prompt)
        run = [logits]
        for i in range(3):
            tok = run[-1].argmax(-1)[:, None]
            logits, cache = TT.decode_step(model, cfg, tokens=tok, cache=cache,
                                           index=6 + i)
            run.append(logits)
        outs.append(torch.stack(run))
    assert outs[0].shape == outs[1].shape
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-5)
