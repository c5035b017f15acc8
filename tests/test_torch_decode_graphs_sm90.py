"""``generate``'s decode steps replayed from CUDA graphs
(``launch/serve.py::DecodeGraphs``).

On the CPU: CPU, meta and fake inputs take the eager loop and leave no
graphs on the model; a fake tensor on a CUDA device is no plain CUDA
tensor; a shape that does not recur builds no graphs;
``tools/span_breakdown.py`` names the sublayer reading that a replayed
request cannot give.

On the card (marker ``card``; they skip elsewhere): a shape's first call
decodes eagerly, its second captures the steps and replays them, its
third replays; each against the eager loop on the same card, tokens and logits
equal bit for bit, at the two serve cells' shapes (StarCoder2-7B at full
width, cut to 2 layers: 64 prompts of 1,024 tokens and 32 of 4,032, 64
steps each) and for one reduced bf16 model of each family (dense, MoE,
SSM, hybrid, VLM with its patch embeddings, audio from frame embeddings)
and in a ring buffer that wraps; one decode attention launch counted a
self-attention layer a step in every call; a shape is captured at its
second call in a row and once; the cache is zeroed between calls; device
memory after ten calls equals memory after two; no blocking host call
while the steps replay; with spans on, the sublayers' spans recorded at
the capture alone; a CUDA DTensor takes the eager loop.  Run them there with ``python3 -m pytest --noconftest -q
-p no:cacheprovider tests/test_torch_decode_graphs_sm90.py`` (the card
has no JAX, which the directory's conftest imports).
"""
import dataclasses
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.core.runtime.serving import (serving_aux_inputs,
                                              serving_inputs)
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.serve import generate
from repro_torch.models.transformer import (decode_step, init_cache,
                                            init_params, is_vlm, prefill,
                                            superblocks)
from repro_torch.tree import flatten

DENSE = get_config("gwtf-llama-300m").reduced(num_layers=2, d_model=64)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@torch.inference_mode()
def _eager(model, cfg, prompt, gen, vision=None, embeds=None, window=None):
    """``generate``'s eager loop, greedy, on any device: (tokens, logits)."""
    B, P = prompt.shape
    cache = init_cache(cfg, B, window or P + gen, dtype=torch.float32,
                       device=prompt.device)
    if embeds is not None:
        logits, cache = prefill(model, cfg, embeds=embeds, cache=cache)
    else:
        logits, cache = prefill(model, cfg, tokens=prompt, vision=vision,
                                cache=cache)
    tok = logits.argmax(dim=-1)[:, None]
    toks, outs = [tok], [logits.float()]
    for i in range(gen):
        logits, cache = decode_step(model, cfg, tokens=tok, vision=vision,
                                    cache=cache, index=P + i, window=window)
        tok = logits.argmax(dim=-1)[:, None]
        toks.append(tok)
        outs.append(logits.float())
    return torch.cat(toks, dim=1), torch.stack(outs)


def _serve(model, cfg, prompt, gen, vision=None, embeds=None, window=None):
    return generate(model, cfg, prompt, gen=gen, window=window,
                    temperature=0.0, generator=None, vision=vision,
                    embeds=embeds)


def _attention_layers(cfg) -> int:
    if not cfg.has_attention:
        return 0
    nb, k = superblocks(cfg) if is_vlm(cfg) else (cfg.num_layers, 2)
    return nb * (k - 1)


# ------------------------------------------------------------------ cpu

@pytest.mark.parametrize("kind", ["cpu", "meta", "fake"])
def test_cpu_meta_and_fake_inputs_take_the_eager_loop(kind):
    """No graphs on the model, and on the CPU the eager loop's numbers."""
    gen = 3
    if kind == "meta":
        model = init_params(DENSE, torch.Generator(), "meta")
        prompt = torch.zeros((2, 8), dtype=torch.long, device="meta")
        out = _serve(model, DENSE, prompt, gen)
        assert out.tokens.is_meta and out.tokens.shape == (2, gen + 1)
    else:
        model, prompt, _ = serving_inputs(DENSE, seed=1, batch=2,
                                          prompt_len=8, device="cpu")
        if kind == "fake":
            with FakeTensorMode(allow_non_fake_inputs=True) as mode:
                out = _serve(model, DENSE, mode.from_tensor(prompt), gen)
            assert out.tokens.shape == (2, gen + 1)
        else:
            out = _serve(model, DENSE, prompt, gen)
            tokens, logits = _eager(model, DENSE, prompt, gen)
            assert torch.equal(out.tokens, tokens)
            assert torch.equal(out.logits, logits)
    assert "_decode_graphs" not in model.__dict__


def test_a_shape_that_does_not_recur_builds_no_graphs():
    """``DecodeGraphs.of`` on calls whose shape differs from the call
    before: None each time, the last shape remembered, nothing built."""
    model, prompt, _ = serving_inputs(DENSE, seed=1, batch=2, prompt_len=8,
                                      device="cpu")
    keys = []
    for gen, rows in ((4, 2), (5, 2), (4, 2), (4, 1), (5, 1)):
        assert serve.DecodeGraphs.of(model, DENSE, prompt[:rows], gen=gen,
                                     window=None, vision=None,
                                     request=0) is None
        keys.append(model._decode_shape)
        assert keys[-1][1] == (rows, 8) and keys[-1][3] == gen
    assert len(set(keys)) == 4 and keys[0] == keys[2]
    assert "_decode_graphs" not in model.__dict__


def test_a_fake_tensor_on_a_cuda_device_takes_no_graphs():
    model, prompt, _ = serving_inputs(DENSE, seed=1, batch=2, prompt_len=8,
                                      device="cpu")
    with FakeTensorMode():
        fake = torch.empty((2, 8), dtype=torch.long, device="cuda")
    assert fake.is_cuda
    assert not serve._takes_graphs(model, fake)
    assert not serve._takes_graphs(model, prompt)


def _span_breakdown():
    path = Path(__file__).resolve().parents[1] / "tools" / "span_breakdown.py"
    spec = importlib.util.spec_from_file_location("span_breakdown", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("replayed", [False, True])
def test_span_breakdown_marks_a_replayed_requests_core_unavailable(replayed):
    """``tools/span_breakdown.py`` on a serve cell's profile: the decode
    kernels by name either way; ``decode_attention_core_ms`` from the
    spans when the steps ran eagerly, named unavailable when they
    replayed (no ``attention.core`` under ``decode.step``)."""
    from torch.autograd import DeviceType
    tool = _span_breakdown()

    def gpu(name, start, end):
        return SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                               time_range=SimpleNamespace(start=start, end=end))
    events = [gpu("void decode_attention_split_kernel<float>(Args)", 0, 300),
              gpu("decode_attention_merge_kernel", 300, 400),
              gpu("nvjet_tst_64x8_64x16", 400, 1400)]
    assert tool.decode_kernel_s(events) == pytest.approx(400e-6)
    span_s = {"decode.step": 8e-3} if replayed else {
        "decode.step/attention.core": 4e-4, "decode.step/mlp": 7.6e-3}
    run = SimpleNamespace(t0=0.0, setup_s=0.0, window_s=1.0, records=[],
                          profile={"span_device_s": span_s, "busy_s": 8e-3,
                                   "decode_kernel_s": 4e-4})
    cell = SimpleNamespace(workload={"driver": "serve", "gen": 4})
    got = tool.readings(cell, run, [], [])
    assert got["decode_attention_kernel_ms"] == pytest.approx(0.1)
    if replayed:
        assert "decode_attention_core_ms" not in got
        assert got["unavailable"][0].startswith("decode_attention_core_ms")
    else:
        assert got["decode_attention_core_ms"] == pytest.approx(0.1)
        assert "unavailable" not in got


# ---------------------------------------------------------------- card

# (name, batch, prompt_len): the serve cells' request shapes, 64 steps each
CELL_SHAPES = [("sc2-7b-8l-serve-decode", 64, 1024),
               ("sc2-7b-8l-serve-long", 32, 4032)]
# one reduced model of each family, bf16 as the serve path runs them
FAMILIES = ["gwtf-llama-300m", "granite-moe-3b-a800m", "mamba2-130m",
            "hymba-1.5b", "llama-3.2-vision-90b", "musicgen-medium"]


def _family(arch: str):
    cfg = get_config(arch).reduced(num_layers=4 if arch == "llama-3.2-vision-90b"
                                   else 2)
    if arch == "llama-3.2-vision-90b":      # two superblocks of (cross, self)
        cfg = dataclasses.replace(cfg, cross_attn_every=2)
    return dataclasses.replace(cfg, param_dtype="bfloat16")


def _inputs(cfg, batch: int, prompt_len: int, seed: int = 0):
    model, prompt, _ = serving_inputs(cfg, seed=seed, batch=batch,
                                      prompt_len=prompt_len, device="cuda")
    vision, embeds = serving_aux_inputs(cfg, seed=seed, batch=batch,
                                        prompt_len=prompt_len, device="cuda")
    with torch.no_grad():                   # gates open, so vision counts
        for cp, gates in zip(getattr(model, "cross_blocks", []),
                             ((0.7, -0.4), (-0.3, 0.55))):
            cp.gate_attn.fill_(gates[0])
            cp.gate_mlp.fill_(gates[1])
    return model, prompt, dict(vision=vision, embeds=embeds)


def _graphs_equal_eager(cfg, model, prompt, aux, gen, window=None,
                        calls=("eager", "capture", "replay")):
    """``calls`` calls of one shape, each (its eager first call, the call
    that captures, a call that replays) equal to the eager loop."""
    tokens, logits = _eager(model, cfg, prompt, gen, window=window, **aux)
    for call in calls:
        launches = ops.decode_attention.launches
        kept = model.__dict__.get("_decode_graphs")
        out = _serve(model, cfg, prompt, gen, window=window, **aux)
        assert ops.decode_attention.launches - launches == \
            _attention_layers(cfg) * gen, call
        graphs = model.__dict__.get("_decode_graphs")
        assert (graphs is None) == (call == "eager"), call
        assert (graphs is kept) == (call != "capture"), call
        assert graphs is None or len(graphs.graphs) == gen
        assert torch.equal(out.tokens, tokens), call
        assert torch.equal(out.logits, logits), call


@pytest.mark.card
@pytest.mark.parametrize("name, batch, prompt_len", CELL_SHAPES)
def test_graphs_equal_eager_at_the_serve_cells_shapes(card, name, batch,
                                                      prompt_len):
    cfg = dataclasses.replace(get_config("starcoder2-7b"), num_layers=2)
    model, prompt, aux = _inputs(cfg, batch, prompt_len)
    _graphs_equal_eager(cfg, model, prompt, aux, 64)


@pytest.mark.card
@pytest.mark.parametrize("arch", FAMILIES)
def test_graphs_equal_eager_in_every_family(card, arch):
    cfg = _family(arch)
    model, prompt, aux = _inputs(cfg, 2, 64)
    assert (aux["vision"] is not None) == (cfg.arch_type == "vlm")
    assert (aux["embeds"] is not None) == bool(cfg.audio_frontend)
    _graphs_equal_eager(cfg, model, prompt, aux, 8)


@pytest.mark.card
def test_graphs_equal_eager_in_a_ring_buffer(card):
    """A cache of ``window`` slots that the prompt fills: each step writes
    slot ``index % window``, so the ring wraps from the first step."""
    cfg = _family("gwtf-llama-300m")
    model, prompt, aux = _inputs(cfg, 2, 64)
    _graphs_equal_eager(cfg, model, prompt, aux, 16, window=64)


@pytest.mark.card
def test_a_shape_is_captured_at_its_second_call_in_a_row_and_once(
        card, monkeypatch):
    """Graphs captured at a shape's second call in a row, then replayed;
    a call of a new shape eager, the kept graphs left alone; memory
    back where it was each time the kept shape comes back."""
    cfg = _family("gwtf-llama-300m")
    model, prompt, _ = _inputs(cfg, 2, 64)
    made = [0]

    class Counted(torch.cuda.CUDAGraph):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made[0] += 1

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Counted)
    held, captured = [], []
    for gen in (8, 8, 8, 6, 8, 6, 8, 8):
        launches = ops.decode_attention.launches
        _serve(model, cfg, prompt, gen)
        assert ops.decode_attention.launches - launches == gen * cfg.num_layers
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
        captured.append(made[0])
    assert captured == [0, 8, 8, 8, 8, 14, 14, 22]
    assert held[1] > held[0], held
    assert held[2] == held[1] == held[3] == held[4] == held[7], held


def _poison(cache):
    with torch.inference_mode():      # the kept cache is an inference tensor
        for t in flatten(cache)[0]:
            t.fill_(float("nan"))


@pytest.mark.card
@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b",
                                  "gwtf-llama-300m"])
def test_the_cache_is_zeroed_between_calls(card, arch):
    """NaN written over the kept cache after a call: the next call, on
    other prompts, gives the eager loop's numbers (an SSM's prefill reads
    its conv window and state), and ``start`` leaves every slot 0."""
    cfg = _family(arch)
    model, prompt, aux = _inputs(cfg, 2, 64)
    _serve(model, cfg, prompt, 8, **aux)
    _serve(model, cfg, prompt, 8, **aux)
    graphs = model._decode_graphs
    _poison(graphs.cache)
    _, other, _ = _inputs(cfg, 2, 64, seed=5)
    _graphs_equal_eager(cfg, model, other, aux, 8, calls=("replay",))
    assert model._decode_graphs is graphs
    _poison(graphs.cache)
    with torch.inference_mode():
        graphs.start(None)
    assert all(bool((t == 0).all()) for t in flatten(graphs.cache)[0])


@pytest.mark.card
def test_memory_after_ten_calls_equals_memory_after_two(card):
    cfg = _family("hymba-1.5b")
    model, prompt, aux = _inputs(cfg, 4, 64)
    held = []
    for call in range(10):
        out = _serve(model, cfg, prompt, 16, **aux)
        del out
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
    assert held[9] == held[1]


@pytest.mark.card
def test_no_blocking_host_call_while_the_steps_replay(card):
    cfg = _family("granite-moe-3b-a800m")
    model, prompt, aux = _inputs(cfg, 2, 64)
    gen = 8
    _serve(model, cfg, prompt, gen, **aux)
    out = _serve(model, cfg, prompt, gen, **aux)
    graphs = model._decode_graphs
    with torch.inference_mode():
        _, cache = prefill(model, cfg, tokens=prompt,
                           cache=graphs.start(None))
        tok = out.tokens[:, :1]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            toks = [tok]
            for i in range(gen):
                tok = graphs.step(i, tok).argmax(dim=-1)[:, None]
                toks.append(tok)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert cache is graphs.cache
    assert torch.equal(torch.cat(toks, dim=1), out.tokens)


def _under(record, name: str) -> bool:
    while record is not None and record.name != name:
        record = record.parent
    return record is not None


@pytest.mark.card
def test_spans_with_graphs(card):
    """Spans on: each call has its ``decode.step`` spans; the sublayers'
    spans of the steps are recorded in the eager first call, then at the
    capture alone (the eager step, then each step's capture), and not in
    a call that replays."""
    cfg = _family("gwtf-llama-300m")
    model, prompt, _ = _inputs(cfg, 2, 64)
    spans.enable()
    try:
        spans.drain()
        calls = []
        for _ in range(3):
            _serve(model, cfg, prompt, 4)
            calls.append(spans.drain())
    finally:
        spans.disable()
    for records in calls:
        assert [r.ids["step"] for r in records if r.name == "decode.step"] \
            == list(range(4))
    cores = [sum(_under(r, where) for r in records if r.name == "attention.core")
             for records in calls for where in ("decode.capture", "decode.step",
                                                "prefill")]
    L = cfg.num_layers
    assert cores == [0, 4 * L, L, 5 * L, 0, L, 0, 0, L]
    assert [sum(r.name == "decode.capture" for r in records)
            for records in calls] == [0, 1, 0]


@pytest.mark.card
def test_a_cuda_dtensor_takes_the_eager_loop(card):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    model, prompt, _ = _inputs(_family("gwtf-llama-300m"), 2, 64)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,))
        on = distribute_tensor(prompt, mesh, [Replicate()])
        assert on.is_cuda
        assert serve._takes_graphs(model, prompt)
        assert not serve._takes_graphs(model, on)
    finally:
        dist.destroy_process_group()
