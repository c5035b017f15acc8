"""The yardstick: the plain reference against the port at a tiny size, the
operation counts by hand, the churn trace, the profiler's reduction, and
what the harness and the reference import."""
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench import churn, flops, harness, profiling, weights  # noqa: E402
from perfbench.reference import dense  # noqa: E402
from perfbench.tests import tiny  # noqa: E402

CONFIGS = ["gwtf-gpt-300m", "starcoder2-7b-8l"]


def _tiny_config(name):
    cfg = harness.load_json(harness.HERE / "configs" / f"{name}.json")
    cfg.update(tiny.CONFIG, num_kv_heads=4 if cfg["num_kv_heads"] == cfg["num_heads"] else 2)
    return cfg


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_agrees_with_the_port(name):
    from repro_torch.models.transformer import init_cache, prefill, train_loss
    from perfbench.drivers import serve
    raw = _tiny_config(name)
    cfg = harness.model_config(raw)
    model = serve.build_model(cfg, 7, "cpu")
    cell = SimpleNamespace(config=raw)
    layers, head = serve.reference_model(cell, 7, "cpu")
    tokens = torch.randint(0, raw["vocab_size"], (3, 24),
                           generator=torch.Generator().manual_seed(0))
    got, _ = prefill(model, cfg, tokens=tokens, cache=init_cache(cfg, 3, 24, torch.float32,
                                                                 device="cpu"))
    with dense.tf32_off():
        want = dense.logits(head, dense.hidden(layers, head, tokens, raw, dense.F32)[:, -1],
                            raw, dense.F32)
        want_loss = dense.loss(layers, head, tokens[:, :-1], tokens[:, 1:], raw, dense.F32)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    loss = train_loss(model, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}, cfg)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=1e-5)


def test_the_weights_are_the_same_on_every_draw():
    a = weights.draw("stage0/attn/wq", (2, 8, 4), torch.bfloat16, 2**31 + 3, "cpu")
    b = weights.draw("stage0/attn/wq", (2, 8, 4), torch.bfloat16, 2**31 + 3, "cpu")
    c = weights.draw("stage0/attn/wk", (2, 8, 4), torch.bfloat16, 2**31 + 3, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(weights.draw("x/ln1/scale", (1000,), torch.float32, 1, "cpu").mean()) == \
        pytest.approx(1.0, abs=0.02)


def test_flops_by_hand():
    cfg = {"num_layers": 2, "d_model": 8, "num_heads": 2, "num_kv_heads": 1, "head_dim": 4,
           "d_ff": 16, "vocab_size": 10, "mlp_type": "gelu"}
    # per layer: Q 8x8, K and V 8x4 each, O 8x8, MLP 2 x 8x16 -> 64+32+32+64+256 = 448
    assert flops.layer_matmul_params(cfg) == 448
    pairs = 4 * 5 // 2                                    # causal, S = 4
    assert flops.attended_pairs(4, True, None) == pairs
    attn = 4 * 4 * 2 * pairs                              # 4 hd a pair and head
    assert flops.attention_flops(cfg, 4) == attn
    N = 2 * 448 + 8 * 10
    assert flops.train_flops(cfg, 3, 4) == 3 * (6 * N * 4 + 3 * 2 * attn)
    assert flops.prefill_flops(cfg, 3, 4) == 3 * (2 * 2 * 448 * 4 + 2 * attn + 2 * 8 * 10)
    ms, which = flops.bound((1, 4, 2, 1, 4), 2, True, None)
    assert which == "bytes" and ms == pytest.approx((2 * 4 * 2 * 4 + 2 * 4 * 4) * 2 / 3.35e12 * 1e3)


def test_the_churn_trace_repeats_and_a_seed_only_permutes_relays():
    stages = [[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]]
    a = churn.stationary_trace(stages, 0.1, 200, 0, 2**31 + 11)
    assert a == churn.stationary_trace(stages, 0.1, 200, 0, 2**31 + 11)
    b = churn.stationary_trace(stages, 0.1, 200, 0, 5)
    assert a != b

    def live(trace):
        dead, events = trace
        alive = {r: r not in dead for ids in stages for r in ids}
        counts = []
        for it in range(200):
            counts.append(tuple(sum(alive[r] for r in ids) for ids in stages))
            for ev in events:
                if ev[0] == it:
                    alive[ev[2]] = ev[1] == "rejoin"
        return counts
    assert live(a) == live(b)
    assert 0.3 < np.mean([sum(c) for c in live(a)]) / 12 < 0.7
    assert churn.stationary_trace(stages, 0.0, 200, 0, 5) == ([], [])


def test_the_profile_reduction():
    from torch.autograd import DeviceType

    def ev(name, dev, start, end):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(start=start, end=end))
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [ev("perfbench/plan", cpu, 0, 40), ev("aten::mm", cpu, 41, 45),
              ev("gemm", cuda, 10, 20), ev("gemm", cuda, 15, 30), ev("copy", cuda, 50, 60),
              ev("aten::copy_", cpu, 46, 70)]
    s = profiling.summarize(events, 1.0)
    assert s["busy_s"] == pytest.approx(30e-6) and s["launches"] == 3
    assert s["device_ops"][0] == ["gemm", pytest.approx(25e-6)]
    idle = dict(s["idle_gaps"])
    # gaps 0-10 and 30-50 (middles 5 and 40) under the plan span, 60-70
    # (middle 65) under aten::copy_
    assert idle == {"perfbench/plan": pytest.approx(30e-6), "aten::copy_": pytest.approx(10e-6)}


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         capture_output=True, text=True, timeout=300, cwd=harness.ROOT,
                         env={"PYTHONPATH": f"{harness.ROOT}:{harness.ROOT / 'src'}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_nothing_of_the_jax_side():
    mods = _modules("from perfbench import harness, calibrate\n"
                    "from perfbench.tests import tiny\n"
                    "import time\n"
                    "for c in tiny.cells():\n"
                    "    cell = tiny.load(c)\n"
                    "    harness.driver(cell)\n"
                    "    for m in cell.end_to_end + cell.per_layer:\n"
                    "        harness.reader(cell, m['name'])\n"
                    "line, run = tiny.execute(tiny.load('sc2-7b-8l-serve-decode'), trace=True)\n"
                    "assert harness.forbidden_modules() == [], harness.forbidden_modules()\n")
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules("from perfbench.reference import dense, gwtf, greedy\n"
                    "from perfbench import weights, flops, churn")
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
