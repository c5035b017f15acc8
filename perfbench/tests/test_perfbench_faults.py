"""``correct`` comes out false when the timed path is broken underneath (a
run at a reduced size on the CPU, past the harness's look for a card), and
the control, the reference in float8 in the program's place, reads far
above the program."""
import time

import pytest

torch = pytest.importorskip("torch")

from perfbench import harness  # noqa: E402
from perfbench.tests import tiny  # noqa: E402

TRAIN = ["gpt300m-train-churn10", "sc2-7b-8l-train-calm"]


def _unchanged(monkeypatch):
    from repro_torch.core.runtime.trainer import RuntimeTrainer
    monkeypatch.setattr(RuntimeTrainer, "_apply_update", lambda self, *a: None)


def _half_batch(monkeypatch):
    from repro_torch.core.runtime.trainer import RuntimeTrainer
    execute = RuntimeTrainer._execute

    def half(self, res, *a, **k):
        res.completed = res.completed[::2]
        return execute(self, res, *a, **k)
    monkeypatch.setattr(RuntimeTrainer, "_execute", half)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell", TRAIN)
def test_a_broken_training_step_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    line, _ = tiny.execute(tiny.load(cell))
    assert line["correct"] is False


def test_an_altered_token_is_not_correct(monkeypatch):
    import repro_torch.launch.serve as serve
    generate = serve.generate

    def altered(model, cfg, *a, **k):
        out = generate(model, cfg, *a, **k)
        out.tokens = out.tokens.clone()
        out.tokens[:, 2] = out.logits[2].argmin(-1)     # the least likely token
        return out
    monkeypatch.setattr(serve, "generate", altered)
    line, _ = tiny.execute(tiny.load("sc2-7b-8l-serve-decode"))
    assert line["correct"] is False
    assert line["checks"]["logit_gap"]["value"] > line["checks"]["logit_gap"]["limit"]


def test_altered_logits_are_not_correct(monkeypatch):
    import repro_torch.launch.serve as serve
    generate = serve.generate

    def altered(model, cfg, *a, **k):
        out = generate(model, cfg, *a, **k)
        out.logits = out.logits.clone()
        out.logits[1] += torch.randn(out.logits[1].shape,
                                     generator=torch.Generator().manual_seed(0)) * out.logits[1].std()
        return out
    monkeypatch.setattr(serve, "generate", altered)
    line, _ = tiny.execute(tiny.load("sc2-7b-8l-serve-decode"))
    assert line["correct"] is False
    assert line["checks"]["logit_error"]["value"] > line["checks"]["logit_error"]["limit"]
    assert line["checks"]["logit_gap"]["value"] <= line["checks"]["logit_gap"]["limit"]


@pytest.mark.parametrize("cell", TRAIN + ["sc2-7b-8l-serve-decode"])
def test_the_control_reads_far_above_the_program(cell):
    c = tiny.load(cell)
    drv = harness.driver(c)
    for seed in (1, 2, 3):
        run = harness.Run(device="cpu", seed=seed, seconds=0.0, trace=False, t0=time.perf_counter())
        got = drv.controls(c, run, drv.run(c, run))
        prog, ctrl = got["program"], got["control"]
        assert any(ctrl[k] > 10 * max(prog[k], 1e-6) for k in prog), got
