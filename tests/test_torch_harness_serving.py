"""The port's serving checks against the JAX package's on the corpus
scenario ``serve-churn-under-load`` (reduced ``gwtf-llama-300m``, f32),
shortened to 2 iterations of 32 generated tokens.

JAX's ``ServeTrainer`` decodes eagerly, about half a second a dispatch on
the CPU, so the corpus spec itself (224 dispatches) takes it 130 s; the
shortened spec keeps the relay crash mid-decode (a request requeued at
token 6 and its cache replayed) in 93 dispatches.  The corpus spec itself
runs in the ``scenarios`` sweep (``test_torch_harness_sweep.py``).  Both
packages run ``serving-invariants`` and ``serving-consistency``, the
port on the CPU from JAX's model and prompts: the results, the recorded
and engine chain plans, traces, timelines, counters and every greedy
stream are equal, exactly.
"""
import pytest
import torch

from tests.test_torch_harness_runtime import serving_checks_equal

SHORT = dict(iterations=2, gen_tokens=32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_serving_checks_equal_jax_under_a_crash(monkeypatch):
    rt, tt = serving_checks_equal(monkeypatch, "serve-churn-under-load",
                                  **SHORT)
    out = rt["serving-consistency"]
    assert out["replay_steps"] > 0 and out["stacked_rows"] > out[
        "decode_dispatches"]
    requeues = [op for tl in tt.engine.traces for op in tl
                if op[0] == "requeue"]
    assert requeues and all(op[5] > 0 for op in requeues)   # mid-decode
