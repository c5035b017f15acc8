"""The port's serving checks against the JAX package's on the hybrid
variant of ``serve-churn-under-load`` (``hymba-1.5b`` reduced to d_model
64, as ``chip_smoke.py``'s phase 7b serves it: attention and SSD layers,
f32), shortened as in ``test_torch_harness_serving.py`` to 2 iterations
of 32 generated tokens (JAX decodes this model eagerly in 76 s on the
CPU; the corpus length runs in the ``scenarios`` sweep).  Results,
plans, traces, timelines, counters and every greedy stream are equal,
exactly, the port on JAX's model and prompts.
"""
import pytest

pytest.importorskip("torch")

import torch

from tests.test_torch_harness_runtime import serving_checks_equal

HYBRID = dict(model="hymba-1.5b", model_d=64, iterations=2, gen_tokens=32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_hybrid_serving_checks_equal_jax_under_a_crash(monkeypatch):
    rt, tt = serving_checks_equal(monkeypatch, "serve-churn-under-load",
                                  **HYBRID)
    assert tt.cfg.has_ssm and tt.cfg.has_attention
    assert rt["serving-consistency"]["replay_steps"] > 0
