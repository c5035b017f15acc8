"""The port's zero-churn stream check against the JAX package's on the
corpus scenario ``serve-steady-poisson`` (Poisson arrivals, no churn),
dense and hybrid (``hymba-1.5b`` at d_model 64).

Without churn ``check_serving_consistency`` also decodes two completed
requests one at a time through ``prefill`` and ``decode_step``, JAX's
functional calls there and the port's in-place cache here, and holds
their greedy streams equal to the ``ServeTrainer``'s stacked cohorts.
Both packages run it, the port on the CPU from JAX's model and prompts:
results (``streams_checked`` included), plans, timelines, counters and
every stream are equal, exactly.
"""
import pytest

pytest.importorskip("torch")

import torch

from tests.test_torch_harness_runtime import serving_checks_equal


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("over", [{}, {"model": "hymba-1.5b", "model_d": 64}],
                         ids=["dense", "hybrid"])
def test_zero_churn_streams_equal_jax(monkeypatch, over):
    rt, _ = serving_checks_equal(monkeypatch, "serve-steady-poisson", **over)
    assert rt["serving-consistency"]["streams_checked"] == 2
