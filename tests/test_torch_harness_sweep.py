"""The whole corpus through both packages' harnesses (``-m scenarios``).

Every applicable check of ``CHECKS`` on every spec of the standard
corpus, the real-compute ones included, the port on the CPU from the JAX
package's parameters, model and prompts (as in
``test_torch_harness_runtime.py``): the results are equal, exactly
(``store_peak_bytes`` aside, which counts each framework's own residual
tensors), and every recorded trainer agrees (plans, timelines, counters
and streams exactly, losses within ``LOSS_RTOL``).  Then the scale tier
with ``scale_checks``.  Deselected in tier-1 (``pytest.ini``): JAX's
eager decode alone takes minutes over the serving specs.
"""
import pytest
import torch

from repro.core.scenarios import corpus as j_corpus
from repro.core.scenarios import harness as j_harness
from repro_torch.core.scenarios import corpus as t_corpus
from repro_torch.core.scenarios import harness as t_harness
from tests.test_torch_harness_runtime import (FRAMEWORK_BYTES,
                                              assert_servers_agree,
                                              assert_trainers_agree, run_both,
                                              without)

CORPUS = j_corpus.load_corpus()
SCALE = j_corpus.load_corpus(tier="scale")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.scenarios
@pytest.mark.parametrize("name", [s.name for s in CORPUS])
def test_every_check_equals_jax(monkeypatch, name):
    rj, rt, built = run_both(monkeypatch, name, list(j_harness.CHECKS))
    assert without(rt, FRAMEWORK_BYTES) == without(rj, FRAMEWORK_BYTES)
    assert_trainers_agree(built["jax"][0], built["port"][0])
    if built["jax"][1]:
        assert_servers_agree(built["jax"][1], built["port"][1])


@pytest.mark.scenarios
@pytest.mark.parametrize("name", [s.name for s in SCALE])
def test_scale_checks_equal_jax(name):
    jspec, tspec = j_corpus.get_scenario(name), t_corpus.get_scenario(name)
    checks = j_harness.scale_checks(jspec)
    assert t_harness.scale_checks(tspec) == checks
    assert (t_harness.run_checks(tspec, checks, device="cpu")
            == j_harness.run_checks(jspec, checks))
