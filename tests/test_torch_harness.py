"""The port's scenario harness and corpus against the JAX package's.

The port's ``core/scenarios/harness.py`` is the reference's text with two
kinds of change: its ``repro.`` imports are rewritten to ``repro_torch.``,
and the checks that run real compute (``PORTED``) and ``run_checks`` take
a ``device`` and build the port's trainers on it.  The guard here parses
both modules with ``ast`` and, for every other top-level definition
(function, class or assignment: the numpy-only checks, ``CHECKS`` and
the fuzz-check tuples, the spec samplers, ``minimize``, ``fuzz``), holds
its source lines, decorators included, equal to the reference's once the
imports are rewritten.  Then, on the CPU:

* every spec of the standard corpus: the port's ``run_checks`` with the
  numpy checks (the applicable ``FUZZ_CHECKS`` and ``serving-invariants``)
  returns exactly what JAX's returns, and every check's applicability
  agrees;
* ``check_hierarchy_gap`` on a 150-relay ``geo-abstract`` spec: the same
  chains, cost and gap;
* the checks can fail: a tampered flow engine makes the port's harness
  raise, ``minimize`` shrinks, and ``fuzz`` wraps a crashing check and
  writes the shrunk spec into a ``tmp_path`` corpus directory, which
  ``load_corpus`` then picks up.

The real-compute checks are held against JAX in
``test_torch_harness_runtime.py`` and ``test_torch_harness_serving*.py``.
"""
import ast
import inspect
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.flow.hierarchy import solve_hierarchical as j_solve_hier
from repro.core.scenarios import corpus as j_corpus
from repro.core.scenarios import generate as j_generate
from repro.core.scenarios import harness as j_harness
from repro.core.scenarios.spec import ScenarioSpec as JSpec
from repro_torch.core.flow.hierarchy import solve_hierarchical as t_solve_hier
from repro_torch.core.scenarios import corpus as t_corpus
from repro_torch.core.scenarios import generate as t_generate
from repro_torch.core.scenarios import harness as t_harness
from repro_torch.core.scenarios.harness import ScenarioDiscrepancy
from repro_torch.core.scenarios.spec import ScenarioSpec as TSpec

IMPORT = re.compile(r"^(\s*)(from|import) repro\.")
# the checks the port runs on its own trainers, and the sweep that passes
# them a device
PORTED = {"check_sim_runtime_consistency", "check_fault_timeline",
          "check_detection_precision_recall", "check_zero_churn",
          "check_codec_agreement", "check_serving_consistency",
          "run_checks"}
NUMPY_CHECKS = list(j_harness.FUZZ_CHECKS) + ["serving-invariants"]
CORPUS = j_corpus.load_corpus()
CORPUS_IDS = [s.name for s in CORPUS]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _definitions(module):
    """``{name: source lines}`` of a module's top-level functions, classes
    and assignments (a function's decorators included)."""
    text = inspect.getsource(module)
    lines = text.splitlines()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names = [node.name]
        elif isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names = [node.target.id]
        else:
            continue
        first = min([node.lineno] + [d.lineno for d in
                                     getattr(node, "decorator_list", [])])
        for name in names:
            out[name] = lines[first - 1:node.end_lineno]
    return out


J_DEFS = _definitions(j_harness)
T_DEFS = _definitions(t_harness)
SHARED = sorted(set(J_DEFS) - PORTED)


@pytest.mark.parametrize("name", SHARED)
def test_numpy_only_definition_matches_reference(name):
    want = [IMPORT.sub(r"\1\2 repro_torch.", line) for line in J_DEFS[name]]
    assert name in T_DEFS, f"{name} missing from the port's harness"
    assert T_DEFS[name] == want, f"{name} drifted from the reference"


@pytest.mark.parametrize("name", sorted(PORTED))
def test_ported_checks_take_a_device(name):
    """The real-compute checks keep the reference's parameters and add
    ``device``, ``cuda`` by default."""
    j_params = list(inspect.signature(getattr(j_harness, name)).parameters)
    t_sig = inspect.signature(getattr(t_harness, name))
    assert list(t_sig.parameters) == j_params + ["device"]
    assert t_sig.parameters["device"].default == "cuda"


def test_checks_registry_matches_reference():
    assert list(t_harness.CHECKS) == list(j_harness.CHECKS)
    assert set(t_harness.REAL_COMPUTE) <= set(t_harness.CHECKS)
    for spec in CORPUS + j_corpus.load_corpus(tier="scale"):
        tspec = t_corpus.get_scenario(spec.name)
        for name in j_harness.CHECKS:
            assert (t_harness.CHECKS[name][1](tspec)
                    == j_harness.CHECKS[name][1](spec)), (spec.name, name)


def test_corpus_is_the_reference_corpus():
    for tier in ("standard", "scale"):
        j, t = j_corpus.load_corpus(tier=tier), t_corpus.load_corpus(tier=tier)
        assert [s.to_json() for s in t] == [s.to_json() for s in j]
    assert len(CORPUS) == 20
    here = Path(t_corpus.__file__).resolve().parent
    assert Path(t_corpus.CORPUS_DIR) == here / "corpus"
    assert "repro_torch" in Path(t_corpus.CORPUS_DIR).parts


@pytest.mark.parametrize("spec", CORPUS, ids=CORPUS_IDS)
def test_numpy_checks_equal_jax(spec):
    """The applicable numpy checks on one corpus spec: the port's results
    are JAX's, exactly."""
    tspec = t_corpus.get_scenario(spec.name)
    checks = [c for c in NUMPY_CHECKS if j_harness.CHECKS[c][1](spec)]
    assert checks
    assert (t_harness.run_checks(tspec, checks, device="cpu")
            == j_harness.run_checks(spec, checks))


GEO_ABSTRACT = dict(name="t-hier", seed=4, topology="geo-abstract",
                    num_stages=5, relays_per_stage=30, num_data_nodes=2,
                    source_capacity=8, capacity_range=(1, 4),
                    cost_range=(4, 21), num_locations=6, iterations=1,
                    objective="sum")


def test_hierarchy_gap_equals_jax():
    """150 relays over 6 locations, as ``tests/test_hierarchy.py``'s
    ``geo_net``: both packages' hierarchical planners route the same
    chains at the same cost, and the check reports the same gap."""
    jspec, tspec = JSpec(**GEO_ABSTRACT), TSpec(**GEO_ABSTRACT)
    jspec.validate()
    tspec.validate()
    out = t_harness.check_hierarchy_gap(tspec)
    assert out == j_harness.check_hierarchy_gap(jspec)
    assert out["flow"] > 0 and out["regions"] > 1
    plans = []
    for solve, gen, s in ((j_solve_hier, j_generate, jspec),
                          (t_solve_hier, t_generate, tspec)):
        net, cm = gen.build_network(s)
        plans.append(solve(net, cost_matrix=cm))
    assert plans[0].paths == plans[1].paths
    assert plans[0].cost == plans[1].cost and plans[0].flow == plans[1].flow


def small_spec(**kw):
    base = dict(name="t", seed=1, topology="synthetic", num_stages=3,
                relays_per_stage=3, num_data_nodes=1, source_capacity=3,
                capacity_range=(1, 3), cost_range=(1, 9), iterations=2)
    base.update(kw)
    return TSpec(**base).validate()


def test_discrepancy_detected_on_tampered_engine(monkeypatch):
    """The port's harness is not vacuous: one engine seeing a perturbed
    cost matrix makes ``check_flow_equivalence`` raise."""
    spec = small_spec(seed=3)
    real_build = t_generate.build_flow

    def tampered(s, engine="batched", net=None, cost_matrix=None):
        if engine == "batched" and cost_matrix is not None:
            cost_matrix = np.asarray(cost_matrix) + 1.0
        return real_build(s, engine, net=net, cost_matrix=cost_matrix)

    monkeypatch.setattr(t_generate, "build_flow", tampered)
    with pytest.raises(ScenarioDiscrepancy, match="batched"):
        t_harness.check_flow_equivalence(spec)


def test_minimize_shrinks_and_preserves_failure(monkeypatch):
    spec = small_spec(seed=8, num_stages=4, relays_per_stage=4,
                      num_data_nodes=2, churn=[{"kind": "bernoulli", "p": 0.2}])

    def fake_check(s):
        if s.relays_per_stage >= 3:
            raise ScenarioDiscrepancy(s, "fake", "too many relays")
        return {}

    monkeypatch.setattr(t_harness, "CHECKS", dict(
        t_harness.CHECKS, fake=(fake_check, lambda s: True)))
    small = t_harness.minimize(spec, ["fake"])
    assert small.relays_per_stage == 3
    assert small.num_stages < spec.num_stages
    assert not small.churn
    small.validate()


def test_fuzz_wraps_crash_and_writes_into_corpus_dir(monkeypatch, tmp_path):
    """A check dying with an arbitrary exception goes through the shrink
    and commit pipeline; the written spec joins ``load_corpus`` when the
    corpus directory is the one it was written to."""
    def crashing_check(s):
        raise IndexError("boom deep inside an engine")

    monkeypatch.setattr(t_harness, "CHECKS", dict(
        t_harness.CHECKS, crashy=(crashing_check, lambda s: True)))
    rep = t_harness.fuzz(seed=2, budget_seconds=30.0, max_cases=1,
                         corpus_dir=str(tmp_path), checks=["crashy"])
    assert len(rep.failures) == 1 and not rep.ok
    f = rep.failures[0]
    assert f.check == "crash:IndexError" and "boom" in f.detail
    assert f.written_to and os.path.dirname(f.written_to) == str(tmp_path)
    reloaded = TSpec.from_json(open(f.written_to).read())
    assert reloaded.name.startswith("shrunk-crash:IndexError-")
    monkeypatch.setattr(t_corpus, "CORPUS_DIR", str(tmp_path))
    assert reloaded.name in [s.name for s in t_corpus.load_corpus()]


def test_fuzz_sessions_equal_jax(tmp_path):
    """Three seeded fuzz cases over the fast checks: both packages sample
    the same specs and find nothing."""
    reps = [h.fuzz(seed=20260728, budget_seconds=120.0, max_cases=3,
                   corpus_dir=str(tmp_path / name), checks=h.FUZZ_CHECKS)
            for name, h in (("jax", j_harness), ("port", t_harness))]
    assert reps[0].cases == reps[1].cases == 3
    assert reps[0].ok and reps[1].ok
    rng = [np.random.default_rng(5) for _ in range(2)]
    for i in range(4):
        for sampler in ("random_spec", "random_adversarial_spec",
                        "random_serving_spec", "random_scale_spec"):
            a = getattr(j_harness, sampler)(rng[0], i)
            b = getattr(t_harness, sampler)(rng[1], i)
            assert a.to_json() == b.to_json(), sampler
