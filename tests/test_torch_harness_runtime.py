"""The port's real-compute harness checks against the JAX package's, on
the CPU, on corpus specs.

Both packages run the same check on the same spec: ``zero-churn`` on
``geo-zero-churn``, ``sim-runtime`` on ``trace-crash-rejoin``,
``fault-timeline`` and ``detection-precision-recall`` on
``adversarial-corrupt``, ``codec-agreement`` on ``geo-wan-compress``, and
``sim-runtime`` on ``serve-steady-poisson``, whose 3 stages split 2
layers, so that its last stage holds no block (the port failed to build
such a stage before; JAX stacks no block into leaves of length 0).
The port's trainers start from the JAX trainers' parameters:
``initial_params`` of the port's runtime cache is patched to load the JAX
package's draw through ``weights.initial_params_from_jax``.  Each
package's ``generate.build_runtime`` is wrapped to record the trainers it
builds and every ``IterationResult``.  Then:

* the checks' results are equal, exactly, except ``store_peak_bytes``
  (``zero-churn``): the activation store holds JAX's ``jax.vjp``
  residuals there and autograd's saved tensors here, which are not the
  same tensors (36.6 and 33.4 MB at this spec);
* trainer by trainer: the recorded chain plans, the fault timeline, every
  iteration's counters (completed, launched, dropped, rerouted, requeued,
  recomputes, replays, flagged gradients, wire bytes and codecs) are
  equal, exactly, and every loss is within ``LOSS_RTOL`` of JAX's.

``LOSS_RTOL`` is 2e-4 relative: f32, TF32 off, one torch thread; the
reduced models of these specs (d_model 32-128) run up to six AdamW steps
at lr 3e-3.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.runtime import cache as j_cache
from repro.core.runtime import serving as j_serving
from repro.core.scenarios import corpus as j_corpus
from repro.core.scenarios import generate as j_generate
from repro.core.scenarios import harness as j_harness
from repro_torch.core.runtime import cache as t_cache
from repro_torch.core.runtime import serving as t_serving
from repro_torch.core.scenarios import corpus as t_corpus
from repro_torch.core.scenarios import generate as t_generate
from repro_torch.core.scenarios import harness as t_harness
from repro_torch.weights import initial_params_from_jax, params_from_jax

LOSS_RTOL = 2e-4
RESULT_FIELDS = ("completed", "launched", "dropped", "rerouted", "requeued",
                 "fwd_recomputes", "bwd_replays", "grads_flagged",
                 "wire_bytes", "wire_codecs", "deadline_requeues")
# the store's peak bytes count each framework's own residual tensors
FRAMEWORK_BYTES = ("store_peak_bytes",)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_training_params(monkeypatch, jspec):
    """Every port trainer built while the patch holds starts from the JAX
    package's seeded parameters for ``jspec``'s model."""
    jcfg = j_generate.model_config(jspec)

    def from_jax(cfg, num_stages, seed=0, device="cuda"):
        tree = jax.tree.map(np.asarray,
                            j_cache.initial_params(jcfg, num_stages, seed))
        return initial_params_from_jax(cfg, tree, device=device)

    monkeypatch.setattr(t_cache, "initial_params", from_jax)


def jax_serving_inputs(monkeypatch, jspec):
    """``serving_inputs`` of the port gives the JAX package's model and
    prompts for ``jspec``'s model, on the device asked for."""
    jcfg = j_generate.model_config(jspec)

    def from_jax(cfg, *, seed, batch, prompt_len, device="cuda"):
        params, prompt, *_ = j_serving.serving_inputs(
            jcfg, seed=seed, batch=batch, prompt_len=prompt_len)
        model = params_from_jax(cfg, jax.tree.map(np.asarray, params),
                                device=device)
        return model, torch.from_numpy(np.array(prompt)).to(device), None

    monkeypatch.setattr(t_serving, "serving_inputs", from_jax)


def record(monkeypatch, generate, builder="build_runtime"):
    """Wrap ``generate.<builder>`` to record each trainer it builds and, for
    training runtimes, each iteration's result as ``trainer.results``."""
    built = []
    real = getattr(generate, builder)

    def wrapped(spec, *args, **kw):
        out = real(spec, *args, **kw)
        trainer = out[0] if isinstance(out, tuple) else out
        if builder == "build_runtime":
            trainer.results = []
            step = trainer.iteration

            def iteration(batches, _step=step, _results=trainer.results):
                r = _step(batches)
                _results.append(r)
                return r
            trainer.iteration = iteration
        built.append(trainer)
        return out

    monkeypatch.setattr(generate, builder, wrapped)
    return built


def assert_trainers_agree(jts, tts):
    """Recorded training runtimes, pairwise: plans, timelines, counters
    exactly; losses within LOSS_RTOL."""
    assert len(jts) == len(tts) > 0
    for jt, tt in zip(jts, tts):
        if hasattr(jt.policy, "plans"):
            assert tt.policy.plans == jt.policy.plans
        assert ([vars(r) for r in tt.timeline.records]
                == [vars(r) for r in jt.timeline.records])
        assert len(tt.results) == len(jt.results) > 0
        for it, (rj, rt) in enumerate(zip(jt.results, tt.results)):
            for f in RESULT_FIELDS:
                assert getattr(rt, f) == getattr(rj, f), (it, f)
            assert abs(rt.loss - rj.loss) <= LOSS_RTOL * abs(rj.loss), \
                (it, rt.loss, rj.loss)
        assert tt.stages.snapshot() == jt.stages.snapshot()


SERVE_COUNTERS = ("prefill_calls", "decode_dispatches", "stacked_rows",
                  "replay_steps")


def assert_servers_agree(jts, tts):
    """Recorded ``ServeTrainer``s, pairwise: recorded plans, the engine's
    chain plans, traces, fault timeline, counters and every request's
    greedy stream, exactly."""
    assert len(jts) == len(tts) > 0
    for jt, tt in zip(jts, tts):
        assert tt.engine.policy.plans == jt.engine.policy.plans
        assert tt.engine.chain_plans == jt.engine.chain_plans
        assert tt.engine.traces == jt.engine.traces
        assert ([vars(r) for r in tt.timeline.records]
                == [vars(r) for r in jt.timeline.records])
        assert ({c: getattr(tt, c) for c in SERVE_COUNTERS}
                == {c: getattr(jt, c) for c in SERVE_COUNTERS})
        assert sorted(tt.engine.requests) == sorted(jt.engine.requests)
        for rid in jt.engine.requests:
            assert tt.token_stream(rid) == jt.token_stream(rid), rid


def serving_checks_equal(monkeypatch, name, **over):
    """``serving-invariants`` and ``serving-consistency`` on one corpus
    spec (``over`` applied) in both packages, the port on JAX's model
    and prompts: equal results and equal trainers.  Returns the port's
    results and trainer."""
    rj, rt, built = run_both(monkeypatch, name, ["serving-invariants",
                                                 "serving-consistency"],
                             **over)
    assert rt == rj
    assert_servers_agree(built["jax"][1], built["port"][1])
    return rt, built["port"][1][0]


def run_both(monkeypatch, name, checks, **over):
    """One corpus spec (with ``over`` applied) through both packages'
    ``run_checks``; returns both results and the recorded trainers."""
    jspec = j_corpus.get_scenario(name).replace(**over)
    tspec = t_corpus.get_scenario(name).replace(**over)
    assert tspec.to_json() == jspec.to_json()
    jax_training_params(monkeypatch, jspec)
    jax_serving_inputs(monkeypatch, jspec)
    built = {}
    for pkg, gen in (("jax", j_generate), ("port", t_generate)):
        built[pkg] = (record(monkeypatch, gen),
                      record(monkeypatch, gen, "build_serving_runtime"))
    rj = j_harness.run_checks(jspec, checks)
    rt = t_harness.run_checks(tspec, checks, device="cpu")
    return rj, rt, built


def without(result, keys):
    return {check: {k: v for k, v in out.items() if k not in keys}
            for check, out in result.items()}


@pytest.mark.parametrize("name,checks", [
    ("geo-zero-churn", ["zero-churn"]),
    ("trace-crash-rejoin", ["sim-runtime"]),
    ("adversarial-corrupt", ["fault-timeline", "detection-precision-recall"]),
    ("geo-wan-compress", ["codec-agreement"]),
    # 3 stages over 2 layers: the last stage holds no block
    ("serve-steady-poisson", ["sim-runtime"])])
def test_training_checks_equal_jax(monkeypatch, name, checks):
    rj, rt, built = run_both(monkeypatch, name, checks)
    assert without(rt, FRAMEWORK_BYTES) == without(rj, FRAMEWORK_BYTES)
    assert_trainers_agree(built["jax"][0], built["port"][0])
    if name == "trace-crash-rejoin":
        assert rt["sim-runtime"]["runtime_rerouted"] > 0
    if name == "adversarial-corrupt":
        assert sum(rt["detection-precision-recall"]["detected"]) > 0
        assert rt["fault-timeline"]["cross_layer_detections"] > 0
    if name == "geo-wan-compress":
        assert rt["codec-agreement"]["runtime_wire_bytes"] > 0
    if name == "geo-zero-churn":
        # the decentralized, the remat oracle: the centralized trainer
        # is no runtime and is held inside the check
        assert len(built["port"][0]) == 2


def test_zero_churn_check_holds_its_bit_equalities(monkeypatch):
    """The port's ``check_zero_churn`` raises when a bit-equality breaks:
    a centralized trainer whose loss is one ulp off fails it."""
    from repro_torch.core.runtime import trainer as t_trainer
    real = t_trainer.CentralizedTrainer.iteration

    def off(self, mbs):
        return float(np.nextafter(real(self, mbs), np.inf))

    monkeypatch.setattr(t_trainer.CentralizedTrainer, "iteration", off)
    with pytest.raises(t_harness.ScenarioDiscrepancy, match="centralized"):
        t_harness.check_zero_churn(t_corpus.get_scenario("geo-zero-churn"),
                                   device="cpu")


def test_zero_churn_check_restores_determinism_flag():
    before = torch.are_deterministic_algorithms_enabled()
    t_harness.check_zero_churn(t_corpus.get_scenario("geo-zero-churn"),
                               iterations=1, device="cpu")
    assert torch.are_deterministic_algorithms_enabled() == before


def test_real_compute_checks_default_to_cuda(monkeypatch):
    """With no GPU, a real-compute check asked for no device runs on
    ``cuda`` and fails with the port's missing-GPU error, never quietly on
    the CPU; the zero-churn leg on ``cuda`` names the cuBLAS setting it
    needs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    spec = t_corpus.get_scenario("trace-crash-rejoin")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_harness.run_checks(spec, ["sim-runtime"])
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        with t_harness.deterministic("cuda"):
            pass
