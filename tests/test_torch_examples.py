"""The port's examples (``examples/torch_*.py``) against the JAX package's,
on the CPU.

* ``torch_churn_recovery.py`` (numpy only, a line-for-line copy) prints
  what ``churn_recovery.py`` prints, byte for byte;
* ``torch_scenario_tour.py --list`` and its default scenario print what
  ``scenario_tour.py`` prints, but for the closing hint's one line, which
  names the framework the real-compute leg needs ("needs PyTorch" against
  "needs JAX"); with ``trace-crash-rejoin --runtime`` on the cpu it
  reports JAX's plans and repair counts;
* ``torch_serve_decode.py`` decodes JAX's token ids on JAX's parameters
  and prompt (the example's ``serving_inputs`` patched to load them);
* ``torch_decentralized_train.py``: a ``--checkpoint-dir``/``--resume``
  round trip into ``tmp_path`` at churn 0, where the decentralized and
  centralized trainers coincide;
* every example that computes with torch runs on cuda unless told
  otherwise, and raises without a GPU rather than running on the cpu.

``test_torch_examples_train.py`` holds the two training examples against
JAX's.
"""
import contextlib
import importlib.util
import io
import re
from pathlib import Path

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs import get_config as jax_config
from repro.models.transformer import init_params as jax_init_params
from repro_torch.weights import params_from_jax

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def load(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def output(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def test_churn_recovery_prints_what_jax_prints():
    want = output(load("churn_recovery").main, [])
    got = output(load("torch_churn_recovery").main, [])
    assert got == want
    assert "GWTF" in got and "SWARM" in got


def test_scenario_tour_prints_what_jax_prints():
    jax_tour, tour = load("scenario_tour"), load("torch_scenario_tour")
    assert output(tour.main, ["--list"]) == output(jax_tour.main, ["--list"])
    want = output(jax_tour.main, []).splitlines()
    got = output(tour.main, []).splitlines()
    assert len(got) == len(want) > 10
    assert got[:-1] == want[:-1]
    assert want[-1].endswith("needs JAX)") and got[-1].endswith("needs PyTorch)")
    assert got[-1].replace("PyTorch", "JAX") == want[-1]


def test_scenario_tour_runtime_reports_jax_counts_on_cpu():
    want = output(load("scenario_tour").main, ["trace-crash-rejoin", "--runtime"])
    got = output(load("torch_scenario_tour").main,
                 ["trace-crash-rejoin", "--runtime", "--device", "cpu"])
    assert got == want
    assert "plans identical across layers for 3 iterations" in got
    assert re.search(r"runtime repaired [1-9]\d* microbatches", got)


def test_serve_decode_token_ids_equal_jax(monkeypatch):
    """JAX's example draws its parameters and prompt from PRNGKey(0); the
    port's, on those, decodes the same tokens through the ring buffer."""
    serve = load("torch_serve_decode")
    key = jax.random.PRNGKey(0)
    jcfg = jax_config("tinyllama-1.1b").reduced(num_layers=4, d_model=256)

    def from_jax(cfg, *, seed, batch, prompt_len, device):
        params = jax_init_params(jcfg, key)
        prompt = jax.random.randint(key, (batch, prompt_len), 0, cfg.vocab_size)
        model = params_from_jax(cfg, jax.tree.map(np.asarray, params),
                                device=device)
        return model, torch.from_numpy(np.array(prompt)).to(device), None

    monkeypatch.setattr(serve, "serving_inputs", from_jax)
    got = output(serve.main, ["--device", "cpu"]).splitlines()
    want = output(load("serve_decode").main).splitlines()
    strip = lambda line: re.sub(r"\(\d+\.\d+s\)", "(s)", line)  # noqa: E731
    assert [strip(x) for x in got] == [strip(x) for x in want]
    assert got[-1].startswith("sample token ids: [") and len(
        got[-1].split(",")) == 25


def test_decentralized_train_checkpoint_round_trip(tmp_path):
    """Two iterations at churn 0 with a snapshot after each, then a resumed
    run: both trainers restore step 2, so the decentralized loss equals
    the centralized one, and below the first run's loss on the same first
    batch."""
    train = load("torch_decentralized_train")
    flags = ["--churn", "0", "--layers", "4", "--d-model", "64",
             "--seq-len", "32", "--checkpoint-dir", str(tmp_path),
             "--device", "cpu"]
    first = output(train.main, ["--iterations", "2", "--checkpoint-every", "1",
                                *flags])
    assert {p.name for p in tmp_path.glob("*.npz")} == {
        "centralized.npz", "head_000.npz",
        *(f"stage_{s:03d}.npz" for s in range(4))}
    resumed = output(train.main, ["--iterations", "1", "--resume", *flags])
    assert (f"resumed from {tmp_path} at step 2 (centralized baseline at "
            f"step 2)") in resumed

    def losses(text):
        line = next(x for x in text.splitlines() if x.startswith("iter    0"))
        return [float(v) for v in re.findall(r"loss=(\d+\.\d+)", line)]

    (g0, c0), (g, c) = losses(first), losses(resumed)
    assert g0 == c0 and g == c
    assert g < g0 - 0.05


@pytest.mark.parametrize("name,argv", [
    ("torch_quickstart", []), ("torch_decentralized_train", []),
    ("torch_serve_decode", []), ("torch_scenario_tour", ["--runtime"])])
def test_examples_default_to_cuda(monkeypatch, name, argv):
    """Without a GPU the default device is an error, never a quiet CPU
    run: nothing trains or serves before it is raised."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = load(name)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(RuntimeError,
                                                        match="no CUDA device"):
        module.main(argv)
    assert buf.getvalue() == ""
