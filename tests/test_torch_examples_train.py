"""The port's training examples against the JAX package's, on the CPU.

``torch_quickstart.py`` (3 iterations; JAX's runs its fixed 10 and the
first 3 are compared) and ``torch_decentralized_train.py`` (3 iterations
with the fp and with the int8 activation store, reduced further to
d_model 64 and 32 tokens a sequence, on both sides) start from JAX's
seeded parameters:
the port's ``cache.initial_params`` is patched to load the JAX package's
draw, as ``tests/test_torch_harness_runtime.py`` does.  Their reports
agree line by line: the text around every number, so the network, the
flows and every counter, exactly; each loss within 2e-4 relative (f32,
one torch thread; 1e-3 with the int8 store), the gap between the two trainers' means within the
sum of their means' tolerances.  The activation store's megabytes are
each framework's own residual tensors (JAX's ``jax.vjp`` residuals,
autograd's saved tensors here) and are not compared.
"""
import dataclasses
import re

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.core.runtime import cache as j_cache
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.core.runtime import cache as t_cache
from repro_torch.models.config import PORT_ONLY_FIELDS
from repro_torch.weights import initial_params_from_jax
from test_torch_examples import load, output

LOSS_RTOL = 2e-4
NUMBER = re.compile(r"(\d+\.\d+)")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def jax_params(monkeypatch):
    """Port trainers start from the JAX package's draw for their config."""
    def from_jax(cfg, num_stages, seed=0, device="cuda"):
        jcfg = JModelConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                               if k not in PORT_ONLY_FIELDS})
        tree = jax.tree.map(np.asarray,
                            j_cache.initial_params(jcfg, num_stages, seed))
        return initial_params_from_jax(cfg, tree, device=device)

    monkeypatch.setattr(t_cache, "initial_params", from_jax)


def assert_same_report(got: str, want: str, rtol: float = LOSS_RTOL):
    """Line by line: the text between numbers equal; losses within
    ``rtol``; ``gap=`` within the sum of the two means' tolerances; the
    activation store's ``store=`` not compared."""
    got, want = got.splitlines(), want.splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gs, ws = NUMBER.split(g), NUMBER.split(w)
        assert gs[::2] == ws[::2], (g, w)
        means = [float(x) for x in ws[1::2]]
        for label, a, b in zip(gs[::2], gs[1::2], ws[1::2]):
            a, b = float(a), float(b)
            if label.endswith("store="):
                continue
            tol = (rtol * sum(means[:2]) if label.endswith("gap=")
                   else rtol * abs(b))
            assert abs(a - b) <= tol, (label, a, b)


def test_quickstart_matches_jax(jax_params):
    want = output(load("quickstart").main).splitlines()
    got = output(load("torch_quickstart").main,
                 ["--device", "cpu", "--iterations", "3"]).splitlines()
    first = len(got) - 3
    assert got[first].startswith("iter 0:") and want[first].startswith("iter 0:")
    assert_same_report("\n".join(got), "\n".join(want[:len(got)]))


# the int8 store rounds each residual to one of 255 levels, where a
# difference of an ulp between the frameworks can move a value by a level;
# its losses are held, as the trainer tests hold the iterations after the
# first, within 1e-3
@pytest.mark.parametrize("codec,rtol", [("fp", LOSS_RTOL), ("int8", 1e-3)])
def test_decentralized_train_matches_jax(jax_params, monkeypatch, codec, rtol):
    flags = ["--iterations", "3", "--activation-codec", codec, "--d-model",
             "64", "--seq-len", "32"]
    monkeypatch.setattr("sys.argv", ["decentralized_train.py", *flags])
    want = output(load("decentralized_train").main)
    got = output(load("torch_decentralized_train").main,
                 [*flags, "--device", "cpu"])
    assert "rerouted=" in got and f"MB {codec}," in got
    assert_same_report(got, want, rtol)
