"""The port's training CLI: ``--device cpu`` trains a reduced model with
falling losses in either mode, a missing GPU fails loudly, and the
``--mode spmd`` flags are accepted in either mode, as JAX's parser
accepts them."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch

from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tests' tensors are tiny; under several test workers torch's
    default of one thread per core oversubscribes the host many times."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_gwtf_cpu_trains(capsys):
    final = train.main(["--mode", "gwtf", "--reduced", "--device", "cpu",
                        "--iterations", "3", "--layers", "4", "--d-model",
                        "64", "--seq-len", "32", "--churn", "0.1"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("iter")]
    assert len(lines) == 3
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in lines]
    assert all(b < a for a, b in zip(losses, losses[1:]))
    assert final == pytest.approx(losses[-1], abs=1e-4)
    assert "tok/s" in lines[0] and "completed" in lines[0]


def test_module_entry_point_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mode", "gwtf",
         "--reduced", "--device", "cpu", "--iterations", "2", "--d-model",
         "64", "--seq-len", "16", "--stages", "2", "--layers", "2"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "final loss" in proc.stdout


def test_cuda_without_a_gpu_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--mode", "gwtf", "--reduced", "--iterations", "1"])


def test_spmd_trains_on_the_cpu(capsys):
    final = train.main(["--mode", "spmd", "--reduced", "--device", "cpu",
                        "--steps", "3", "--log-every", "1", "--layers", "2",
                        "--d-model", "64", "--seq-len", "32"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    assert len(lines) == 3
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in lines]
    assert all(b < a for a, b in zip(losses, losses[1:]))
    assert final == pytest.approx(losses[-1], abs=1e-4)
    assert "tok/s" in lines[0] and "ms" in lines[0]


@pytest.mark.parametrize("flag", [["--steps", "5"], ["--log-every", "2"],
                                  ["--checkpoint", "ckpt.npz"]])
def test_spmd_flags_are_accepted(flag):
    """In either mode, as JAX's parser takes them, with JAX's defaults."""
    for mode in ("gwtf", "spmd"):
        args = train.parser().parse_args(["--mode", mode] + flag)
        name = flag[0][2:].replace("-", "_")
        assert str(getattr(args, name)) == flag[1]
    defaults = train.parser().parse_args([])
    assert (defaults.steps, defaults.log_every, defaults.checkpoint) == (
        20, 5, None)
