"""Each device's share of the sharded steps against the JAX package's.

On a (2, 4) ("data", "model") mesh, with the dry run's rules (the
sequence-parallel residual in train and prefill), the port's per-device
dot FLOPs of a reduced step (``dryrun._trace`` over fake tensors on a fake
process group) equal JAX's compiled HLO count per device
(``tests/_jax_launch.py steps``, all cases in one JAX process) within 1 %,
less the lm-head product JAX's ``jax.checkpoint`` recomputes in a train
step's backward: the train steps of a dense model with head_dim 256
(``gemma-7b``), GQA 9:1 (``starcoder2-7b``), the SSM (``mamba2-130m``) and
hybrid (``hymba-1.5b``) families, MoE (``qwen2-moe-a2.7b``) and audio
(``musicgen-medium``); 6 query heads over 2 K/V heads, which the 4-way
model axis does not divide (pad-sharded Q, replicated K/V); and a prefill
and a decode step of a dense and a hybrid model.  Then the sharded steps
compute what the unsharded ones do, on a real 8-process ``gloo`` mesh
(``tests/_torch_mesh_steps.py``).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.parallel.sharding import ShardingRules  # noqa: E402
from test_torch_sharding import jax_part  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S, D_MODEL, LAYERS = 8, 64, 256, 2
# (id, arch, step kind, fields replaced in the reduced config)
CASES = [(f"{arch}-train", arch, "train", {}) for arch in (
    "gemma-7b", "starcoder2-7b", "mamba2-130m", "hymba-1.5b",
    "qwen2-moe-a2.7b", "musicgen-medium")]
CASES += [("uneven-heads-6-over-2-train", "gwtf-llama-300m", "train",
           {"num_heads": 6, "num_kv_heads": 2})]
CASES += [(f"{arch}-{kind}", arch, kind, {}) for arch in
          ("gemma-7b", "hymba-1.5b") for kind in ("prefill", "decode")]
# the families the gloo mesh runs; "arch:field=value,..." replaces fields
# of the reduced config: uneven heads, and a vocab the model axis does not
# divide (the lm head replicated there, the loss on each device's rows)
MESH_ARCHS = ["gemma-7b", "gwtf-llama-300m:num_heads=6,num_kv_heads=2",
              "starcoder2-7b", "qwen1.5-4b", "mamba2-130m",
              "mamba2-130m:vocab_size=510", "hymba-1.5b", "qwen2-moe-a2.7b",
              "musicgen-medium", "llama-3.2-vision-90b"]
MESH_RTOL = 2e-5


def config(arch, override):
    cfg = dataclasses.replace(
        get_config(arch).reduced(num_layers=LAYERS, d_model=D_MODEL),
        param_dtype="bfloat16")
    return dataclasses.replace(cfg, **override)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_counts():
    cases = [{"key": key, "arch": arch, "kind": kind, "batch": B, "seq": S,
              "d_model": D_MODEL, "layers": LAYERS, "override": override}
             for key, arch, kind, override in CASES]
    return jax_part("steps", json.dumps(cases))


def port_costs(cfg, kind):
    shape = InputShape("case", S, B, kind)
    rules = ShardingRules(seq="model" if kind != "decode" else None)
    with dryrun.fake_world(8), torch.inference_mode(kind != "train"):
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        costs, _ = dryrun._trace(cfg, shape, mesh, rules, "dense", 1)
    return costs


@pytest.mark.parametrize("key,arch,kind,override", CASES,
                         ids=[c[0] for c in CASES])
def test_per_device_dot_flops_equal_jax(key, arch, kind, override,
                                        jax_counts):
    cfg = config(arch, override)
    costs = port_costs(cfg, kind)
    recompute = (2 * B * S * cfg.d_model * cfg.vocab_size
                 if kind == "train" else 0)
    theirs = jax_counts[key] * 8
    assert abs(costs.dot_flops * 8 + recompute - theirs) / theirs < 0.01


@pytest.fixture(scope="module")
def mesh_steps():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "tests" /
                                              "_torch_mesh_steps.py"),
                          *MESH_ARCHS], capture_output=True, text=True,
                         env=env, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_sharded_steps_compute_the_unsharded_steps(arch, mesh_steps):
    """Loss, gradients, prefill and decode logits on the (2, 4) gloo mesh,
    each within MESH_RTOL of the unsharded step's largest magnitude."""
    assert "error" not in mesh_steps, mesh_steps.get("error")
    diffs = mesh_steps[arch]
    assert set(diffs) == {"loss", "grads", "prefill", "decode"}
    assert max(diffs.values()) < MESH_RTOL, diffs
