"""The port's dry run (``launch/dryrun.py``) and its sharded steps.

``run_one`` over a reduced config (2 layers, d_model 128, bf16) of the
dense, MoE, hybrid and VLM families completes on both production meshes,
each on its own fake process group of 256 or 512 ranks: on (16, 16) a
train, a prefill and a decode step at small shapes, on (2, 16, 16) decode
steps (a multi-pod train or prefill traces for minutes in torch's CPU
build, whose redistribution planner searches three mesh dims; the full
widths run on a GPU host, ``chip_smoke.py`` phase 11a).  The VLM's
multi-pod decode takes a batch of 16, which the (pod, data) axes of 32 do
not divide, so its batch is replicated (JAX's rule); the dense and MoE
decodes shard a batch of 32 over both.  A train step shows the FSDP
all-gather and the gradient's reduce-scatter; a tp = 16 decode an
all-reduce.  The global dot FLOPs of a reduced dense train step on a
(2, 4) mesh equal JAX's ``analyze_hlo`` per-device count times 8 (JAX's
lowering, in its own process), less the one lm-head product JAX's
``jax.checkpoint`` recomputes in the backward, within 1 %, and so do the
port's per-device dot FLOPs times 8 (the other families, and prefill and
decode steps, in ``test_torch_dryrun_jax.py``).  A
world-size-1 ``gloo`` group: the sharded train step on the (1, 1) mesh
equals the unsharded one bit for bit over 3 steps, f32 and bf16.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.train import spmd_params  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.parallel.sharding import ShardingRules, distribute  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_sharding import jax_part  # noqa: E402

FAMILIES = {"dense": "gemma_7b", "moe": "qwen2_moe_a2_7b",
            "hybrid": "hymba_1_5b", "vlm": "llama3_2_vision_90b"}
TRAIN = InputShape("train_small", 256, 64, "train")
PREFILL = InputShape("prefill_small", 256, 32, "prefill")
DECODE = InputShape("decode_small", 512, 32, "decode")
CASES = [("dense", TRAIN, False), ("moe", PREFILL, False),
         ("hybrid", PREFILL, False), ("vlm", DECODE, False),
         ("dense", DECODE, True), ("moe", DECODE, True),
         ("hybrid", DECODE, True),
         ("vlm", dataclasses.replace(DECODE, global_batch=16), True)]


def reduced(arch):
    return dataclasses.replace(get_config(arch).reduced(num_layers=2,
                                                        d_model=128),
                               param_dtype="bfloat16")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("family,shape,multi_pod", CASES,
                         ids=[f"{f}-{s.kind}-{'2x16x16' if m else '16x16'}"
                              for f, s, m in CASES])
def test_reduced_dry_run_completes(family, shape, multi_pod):
    arch = FAMILIES[family]
    r = dryrun.run_one(arch, shape, multi_pod=multi_pod, device="cpu",
                       cfg=reduced(arch), verbose=False)
    assert not dist.is_initialized()                # the fake group is gone
    assert r["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert r["dot_flops"] > 0 and r["global_flops"] > 0
    assert r["memory"]["argument_size"] > 0 and r["memory"]["peak"] > 0
    assert r["fits"]
    detail = r["collective_detail"]
    assert sum(detail.values()) == r["collective_bytes"] > 0
    if shape.kind == "train":
        # FSDP: weights all-gathered over data; gradients reduce-scattered
        assert detail["all-gather"] > 0 and detail["reduce-scatter"] > 0
        assert r["grad_accum"] == 4 and r["grad_accum_traced"] == 1
    if shape.kind == "decode" and family == "dense":
        assert detail["all-reduce"] > 0             # tp = 16 partial sums


def test_train_dot_flops_equal_jax():
    cfg = dataclasses.replace(get_config("gwtf_llama_300m").reduced(
        num_layers=2, d_model=256), param_dtype="bfloat16")
    B, S = 8, 64
    theirs = jax_part("dryrun", "gwtf-llama-300m", 256, 2, B, S)
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        costs, _ = dryrun._trace(cfg, InputShape("train", S, B, "train"),
                                 mesh, ShardingRules(seq="model"), "dense", 1)
    recompute = 2 * B * S * cfg.d_model * cfg.vocab_size
    jax_global = theirs["dot_flops"] * theirs["devices"]
    assert abs(costs.global_flops + recompute - jax_global) / jax_global < 0.01
    # and per device: every product sharded over the 8 devices, as in JAX
    assert abs(costs.dot_flops * 8 + recompute - jax_global) / jax_global < 0.01


@pytest.fixture()
def gloo_world():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_host_mesh("cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_step_on_one_rank_equals_the_step(dtype, gloo_world):
    mesh, rules = gloo_world, ShardingRules()
    cfg = dataclasses.replace(get_config("gwtf-llama-300m").reduced(
        num_layers=2, d_model=64), param_dtype=dtype)
    opt = AdamW(lr=1e-3)
    rng = np.random.default_rng(0)
    batches = [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
                for k in ("tokens", "labels")} for _ in range(3)]
    p0 = spmd_params(cfg, 0, "cpu")
    runs = []
    for on_mesh in (False, True):
        params, state = p0, opt.init(p0)
        step = steps.make_train_step(cfg, opt, mesh=mesh if on_mesh else None,
                                     rules=rules)
        if on_mesh:
            (ps, os_, bs), _ = steps.train_shardings(cfg, params, state,
                                                     batches[0], rules, mesh)
            params, state = distribute(params, ps, mesh), distribute(state, os_,
                                                                     mesh)
        losses = []
        for b in batches:
            params, state, loss = step(params, state,
                                       distribute(b, bs, mesh) if on_mesh else b)
            losses.append(loss)
        full = (lambda t: t.full_tensor()) if on_mesh else (lambda t: t)
        runs.append([full(t) for t in losses + leaves(params) + leaves(state)])
    assert len(runs[0]) == len(runs[1])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_depth_extrapolation_equals_the_full_trace():
    """A 4-layer dense train step traced at 1 and 2 layers and extrapolated
    counts what the 4-layer trace counts: FLOPs, collectives and argument
    bytes exactly."""
    cfg = dataclasses.replace(reduced("gemma_7b"), num_layers=4)
    r = dryrun.run_one("gemma_7b", TRAIN, multi_pod=False, device="cpu",
                       cfg=cfg, verbose=False)
    assert r["layers_traced"] == [1, 2] and r["layers"] == 4
    with dryrun.fake_world(256):
        mesh = dryrun.make_production_mesh(device_type="cpu")
        costs, arg_bytes = dryrun._trace(
            cfg, TRAIN, mesh, ShardingRules(seq="model"), "dense",
            r["grad_accum"])
    assert r["dot_flops"] == costs.dot_flops
    assert r["global_flops"] == costs.global_flops
    assert r["collective_detail"] == costs.collective_bytes
    assert r["collective_count"] == costs.collective_count
    assert r["memory"]["argument_size"] == arg_bytes
