"""The port's sharding rules and step specs against the JAX package's.

For all 13 configs' stacked abstract parameter trees on the (16, 16),
(2, 16, 16) and (1, 1) meshes, ``param_spec_tree`` equals JAX's leaf for
leaf; for every assigned arch and input shape on both production meshes,
the in and out specs of ``train_shardings`` / ``serve_shardings`` (the
decode cache padded by ``pad_kv_heads`` and not) equal JAX's, with the
rules and ``grad_accum`` ``dryrun.run_one`` picks.  JAX runs in its own
process (``tests/_jax_launch.py``, 512 host devices); the port's meshes
sit on a fake process group.  Then ``shard`` without rules, the
placements of a dim over two mesh axes against JAX's device order, the
JAX package's ``TestParamSpecs`` cases, the layout helpers off a mesh,
and an op DTensor refuses inside a sharded step, which raises.
"""
import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import Replicate, Shard, distribute_tensor  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import specs, steps  # noqa: E402
from repro_torch.launch.dryrun import fake_world  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.models.config import INPUT_SHAPES  # noqa: E402
from repro_torch.models.transformer import init_cache  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.parallel.sharding import (P, ShardingRules,  # noqa: E402
                                           param_spec_tree, placements,
                                           shard, use_rules)
from repro_torch.tree import tree_map_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ASSIGNED = [a for a in ARCH_IDS if not a.startswith("gwtf_")]
MESHES = {"16x16": 256, "2x16x16": 512, "1x1": 1}


def jax_part(part: str, *args) -> dict:
    """``tests/_jax_launch.py part args`` in its own process."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(ROOT / "tests" / "_jax_launch.py"),
                          part, *map(str, args)], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


def flat(tree, leaf=lambda s: [list(a) if isinstance(a, tuple) else a
                               for a in s]) -> dict:
    """``{"a/b/c": leaf(x)}``, as ``_jax_launch.flat`` gives."""
    out = {}
    tree_map_with_path(lambda p, x: out.__setitem__(
        "/".join(map(str, p)), leaf(x)), tree)
    return out


def mesh_of(name: str):
    if name == "1x1":
        return make_host_mesh("cpu")
    return make_production_mesh(multi_pod=name == "2x16x16", device_type="cpu")


@lru_cache(maxsize=None)
def abstract(arch: str):
    return specs.abstract_params(get_config(arch))


def grad_accum(cfg, shape, multi_pod: bool) -> int:
    """``dryrun.run_one``'s choice."""
    if shape.kind != "train":
        return 1
    ga = 16 if (cfg.d_model >= 8192 or cfg.is_moe) else 8
    return min(ga, shape.global_batch // (32 if multi_pod else 16))


def step_specs(cfg, shape_name, mesh, multi_pod, params):
    """The port's counterpart of ``_jax_launch.step_specs``."""
    shape = INPUT_SHAPES[shape_name]
    rules = ShardingRules(seq="model" if shape.kind != "decode" else None)
    ga = grad_accum(cfg, shape, multi_pod)
    batch = specs.input_specs(cfg, shape_name, grad_accum=ga)
    out = {}
    if shape.kind == "train":
        ins, outs = steps.train_shardings(cfg, params, AdamW().init(params),
                                          batch, rules, mesh, grad_accum=ga)
    elif shape.kind == "prefill":
        cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                           device="meta")
        ins, outs = steps.serve_shardings(cfg, params, batch, rules, mesh,
                                          global_batch=shape.global_batch,
                                          cache_abstract=cache)
    else:
        ins, outs = steps.serve_shardings(cfg, params, batch, rules, mesh,
                                          global_batch=shape.global_batch)
        plain = dict(batch, cache=init_cache(
            cfg, shape.global_batch, specs.decode_cache_len(cfg, shape),
            device="meta"))
        u_ins, u_outs = steps.serve_shardings(
            cfg, params, plain, rules, mesh, global_batch=shape.global_batch)
        out["unpadded"] = {"in": flat(u_ins), "out": flat(u_outs)}
    out.update({"grad_accum": ga, "in": flat(ins), "out": flat(outs)})
    return out


@pytest.fixture(scope="module")
def jax_specs():
    return jax_part("sharding")


@pytest.fixture(scope="module")
def port_specs():
    """Every spec tree of the port, each mesh on its own fake group."""
    out = {"params": {}, "steps": {}}
    for name, world in MESHES.items():
        with fake_world(world):
            mesh = mesh_of(name)
            for arch in ARCH_IDS:
                cfg, params = get_config(arch), abstract(arch)
                out["params"][f"{arch}|{name}"] = flat(
                    param_spec_tree(params, ShardingRules(), mesh))
                if arch in ASSIGNED and name != "1x1":
                    for shape_name in INPUT_SHAPES:
                        out["steps"][f"{arch}|{shape_name}|{name}"] = step_specs(
                            cfg, shape_name, mesh, name == "2x16x16", params)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_spec_tree_equals_jax(arch, mesh, jax_specs, port_specs):
    key = f"{arch}|{mesh}"
    assert port_specs["params"][key] == jax_specs["params"][key]


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_step_shardings_equal_jax(arch, shape, mesh, jax_specs, port_specs):
    """train_shardings (params, AdamW state, batch; outputs) or
    serve_shardings (params, batch with the cache; logits and cache), and
    for decode also with an unpadded cache."""
    key = f"{arch}|{shape}|{mesh}"
    assert port_specs["steps"][key] == jax_specs["steps"][key]


def test_shard_is_the_identity_without_rules_or_dtensor():
    x = torch.randn(4, 8, 16)
    assert shard(x, "batch", "seq", None) is x
    with fake_world(256):
        mesh = mesh_of("16x16")
        with use_rules(ShardingRules(seq="model"), mesh):
            assert shard(x, "batch", "seq", None) is x     # a plain tensor


def test_two_mesh_axes_shard_in_jax_device_order():
    """P(("pod", "data")) on a (2, 2, 2) mesh: DTensor shards the dim over
    pod, then data (mesh-dim order); each rank's rows equal the rows JAX
    gives the device of that id under the tuple's order."""
    jax_rows = jax_part("dryrun", "gwtf-llama-300m", 64, 1, 8, 32)["rows"]
    spec = P(("pod", "data"))
    for rank in range(8):
        torch.distributed.init_process_group("fake", store=FakeStore(),
                                             rank=rank, world_size=8)
        try:
            mesh = init_device_mesh("cpu", (2, 2, 2),
                                    mesh_dim_names=("pod", "data", "model"))
            assert placements(spec, mesh) == [Shard(0), Shard(0), Replicate()]
            local = distribute_tensor(
                torch.arange(16), mesh, placements(spec, mesh),
                src_data_rank=None).to_local()
        finally:
            torch.distributed.destroy_process_group()
        start, stop = jax_rows[str(rank)]
        assert local.tolist() == list(range(start, stop)), rank
    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        with pytest.raises(ValueError):
            placements(P(("data", "pod")), mesh)


class TestParamSpecs:
    """The JAX package's ``tests/test_launch.py::TestParamSpecs``."""

    @pytest.fixture()
    def host_mesh(self):
        with fake_world(1):
            yield make_host_mesh("cpu")

    def test_fsdp_tp_2d_sharding(self, host_mesh):
        specs_ = param_spec_tree(abstract("tinyllama-1.1b"), ShardingRules(),
                                 host_mesh)
        wq = specs_["blocks"]["attn"]["wq"]
        assert wq[-2:] == ("data", "model")      # (fsdp, tp)
        wo = specs_["blocks"]["attn"]["wo"]
        assert wo[-2:] == ("model", "data")      # row-parallel
        assert tuple(specs_["final_norm"]["scale"]) in ((), (None,))

    def test_moe_expert_weights(self, host_mesh):
        specs_ = param_spec_tree(abstract("granite-moe-3b-a800m"),
                                 ShardingRules(), host_mesh)
        wg = specs_["blocks"]["moe"]["w_gate"]
        # (L, E, D, F) -> (None, expert=None, fsdp, tp)
        assert wg[-2:] == ("data", "model")
        assert wg[0] is None and wg[1] is None

    def test_indivisible_dims_dropped(self):
        params = {"attn": {"wq": torch.zeros((2, 7, 13))}}
        with fake_world(1):
            specs_ = param_spec_tree(params, ShardingRules(), mesh_of("1x1"))
        assert len(specs_["attn"]["wq"]) == 3
        with fake_world(256):
            big = param_spec_tree(params, ShardingRules(), mesh_of("16x16"))
        assert big["attn"]["wq"] == (None, None, None)   # neither 7 nor 13


def test_layout_helpers_pass_plain_tensors_through():
    """Off a mesh (every path of one card) each helper is the plain op,
    bit for bit."""
    from repro_torch.parallel.sharding import (merge_last, on_shards,
                                               project, reshape, split_last)
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(2, 3, 8, generator=g), torch.randn(8, 5, generator=g)
    assert torch.equal(project(x, w), x @ w)
    assert torch.equal(split_last(x, 4), x.reshape(2, 3, 4, 2))
    assert torch.equal(merge_last(x), x.reshape(2, 24))
    assert torch.equal(reshape(x, 6, 8), x.reshape(6, 8))
    assert on_shards(lambda a, b: a + b, [(x, 2, True), (1.5, None, False)],
                     [(x.shape, 2)]).equal(x + 1.5)


def test_a_refused_op_raises_naming_it_and_is_not_retried():
    """An op DTensor has no strategy for (``aten.renorm``), inside a
    sharded step's context: the error names the op and its input's
    placements, and no replicated copy of the op ran."""
    from torch.distributed.tensor import Shard as S_
    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        x = distribute_tensor(torch.randn(8, 16), mesh, [S_(0), S_(1)],
                              src_data_rank=None)
        ran = []
        with steps._on_mesh(mesh, ShardingRules()):
            with pytest.raises(RuntimeError,
                               match=r"aten\.renorm.*Shard\(dim=0\), "
                                     r"Shard\(dim=1\)") as err:
                ran.append(torch.renorm(x, 2, 0, 1.0))
        assert not ran
        assert "DTensor refused" in str(err.value)
