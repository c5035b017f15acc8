"""The JAX package's launch layer, for the port's tests to compare with.

Run as a script, in its own process: ``repro.launch.dryrun`` forces 512
host CPU devices before JAX starts, which a test process (JAX already
started with one device) cannot do.  ``python tests/_jax_launch.py
<part>`` prints one JSON object: the spec trees (``sharding``), the input
specs, parameter shapes and analytic memory (``specs``), a reduced
train step's HLO dot FLOPs on a (2, 4) mesh and the layout order of a
dim sharded over ("pod", "data") (``dryrun``), or the per-device HLO dot
FLOPs of reduced train, prefill and decode steps on that mesh, a JSON
list of cases in one process (``steps``).  Trees are flattened to
``{"a/b/c": leaf}``, a spec to a list of its entries.
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import repro.launch.dryrun as jdry  # noqa: E402  (sets XLA_FLAGS first)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_IDS, get_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.models.config import INPUT_SHAPES  # noqa: E402
from repro.models.transformer import init_cache  # noqa: E402
from repro.optim.adamw import AdamW  # noqa: E402
from repro.parallel.sharding import ShardingRules, param_spec_tree  # noqa: E402

ASSIGNED = [a for a in ARCH_IDS if not a.startswith("gwtf_")]


def meshes():
    return {"16x16": make_production_mesh(),
            "2x16x16": make_production_mesh(multi_pod=True),
            "1x1": jax.make_mesh((1, 1), ("data", "model"))}


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def flat(tree, leaf):
    """``{path: leaf(x)}`` over the leaves (NamedShardings or arrays)."""
    pairs, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))
    return {"/".join(_key(k) for k in path): leaf(x) for path, x in pairs}


def spec(x):
    return [list(a) if isinstance(a, tuple) else a for a in x.spec]


def grad_accum(cfg, shape, multi_pod: bool) -> int:
    """``dryrun.run_one``'s choice."""
    if shape.kind != "train":
        return 1
    dp = 32 if multi_pod else 16
    ga = jdry.DEFAULT_GRAD_ACCUM
    if cfg.d_model >= 8192 or cfg.is_moe:
        ga = 16
    return min(ga, shape.global_batch // dp)


def rules_for(shape):
    return ShardingRules(seq="model" if shape.kind != "decode" else None)


def step_specs(cfg, shape_name, mesh, multi_pod, params):
    """The in and out specs ``run_one`` gives the step; for decode also
    with an unpadded cache."""
    shape = INPUT_SHAPES[shape_name]
    rules = rules_for(shape)
    ga = grad_accum(cfg, shape, multi_pod)
    batch = jspecs.input_specs(cfg, shape_name, grad_accum=ga)
    out = {}
    if shape.kind == "train":
        opt_abs = jax.eval_shape(AdamW().init, params)
        ins, outs = jsteps.train_shardings(cfg, params, opt_abs, batch, rules,
                                           mesh, grad_accum=ga)
    elif shape.kind == "prefill":
        cache = jax.eval_shape(lambda: init_cache(cfg, shape.global_batch,
                                                  shape.seq_len))
        ins, outs = jsteps.serve_shardings(cfg, params, batch, rules, mesh,
                                           global_batch=shape.global_batch,
                                           cache_abstract=cache)
    else:
        ins, outs = jsteps.serve_shardings(cfg, params, batch, rules, mesh,
                                           global_batch=shape.global_batch)
        plain = dict(batch)
        plain["cache"] = jax.eval_shape(lambda: init_cache(
            cfg, shape.global_batch, jspecs.decode_cache_len(cfg, shape)))
        u_ins, u_outs = jsteps.serve_shardings(
            cfg, params, plain, rules, mesh, global_batch=shape.global_batch)
        out["unpadded"] = {"in": flat(u_ins, spec), "out": flat(u_outs, spec)}
    out.update({"grad_accum": ga, "in": flat(ins, spec),
                "out": flat(outs, spec)})
    return out


def part_sharding():
    ms = meshes()
    out = {"params": {}, "steps": {}}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        params = jspecs.abstract_params(cfg)
        for name, mesh in ms.items():
            out["params"][f"{arch}|{name}"] = flat(
                param_spec_tree(params, ShardingRules(), mesh), spec)
            if arch in ASSIGNED and name != "1x1":
                for shape_name in INPUT_SHAPES:
                    out["steps"][f"{arch}|{shape_name}|{name}"] = step_specs(
                        cfg, shape_name, mesh, name == "2x16x16", params)
    return out


def part_specs():
    out = {"inputs": {}, "params": {}, "memory": {}, "cache": {}}
    leaf = lambda x: [list(x.shape), str(x.dtype)]  # noqa: E731
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        params = jspecs.abstract_params(cfg)
        out["params"][arch] = {"leaves": flat(params, leaf),
                               "count": cfg.param_count()}
        if arch not in ASSIGNED:
            continue
        for shape_name, shape in INPUT_SHAPES.items():
            for ga in sorted({1, grad_accum(cfg, shape, False),
                              grad_accum(cfg, shape, True)}):
                out["inputs"][f"{arch}|{shape_name}|{ga}"] = flat(
                    jspecs.input_specs(cfg, shape_name, grad_accum=ga), leaf)
            for mp in (False, True):
                ga = grad_accum(cfg, shape, mp)
                out["memory"][f"{arch}|{shape_name}|{mp}"] = jdry.analytic_memory(
                    cfg, shape, chips=512 if mp else 256, grad_accum=ga)
        pad = jspecs.pad_kv_heads(cfg)
        out["cache"][arch] = {"pad": pad, "leaves": flat(jax.eval_shape(
            lambda: init_cache(cfg, 2, 8, kv_heads_override=pad or None)), leaf)}
    return out


def part_dryrun(arch: str, d_model: int, layers: int, batch: int, seq: int):
    """A reduced train step lowered on a (2, 4) mesh of 8 host devices,
    ``dryrun.run_one``'s rules; and which rows of 16 each of 8 devices
    holds under P(("pod", "data")) on a (2, 2, 2) mesh."""
    import dataclasses
    from repro.launch.hlo_analysis import analyze_hlo
    cfg = dataclasses.replace(get_config(arch).reduced(num_layers=layers,
                                                       d_model=d_model),
                              param_dtype="bfloat16")
    devices = np.array(jax.devices()[:8])
    mesh = Mesh(devices.reshape(2, 4), ("data", "model"))
    rules = ShardingRules(seq="model")
    params = jspecs.abstract_params(cfg)
    opt = AdamW()
    opt_abs = jax.eval_shape(opt.init, params)
    b = {"tokens": jax.ShapeDtypeStruct((batch, seq), jnp.int32),
         "labels": jax.ShapeDtypeStruct((batch, seq), jnp.int32)}
    ins, outs = jsteps.train_shardings(cfg, params, opt_abs, b, rules, mesh)
    step = jsteps.make_train_step(cfg, opt, mesh=mesh, rules=rules)
    with mesh:
        compiled = jax.jit(step, in_shardings=ins,
                           out_shardings=outs).lower(params, opt_abs, b).compile()
    hlo = analyze_hlo(compiled.as_text())
    pod = Mesh(devices.reshape(2, 2, 2), ("pod", "data", "model"))
    rows = NamedSharding(pod, P(("pod", "data"))).devices_indices_map((16,))
    return {"dot_flops": hlo.dot_flops, "devices": 8,
            "rows": {str(d.id): [s[0].start, s[0].stop]
                     for d, s in rows.items()}}


def part_steps(cases_json: str):
    """``[{"key", "arch", "kind", "batch", "seq", "d_model", "layers",
    "override"}]`` -> ``{key: per-device dot FLOPs}``: each case's config
    reduced to ``layers`` x ``d_model`` in bf16, ``override``'s fields
    replaced after (``dataclasses.replace``), its step lowered on a (2, 4)
    ("data", "model") mesh of 8 host devices with ``dryrun.run_one``'s
    rules and shardings (a train step at ``grad_accum`` 1; a prefill into a
    cache of ``seq``; a decode at the last slot of a cache of ``seq``)."""
    import dataclasses
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.models.config import InputShape
    devices = np.array(jax.devices()[:8])
    mesh = Mesh(devices.reshape(2, 4), ("data", "model"))
    out = {}
    for case in json.loads(cases_json):
        cfg = dataclasses.replace(
            get_config(case["arch"]).reduced(num_layers=case["layers"],
                                             d_model=case["d_model"]),
            param_dtype="bfloat16")
        cfg = dataclasses.replace(cfg, **case.get("override", {}))
        shape = InputShape("case", case["seq"], case["batch"], case["kind"])
        rules = rules_for(shape)
        params = jspecs.abstract_params(cfg)
        donate = ()
        if shape.kind == "train":
            opt = AdamW()
            opt_abs = jax.eval_shape(opt.init, params)
            batch = jspecs.train_batch_specs(cfg, shape)
            ins, outs = jsteps.train_shardings(cfg, params, opt_abs, batch,
                                               rules, mesh)
            step = jsteps.make_train_step(cfg, opt, mesh=mesh, rules=rules)
            args = (params, opt_abs, batch)
        elif shape.kind == "prefill":
            batch = jspecs.prefill_specs(cfg, shape)
            cache = jax.eval_shape(lambda: init_cache(cfg, shape.global_batch,
                                                      shape.seq_len))
            ins, outs = jsteps.serve_shardings(
                cfg, params, batch, rules, mesh,
                global_batch=shape.global_batch, cache_abstract=cache)
            step = jsteps.make_prefill_step(cfg, shape.seq_len, mesh=mesh,
                                            rules=rules)
            args = (params, batch)
        else:
            batch = jspecs.decode_specs(cfg, shape)
            ins, outs = jsteps.serve_shardings(
                cfg, params, batch, rules, mesh,
                global_batch=shape.global_batch)
            step = jsteps.make_decode_step(cfg, mesh=mesh, rules=rules)
            args = (params, batch)
            donate = (1,)
        with mesh:
            compiled = jax.jit(step, in_shardings=ins, out_shardings=outs,
                               donate_argnums=donate).lower(*args).compile()
        out[case["key"]] = analyze_hlo(compiled.as_text()).dot_flops
    return out


if __name__ == "__main__":
    part = sys.argv[1]
    if part == "steps":
        result = part_steps(sys.argv[2])
    elif part == "dryrun":
        arch, d, layers, batch, seq = sys.argv[2:7]
        result = part_dryrun(arch, int(d), int(layers), int(batch), int(seq))
    else:
        result = {"sharding": part_sharding, "specs": part_specs}[part]()
    print(json.dumps(result))
