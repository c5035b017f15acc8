"""Multi-pod dry run: trace every (arch x input-shape x mesh) on fake devices.

Port of ``repro.launch.dryrun``.  Where JAX forces 512 host CPU devices
and lowers against ``ShapeDtypeStruct``s, the port sets up a *fake*
process group of 256 or 512 ranks in this one process (no communication,
no second card) and a ``DeviceMesh`` over it:

  * single-pod (16, 16)   ("data", "model")          = 256 cards
  * multi-pod  (2, 16, 16) ("pod", "data", "model")  = 512 cards

It builds fake parameters, optimizer state and inputs from ``specs.py``
(shards of ``FakeTensor``s, which allocate nothing), laid out as
DTensors by ``train_shardings`` / ``serve_shardings``, runs the step of
the shape's kind (train_4k -> train_step, prefill_32k -> prefill_step,
decode_32k / long_500k -> serve_step) eagerly as rank 0, and reads
its per-device costs with ``trace_analysis`` (the inputs of a roofline).
The group is destroyed before ``run_one`` returns.

Loops are traced once and scaled, as the HLO analysis multiplies a scan
body by its trip count.  A train step with ``grad_accum`` > 1 is traced
at one microbatch: ``grad_accum`` x (one microbatch's step) -
(``grad_accum`` - 1) x (the AdamW update alone); the record says
``"grad_accum_traced": 1``.  The layers are traced at depths of one and
two units (layers; a VLM's superblocks) and every count extrapolated
linearly to the config's depth, f(n) = f(1) + (n - 1) x (f(2) - f(1)),
but the step's own memory peak, which grows by what the second unit
adds, if anything; the record names the depths (``"layers_traced"``).
Each traced step runs twice, the first time untraced
(``trace_analysis.analyze_step``).

Memory per device: ``argument_size`` is the bytes of the step's input
shards on one device; ``temp_size`` the peak of what the step allocates
on it, from ``MemTracker`` over the fake shards; ``peak`` their sum.
``analytic_memory`` is the JAX package's model, copied exactly, and
``fits`` says whether its total is within one H100's 80 GB.
``x_ideal`` is the per-device dot FLOPs times the devices over the FLOPs
of the same step run unsharded: how many devices repeat each product.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma_7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod|--both-meshes] [--jobs 8]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Union

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import HBM_BYTES, make_production_mesh
from repro_torch.launch.specs import (abstract_params, decode_cache_len,
                                      input_specs)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step, serve_shardings,
                                      train_shardings)
from repro_torch.launch.trace_analysis import (StepCosts, analyze_step,
                                               count_flops)
from repro_torch.models.config import (INPUT_SHAPES, InputShape, ModelConfig,
                                       refuse_mla)
from repro_torch.models.transformer import init_cache, is_vlm, model_view
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel.sharding import ShardingRules, distribute
from repro_torch.tree import leaves, tree_map


def analytic_memory(cfg, shape, *, chips: int, grad_accum: int) -> Dict[str, float]:
    """Model-based per-chip TPU memory estimate (bytes).

    The compile-side memory_analysis() on the CPU backend includes
    bf16->f32 legalization copies that do not exist on the TPU MXU; this
    analytic model is the TPU-side "fits" evidence (cross-checked against
    the measured temp minus the detected legalization buffers).
    """
    n_params = cfg.param_count()
    out: Dict[str, float] = {}
    if shape.kind == "train":
        micro_rows = max(1, shape.global_batch // grad_accum // 16)
        act = micro_rows * shape.seq_len * cfg.d_model * 2
        layers_live = cfg.num_layers          # remat carry, seq/16 sharded
        out["params"] = n_params * 2 / chips
        out["optimizer"] = n_params * 8 / chips
        out["grad_accum_f32"] = n_params * 4 / chips
        out["activations"] = act * layers_live / 16      # seq-parallel
        out["workspace"] = 2e9
    elif shape.kind == "prefill":
        rows = max(1, shape.global_batch // 16)
        out["params"] = n_params * 2 / chips * 16        # TP-sharded only
        cache = (2 * cfg.num_layers * shape.global_batch * shape.seq_len
                 * cfg.kv_dim * 2) if cfg.num_heads else 0
        out["kv_cache"] = cache / chips
        out["activations"] = rows * shape.seq_len * cfg.d_model * 2 * 4 / 16
        out["workspace"] = 1e9
    else:
        clen = decode_cache_len(cfg, shape)
        cache = (2 * cfg.num_layers * shape.global_batch * clen
                 * cfg.kv_dim * 2) if cfg.num_heads else 0
        if cfg.has_ssm:
            di = cfg.d_inner
            cache += (cfg.num_layers * shape.global_batch
                      * (cfg.ssm_heads * (di // max(1, cfg.ssm_heads))
                         * cfg.ssm_state * 4 + (cfg.ssm_conv - 1)
                         * (di + 2 * cfg.ssm_state) * 2))
        out["params"] = n_params * 2 / chips * 16
        out["kv_cache"] = cache / chips                  # donated in place
        out["workspace"] = 1e9
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# Trace one combination
# ---------------------------------------------------------------------------

DEFAULT_GRAD_ACCUM = 8


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    destroyed on exit (it is process-global)."""
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.to_local().element_size()
               for t in leaves(tree) if isinstance(t, torch.Tensor))


def _combine(a: StepCosts, b: StepCosts, wa: float, wb: float,
             peak: bool = True) -> StepCosts:
    """wa x a + wb x b, field by field (the peak too when ``peak``, else
    a's)."""
    out = StepCosts()
    out.dot_flops = wa * a.dot_flops + wb * b.dot_flops
    out.global_flops = wa * a.global_flops + wb * b.global_flops
    out.collective_count = wa * a.collective_count + wb * b.collective_count
    for k in set(a.collective_bytes) | set(b.collective_bytes):
        out.collective_bytes[k] = (wa * a.collective_bytes.get(k, 0.0)
                                   + wb * b.collective_bytes.get(k, 0.0))
    out.temp_peak_bytes = (wa * a.temp_peak_bytes + wb * b.temp_peak_bytes
                           if peak else a.temp_peak_bytes)
    out.comm_counts = {k: wa * a.comm_counts.get(k, 0)
                       + wb * b.comm_counts.get(k, 0)
                       for k in set(a.comm_counts) | set(b.comm_counts)}
    return out


def _depths(cfg: ModelConfig):
    """``(units, layers a unit)``: a VLM's superblocks of
    ``cross_attn_every`` layers, else single layers."""
    k = cfg.cross_attn_every if is_vlm(cfg) else 1
    return cfg.num_layers // k, k


def _trace(cfg, shape, mesh, rules, moe_impl, grad_accum):
    """One eager step of ``cfg`` on ``mesh``: ``(StepCosts, argument bytes
    a device)``; a train step at one microbatch, scaled to
    ``grad_accum``.  Its ``global_flops`` count the same step unsharded
    over fake tensors of the global shapes."""
    params_abs = abstract_params(cfg)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    opt_state = None

    def whole(tree):
        with fake:
            return tree_map(lambda t: torch.zeros(
                t.shape, dtype=t.dtype, device=mesh.device_type), tree)

    if shape.kind == "train":
        opt = AdamW()
        opt_abs = opt.init(params_abs)
        # one microbatch: the batch of grad_accum = 1 at its rows
        batch_abs = input_specs(cfg, dataclasses.replace(
            shape, global_batch=shape.global_batch // grad_accum))
        (pspec, ospec, bspec), _ = train_shardings(
            cfg, params_abs, opt_abs, batch_abs, rules, mesh)
        with fake:
            params = distribute(params_abs, pspec, mesh)
            opt_state = distribute(opt_abs, ospec, mesh)
            batch = distribute(batch_abs, bspec, mesh)
        step = make_train_step(cfg, opt, mesh=mesh, rules=rules,
                               moe_impl=moe_impl)
        _, costs = analyze_step(step, params, opt_state, batch)
        costs.global_flops = count_flops(
            make_train_step(cfg, opt, moe_impl=moe_impl), whole(params_abs),
            whole(opt_abs), whole(batch_abs))
        if grad_accum > 1:
            _, update = analyze_step(opt.update, params, opt_state, params)
            costs = _combine(costs, update, grad_accum, 1 - grad_accum,
                             peak=False)
    elif shape.kind == "prefill":
        batch_abs = input_specs(cfg, shape)
        cache_abs = init_cache(cfg, shape.global_batch, shape.seq_len,
                               device="meta")
        (pspec, bspec), _ = serve_shardings(
            cfg, params_abs, batch_abs, rules, mesh,
            global_batch=shape.global_batch, cache_abstract=cache_abs)
        with fake:
            params = distribute(params_abs, pspec, mesh)
            batch = distribute(batch_abs, bspec, mesh)
        step = make_prefill_step(cfg, shape.seq_len, mesh=mesh, rules=rules,
                                 moe_impl=moe_impl)
        _, costs = analyze_step(step, model_view(cfg, params), batch,
                                inputs=(params, batch))
        costs.global_flops = count_flops(
            make_prefill_step(cfg, shape.seq_len, moe_impl=moe_impl),
            model_view(cfg, whole(params_abs)), whole(batch_abs))
    else:
        batch_abs = input_specs(cfg, shape)
        window = (cfg.sliding_window
                  if decode_cache_len(cfg, shape) != shape.seq_len else None)
        (pspec, bspec), _ = serve_shardings(
            cfg, params_abs, batch_abs, rules, mesh,
            global_batch=shape.global_batch)
        del batch_abs["index"], bspec["index"]
        with fake:
            params = distribute(params_abs, pspec, mesh)
            batch = distribute(batch_abs, bspec, mesh)
        # the newest position of the context: every cache slot live
        batch["index"] = shape.seq_len - 1
        step = make_decode_step(cfg, window=window, mesh=mesh, rules=rules,
                                moe_impl=moe_impl)
        _, costs = analyze_step(step, model_view(cfg, params), batch,
                                inputs=(params, batch))
        plain = dict(whole(batch_abs), index=batch["index"])
        costs.global_flops = count_flops(
            make_decode_step(cfg, window=window, moe_impl=moe_impl),
            model_view(cfg, whole(params_abs)), plain)
    args = [a for a in (params, batch, opt_state) if a is not None]
    return costs, _local_bytes(args)


def run_one(arch: str, shape_name: Union[str, InputShape], *, multi_pod: bool,
            moe_impl: str = "dense", grad_accum: Optional[int] = None,
            infer_params: str = "fsdp",
            rules: Optional[ShardingRules] = None, device: str = "cuda",
            cfg: Optional[ModelConfig] = None,
            verbose: bool = True) -> Dict[str, Any]:
    """One combination's record.  ``shape_name`` names an entry of
    ``INPUT_SHAPES`` or is an ``InputShape``; ``cfg`` traces that config in
    place of ``arch``'s (a reduced one, in the tests); ``device`` is the
    mesh's device type (the fake shards allocate nothing on it)."""
    cfg = cfg or get_config(arch)
    refuse_mla(cfg, "the dry run")
    shape = (shape_name if isinstance(shape_name, InputShape)
             else INPUT_SHAPES[shape_name])
    chips = 512 if multi_pod else 256
    if rules is None:
        # sequence-parallel residual stream for train/prefill (S >= 4096);
        # decode steps have S == 1 (the seq rule no-ops there anyway).
        rules = ShardingRules(seq="model" if shape.kind != "decode" else None)
    if infer_params == "replicated" and shape.kind != "train":
        # weight-stationary inference: params TP-sharded only (no FSDP),
        # eliminating per-layer weight all-gathers at serving time.
        rules = ShardingRules(seq=rules.seq, fsdp=None)
    t0 = time.time()
    if grad_accum is None:
        if shape.kind != "train":
            grad_accum = 1
        else:
            # keep per-device microbatch rows x d_model bounded, but the
            # per-microstep batch must stay divisible by the DP degree
            # (pod x data) or the batch is replicated.
            dp = 32 if multi_pod else 16
            grad_accum = DEFAULT_GRAD_ACCUM
            if cfg.d_model >= 8192 or cfg.is_moe:
                grad_accum = 16
            grad_accum = min(grad_accum, shape.global_batch // dp)

    units, per_unit = _depths(cfg)
    traced = [units] if units <= 2 else [1, 2]
    # a serving step runs under inference mode (prefill, decode_step); its
    # inputs are made there too
    with fake_world(chips), torch.inference_mode(shape.kind != "train"):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
        runs = [_trace(dataclasses.replace(cfg, num_layers=n * per_unit),
                       shape, mesh, rules, moe_impl, grad_accum)
                for n in traced]
    if len(runs) == 1:
        costs, arg_bytes = runs[0]
    else:
        # every unit does the same work: f(units) = f(1) + (units - 1) x
        # (f(2) - f(1)), as the HLO analysis multiplies a scan body by its
        # trip count.  The step's own peak grows by what the second unit
        # adds (training's saved activations) or not at all (serving):
        # the first trace of a process allocates more once
        (c1, a1), (c2, a2) = runs
        costs = _combine(c1, c2, 2 - units, units - 1)
        costs.temp_peak_bytes = c2.temp_peak_bytes + (units - 2) * max(
            0, c2.temp_peak_bytes - c1.temp_peak_bytes)
        arg_bytes = int((2 - units) * a1 + (units - 1) * a2)
    elapsed = time.time() - t0

    analytic = analytic_memory(cfg, shape, chips=chips, grad_accum=grad_accum)
    result = {
        "arch": arch,
        "shape": shape.name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "moe_impl": moe_impl,
        "grad_accum": grad_accum,
        "grad_accum_traced": 1,
        "layers": cfg.num_layers,
        "layers_traced": [n * per_unit for n in traced],
        "infer_params": infer_params,
        "device": device,
        "trace_s": round(elapsed, 1),
        "dot_flops": costs.dot_flops,                # per device
        "global_flops": costs.global_flops,
        # how many devices repeat each product (1: none)
        "x_ideal": costs.dot_flops * chips / max(costs.global_flops, 1.0),
        "collective_bytes": costs.total_collective_bytes,
        "collective_detail": dict(costs.collective_bytes),
        "collective_count": costs.collective_count,
        "collective_ops": costs.comm_counts,
        "memory": {
            "argument_size": arg_bytes,
            "temp_size": costs.temp_peak_bytes,
            "peak": arg_bytes + costs.temp_peak_bytes,
        },
        "analytic_memory": analytic,
        "fits": analytic["total"] <= HBM_BYTES,
    }
    if verbose:
        print(f"[{arch} x {shape.name} x {result['mesh']}] "
              f"trace={elapsed:.1f}s dot_flops={result['dot_flops']:.3e} "
              f"coll={result['collective_bytes']:.3e} "
              f"args/device={arg_bytes / 1e9:.2f}GB "
              f"temp/device={costs.temp_peak_bytes / 1e9:.2f}GB "
              f"(analytic {analytic['total'] / 1e9:.2f}GB of "
              f"{HBM_BYTES / 1e9:.0f}GB: "
              f"{'fits' if result['fits'] else 'does not fit'})")
        print(f"  collectives: {result['collective_detail']}; x ideal "
              f"{result['x_ideal']:.3f}")
    return result


def _in_children(combos, args, argv):
    """Each combination in a child ``dryrun`` process of its own (its fake
    group with it), ``args.jobs`` at a time; their records and failures."""
    passed = [a for a in argv if a not in ("--all", "--both-meshes",
                                           "--multi-pod")]
    for flag in ("--arch", "--shape", "--out", "--jobs"):
        if flag in passed:
            i = passed.index(flag)
            del passed[i:i + 2]

    def one(combo):
        arch, shape, mp = combo
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "r.json")
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, *(["--multi-pod"] if mp else []),
                 *passed, "--out", out], capture_output=True, text=True)
            print(proc.stdout, end="", flush=True)
            if proc.returncode != 0:
                print(proc.stderr[-3000:], file=sys.stderr)
                return None, (arch, shape, mp, proc.stderr[-300:])
            return json.load(open(out))[-1], None

    with ThreadPoolExecutor(args.jobs) as pool:
        done = list(pool.map(one, combos))
    return ([r for r, _ in done if r is not None],
            [f for _, f in done if f is not None])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 multi-pod mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--moe-impl", default="dense",
                    choices=("dense", "ragged", "capacity"))
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--infer-params", default="fsdp",
                    choices=("fsdp", "replicated"))
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (cuda or cpu); nothing is "
                         "allocated on it")
    ap.add_argument("--out", default="experiments/dryrun_torch.json")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace this many combinations at once, each in a "
                         "process of its own (a trace is single-threaded)")
    args = ap.parse_args(argv)

    assigned = [a for a in ARCH_IDS if not a.startswith("gwtf_")]
    archs = [args.arch] if args.arch else assigned
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    combos = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    t0 = time.time()
    if args.jobs > 1:
        results, failures = _in_children(combos, args, argv or sys.argv[1:])
    else:
        results, failures = [], []
        for arch, shape, mp in combos:
            try:
                results.append(run_one(arch, shape, multi_pod=mp,
                                       moe_impl=args.moe_impl,
                                       grad_accum=args.grad_accum,
                                       infer_params=args.infer_params,
                                       device=args.device))
            except Exception as e:  # noqa: BLE001 — report, keep going
                traceback.print_exc()
                failures.append((arch, shape, mp, repr(e)))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    existing = []
    if os.path.exists(args.out):
        try:
            existing = json.load(open(args.out))
        except Exception:
            existing = []
    keyset = {(r["arch"], r["shape"], r["mesh"], r["moe_impl"],
               r.get("infer_params", "fsdp"))
              for r in results}
    existing = [r for r in existing
                if (r["arch"], r["shape"], r["mesh"],
                    r.get("moe_impl", "dense"), r.get("infer_params", "fsdp"))
                not in keyset]
    json.dump(existing + results, open(args.out, "w"), indent=1)
    print(f"\n{len(results)} OK, {len(failures)} failed -> {args.out} "
          f"({time.time() - t0:.1f} s)")
    for f in failures:
        print("FAIL:", f)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
