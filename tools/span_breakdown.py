#!/usr/bin/env python3
"""Where a benchmark cell's device time and idle go, by the program's spans.

    python3 tools/span_breakdown.py --workload <cell> --seed <n> --seconds <s> \
        [--spans 0|1] [--trace 0|1] [--out <file.json>]

from the root of a checkout, on a machine with a CUDA card.  It runs the
cell once through the benchmark's own harness (``perfbench/harness.py``,
the cell's driver, its checks), as ``perfbench/run.py`` does, with the
program's spans (``repro_torch.spans``) enabled from before set-up when
``--spans 1``.  With ``--trace 1`` the cell driver's profile after the window
is also charged to the spans (``perfbench/by_span.py``), the device's
copies of the program's ranges left out of its work, and standard error
gets the device time, launches and idle of the top span paths.

Standard output's last line is one JSON object: the run's ``correct``,
``failed``, its metrics as the harness reads them, and ``readings``, each
computed from the spans and the counter:

* ``route_ms``: host ms an iteration in the ``plan`` and ``resolve`` spans,
  over the window's iterations;
* ``host_syncs_per_iter``: ``IterationResult.host_syncs`` over them;
* ``init_params_s``: host s in ``init.params`` during set-up;
* ``update_device_ms``, ``attention_core_fwd_ms``, ``replay_device_ms``:
  device ms a profiled iteration launched under ``update``, under
  ``attention.core`` in a ``stage.fwd`` or a ``replay``, under ``replay``;
* ``decode_attention_core_ms``: device ms a decode step of the profiled
  request launched under ``attention.core`` in ``decode.step``;
* ``outside_share``: the share of the profile's busy time charged to no
  span, %;
* ``idle_vs_window``: 1 - a profiled iteration's busy time over the mean
  time of the window's (unprofiled) iterations, %: the device's idle
  without the profiler's cost to the host, which ``idle_share.train``
  includes.

``--spans 1 --trace 0`` against ``--spans 0 --trace 0`` on one seed is
what tracing costs when on.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import by_span, harness, profiling  # noqa: E402


def by_kernel(events, n: int = 12) -> list:
    """The device time of the top (kernel, operator, span) triples: each
    device operation with the outermost and innermost operators around its
    runtime call, and the innermost span it is charged to (``by_span``)."""
    from torch.autograd import DeviceType
    host = [e for e in events if e.device_type == DeviceType.CPU]
    calls = {e.id: e for e in host if e.name.startswith("cu") and "::" not in e.name}
    left_out = tuple(profiling.ANNOTATIONS) + (by_span.PROGRAM,)
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith(left_out)]
    spans = [e for e in host if e.name.startswith(by_span.PROGRAM)]
    paths = by_span._paths(spans, by_span.PROGRAM)
    charged = by_span._innermost(spans, [p.count("/") for p in paths],
                                 by_span._launch_times(dev, host)[0])
    totals = {}
    for e, i in zip(dev, charged):
        ops, p = [], getattr(calls.get(e.id), "cpu_parent", None)
        while p is not None and not p.name.startswith(by_span.PROGRAM):
            ops.append(p.name)
            p = p.cpu_parent
        key = (e.name[:64], ops[-1] if ops else "-", ops[0] if ops else "-",
               by_span.OUTSIDE if i is None else paths[i].rsplit("/", 1)[-1])
        totals[key] = totals.get(key, 0.0) + (e.time_range.end - e.time_range.start) * 1e-6
    return [[*k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def _with_spans(summarize):
    def summary(events, wall_s):
        out = summarize(events, wall_s)
        out.update(by_span.charge(events))
        out["by_kernel"] = by_kernel(events)
        return out
    return summary


def readings(cell, run, syncs, records) -> dict:
    """The numbers of the module's docstring that the run has data for."""
    out = {}
    t_start = run.t0 + run.setup_s
    t_end = t_start + run.window_s

    def host_s(name, lo, hi):
        return sum((r.end_ns - r.start_ns) * 1e-9 for r in records
                   if r.name == name and r.end_ns is not None
                   and lo <= r.start_ns * 1e-9 < hi)
    if cell.workload["driver"] == "train":
        window = [n for t, n in syncs if t_start < t <= t_end]
        if window:
            out["host_syncs_per_iter"] = sum(window) / len(window)
        if records and run.records:
            out["route_ms"] = (host_s("plan", t_start, t_end) + host_s(
                "resolve", t_start, t_end)) / len(run.records) * 1e3
            out["init_params_s"] = host_s("init.params", float("-inf"), t_start)
    prof = run.profile
    if prof is not None and "span_device_s" in prof:
        dev = prof["span_device_s"]
        out["outside_share"] = 100.0 * dev.get(by_span.OUTSIDE, 0.0) / prof["busy_s"]
        if cell.workload["driver"] == "train":
            k = run.extra["profile_iterations"]
            secs = [r["seconds"] for r in run.records]
            out["idle_vs_window"] = 100.0 * (1 - prof["busy_s"] / k / (sum(secs) / len(secs)))
            out["update_device_ms"] = by_span.total(dev, ["update"]) / k * 1e3
            out["attention_core_fwd_ms"] = by_span.total(
                dev, ["stage.fwd", "replay"], "attention.core") / k * 1e3
            out["replay_device_ms"] = by_span.total(dev, ["replay"]) / k * 1e3
        else:
            out["decode_attention_core_ms"] = by_span.total(
                dev, ["decode.step"], "attention.core") / cell.workload["gen"] * 1e3
    return out


def table(prof: dict, n: int = 25) -> str:
    dev, count, idle = prof["span_device_s"], prof["span_launches"], prof["span_idle_s"]
    keys = sorted(set(dev) | set(idle), key=lambda k: -(dev.get(k, 0) + idle.get(k, 0)))
    lines = [f"busy {prof['busy_s']:.6f} s of {prof['wall_s']:.6f} s; "
             f"{prof['launches']} device operations, "
             f"{prof['unmatched_launches']} charged without their runtime call",
             f"{'device s':>12} {'launches':>9} {'idle s':>10}  span path"]
    lines += [f"{dev.get(k, 0):12.6f} {count.get(k, 0):9d} {idle.get(k, 0):10.6f}  {k}"
              for k in keys[:n]]
    named = by_span.by_name(dev)
    lines.append("by innermost span: " + ", ".join(
        f"{k} {v:.6f}" for k, v in sorted(named.items(), key=lambda kv: -kv[1])))
    lines.append("top kernels: device s, kernel <- outermost / innermost operator, span")
    lines += [f"{v:12.6f}  {k} <- {o} / {i}, {sp}" for k, o, i, sp, v in prof["by_kernel"]]
    return "\n".join(lines)


def traced(cell, run, on: bool = True):
    """``harness.execute(cell, run)`` with the program's spans enabled from
    before set-up (when ``on``), each host-sync count kept, and the profile
    charged to the spans; returns (result line, profile, readings)."""
    from repro_torch import spans
    from repro_torch.launch import train as T
    train_iteration, summarize = T.train_iteration, profiling.summarize
    annotations = profiling.ANNOTATIONS
    syncs = []

    def counted(trainer, shards):
        out = train_iteration(trainer, shards)
        syncs.append((time.perf_counter(), out[0].host_syncs))
        return out
    T.train_iteration = counted
    profiling.summarize = _with_spans(summarize)
    profiling.ANNOTATIONS = tuple(annotations) + (by_span.PROGRAM,)
    if on:
        spans.enable()
    try:
        line = harness.execute(cell, run)
    finally:
        spans.disable()
        T.train_iteration, profiling.summarize = train_iteration, summarize
        profiling.ANNOTATIONS = annotations
    return line, run.profile, readings(cell, run, syncs, spans.drain())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA card", file=sys.stderr)
        return 1
    run = harness.Run(device="cuda", seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), t0=T0)
    line, prof, got = traced(cell, run, bool(args.spans))
    if prof is not None and "span_device_s" in prof:
        print(table(prof), file=sys.stderr)
    pre = run.extra.get("prefill_profile")
    if pre is not None and "span_device_s" in pre:
        print("prefill alone:\n" + table(pre, 8), file=sys.stderr)
    result = {"workload": args.workload, "seed": args.seed, "spans": args.spans,
              "trace": args.trace, "correct": line["correct"], "failed": line["failed"],
              "metrics": {k: v["value"] for k, v in line["metrics"].items()},
              "setup_s": run.setup_s, "window_s": run.window_s,
              "card": line["device"]["kind"], "power_limit": line["device"]["power_limit"],
              "readings": got}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(result, profile=prof, prefill_profile=pre,
                                                  checks=line["checks"])))
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
