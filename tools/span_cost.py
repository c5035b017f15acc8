#!/usr/bin/env python3
"""What the program's spans cost when on, within one process.

    python3 tools/span_cost.py --workload <cell> --seed <n> [--blocks 8] [--per-block 3]

from the root of a checkout, on a machine with a CUDA card.  It sets a
benchmark cell up as its driver does (``perfbench/drivers/<driver>.py``:
the trainer with the benchmark's weights and its warm-up iterations, or
the served model and one request), then runs blocks of ``--per-block``
training iterations or requests, with tracing (``repro_torch.spans``)
off and on in turn: off, on, on, off, ...  Each iteration's or request's
seconds are the program's own (``train_iteration``'s, synchronized, or
``generate``'s wall).  The last line of standard output is one JSON
object: each block's mean seconds, the median of each side, their ratio,
and the spans an iteration or request records.  Alternating within one
process keeps the host's drift, which moves separate runs by percents,
out of the comparison.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--per-block", type=int, default=3)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import spans
    drv = harness.driver(cell)
    run = harness.Run(device="cuda", seed=args.seed, seconds=0.0, trace=False,
                      t0=time.perf_counter())
    if cell.workload["driver"] == "train":
        from repro_torch.launch import train as T
        trainer, feed = drv.build(cell, run)
        it = len(drv.warm_up(cell, run, trainer, feed).done)

        def one() -> float:
            nonlocal it
            secs = T.train_iteration(trainer, feed(it))[1]
            it += 1
            return secs
    else:
        from repro_torch.launch.serve import generate
        cfg = harness.model_config(cell.config)
        model = drv.build_model(cfg, args.seed, torch.device("cuda"))
        w, request = cell.workload, 0

        def one() -> float:
            nonlocal request
            prompt = drv.prompts(args.seed, request, w, cfg.vocab_size, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate(model, cfg, prompt, gen=w["gen"], window=None, temperature=0.0,
                     generator=None)
            torch.cuda.synchronize()
            request += 1
            return time.perf_counter() - t0
        one()
    blocks, recorded = [], []
    for b in range(args.blocks):
        on = b % 4 in (1, 2)
        if on:
            spans.enable()
        secs = [one() for _ in range(args.per_block)]
        spans.disable()
        if on:
            recorded.append(len(spans.drain()) / args.per_block)
        blocks.append({"on": on, "mean_s": sum(secs) / len(secs)})
        print(f"block {b}: tracing {'on ' if on else 'off'} {blocks[-1]['mean_s']:.6f} s",
              file=sys.stderr)
    off = statistics.median(b["mean_s"] for b in blocks if not b["on"])
    on = statistics.median(b["mean_s"] for b in blocks if b["on"])
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "card": torch.cuda.get_device_name(0), "power_limit": harness.power_limit(),
                      "blocks": blocks, "off_s": off, "on_s": on, "on_over_off": on / off,
                      "spans_each": statistics.mean(recorded)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
