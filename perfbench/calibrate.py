"""Readings that the limits of ``correct`` are set from, on the card, in
one process over many seeds.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 0]

For each seed: the cell's set-up (and, for serving, a window of
``--seconds``, at least one request), then the driver's ``controls``: the
program's reading against the plain reference, the control's (the
reference computed in float8 in the program's place) and, for training,
the fault of half of each iteration's microbatches left out.  One JSON line
a seed.  The benchmark's own runs do not run this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    drv = harness.driver(cell)
    import torch
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(device="cuda", seed=seed, seconds=args.seconds, trace=False,
                          t0=time.perf_counter())
        state = drv.run(cell, run)
        readings = drv.controls(cell, run, state)
        completed = [len(d) for d in getattr(state, "done", [])]
        print(json.dumps({"workload": cell.name, "seed": seed, "readings": readings,
                          "completed": completed,
                          "compared_replays": run.extra.get("compared_replays"),
                          "setup_s": run.setup_s, "peak_gib": (run.peak_bytes or 0) / 2**30}),
              flush=True)
        del state
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
