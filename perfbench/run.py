"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number that
decided ``correct`` beside its limit); the checks are also the last lines
of standard error.  Without the card, or with the JAX package loaded, it
exits with code 1 and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's caches at fixed paths inside the checkout (the port's
# kernels build into build/<hash>/ there already)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ.setdefault(var, str(ROOT / "build" / "perfbench" / sub))
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    run = harness.Run(device="cuda", seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), t0=T0)
    line = harness.execute(cell, run)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of the JAX side loaded: {', '.join(found)}", file=sys.stderr)
        return 1
    harness.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
