#!/usr/bin/env python3
"""How far the expert choices that differ between the program and the
plain reference move the Moonlight cell's gaps.

    python3 tools/moe_choice_flips.py --seeds <n>[,<n>...] [--workload moonlight-5l-train-calm]

from the root of a checkout, on a machine with a CUDA card (``--device
cpu`` at a reduced size, in the tests).  For each seed it runs the cell's
driver as the benchmark does (set-up, the warm-up iterations that the
check compares, one iteration of window) and records, at every MoE layer
of the warm-up, the experts the program chose for each token.  Then it
follows those iterations with the plain reference twice: as the check
does, the reference choosing by its own top k; and replaying the
program's choices (``reference/mla_moe.py``'s ``choose``), so that a token
whose near tie the two sides order differently takes the same experts on
both.  One JSON line a seed: the gaps of each follow against the program
(``train.gaps``), the gaps of the replaying follow against the other (the
flips alone), and, for each MoE layer of the replaying follow, the share
of tokens whose own top k differs from the program's and the median gap
between a token's k-th and (k+1)-th biased score.

The program's choices line up with the reference's calls in order: one
data node, whose microbatches the stages run in the order the routing
completed them, as the reference follows them.
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

import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.drivers import train  # noqa: E402
from perfbench.reference import gwtf, mla_moe  # noqa: E402


def _moe_keys(cfg: dict, stages: int):
    """(stage, position in the stage) of each MoE layer, in the model's order."""
    return [(s, pos) for s, layers in enumerate(gwtf.stage_layers(cfg["num_layers"], stages))
            for pos, layer in enumerate(layers) if layer >= cfg["first_dense_layers"]]


def readings(cell, seed: int, device: str) -> dict:
    from repro_torch import spans
    from repro_torch.models import moe as MOE
    drv = harness.driver(cell)
    chosen = {}
    record = MOE._record_load

    def recording(layer, topi, E):
        stage = spans.ids().get("stage")
        if layer is not None and stage is not None:
            chosen.setdefault((stage, layer), []).append(topi.detach().cpu())
        record(layer, topi, E)
    run = harness.Run(device=device, seed=seed, seconds=0.0, trace=False,
                      t0=time.perf_counter())
    MOE._record_load = recording
    spans.enable()
    try:
        state = drv.run(cell, run)
    finally:
        MOE._record_load = record
        spans.disable()
        spans.drain()
    assert len(state.data_nodes) == 1, "the choices line up for one data node"
    cfg, k = cell.config, cell.config["num_experts_per_tok"]
    keys = _moe_keys(cfg, state.stages)
    rows = {key: torch.cat(chosen[key]) for key in keys}
    train.free(state)
    ref = drv.follow(cell, state, seed, device)

    calls, cursor = [0], {key: 0 for key in keys}
    differ = {key: 0 for key in keys}
    kth_gaps = {key: [] for key in keys}

    def replay(biased):
        key = keys[calls[0] % len(keys)]
        calls[0] += 1
        n = biased.shape[0]
        got = rows[key][cursor[key]:cursor[key] + n].to(biased.device)
        cursor[key] += n
        top = torch.topk(biased, k + 1, dim=-1)
        own = top.indices[:, :k].sort(-1).values
        differ[key] += int((own != got.sort(-1).values).any(-1).sum())
        kth_gaps[key].append((top.values[:, k - 1] - top.values[:, k]).detach().cpu())
        return got
    mla_moe.choose = replay
    try:
        replayed = drv.follow(cell, state, seed, device)
    finally:
        mla_moe.choose = None
    tokens = sum(len(done) for done in state.done) * cell.workload["batch"] \
        * cell.workload["seq_len"]
    assert all(cursor[key] == tokens for key in keys), (cursor, tokens)
    prog = (state.losses, state.first, state.change)
    return {"workload": cell.name, "seed": seed, "tokens": tokens,
            "gaps": train.gaps(prog, ref),
            "gaps_replaying_choices": train.gaps(prog, replayed),
            "flips_alone": train.gaps(replayed, ref),
            "layers": [{"stage": s, "position": pos,
                        "differ_share": differ[(s, pos)] / tokens,
                        "median_kth_gap": float(torch.cat(kth_gaps[(s, pos)]).median())}
                       for s, pos in keys],
            "differ_share_mean": statistics.mean(differ[key] / tokens for key in keys)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="moonlight-5l-train-calm")
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.device)), flush=True)
        if args.device == "cuda":
            harness.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
