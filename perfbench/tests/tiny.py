"""Reduced sizes at which every cell runs on the CPU in a test."""
import json
import time

from perfbench import harness

CONFIG = {"num_layers": 4, "d_model": 64, "num_heads": 4, "head_dim": 16, "d_ff": 128,
          "vocab_size": 256, "param_dtype": "float32"}
TRAIN = {"seq_len": 16, "batch": 2, "trace_iterations": 300}
SERVE = {"batch": 2, "prompt_len": 16, "gen": 4, "keep_rows": 2, "sample_rows": 3}


def cells():
    return [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


def overrides(cell: str, bench=None, files=harness.HERE) -> dict:
    c = harness.load_cell(cell, bench=bench, files=files)
    mha = c.config["num_kv_heads"] == c.config["num_heads"]
    config = dict(CONFIG, num_kv_heads=4 if mha else 2)
    return {"config": config, "workload": TRAIN if c.workload["driver"] == "train" else SERVE}


def load(cell: str, bench=None, files=harness.HERE, **workload):
    o = overrides(cell, bench, files)
    o["workload"] = dict(o["workload"], **workload)
    return harness.load_cell(cell, bench=bench, overrides=o, files=files)


def execute(cell, seed=2**31 + 29, trace=False, seconds=0.3):
    run = harness.Run(device="cpu", seed=seed, seconds=seconds, trace=trace,
                      t0=time.perf_counter())
    return harness.execute(cell, run), run


def last_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])
