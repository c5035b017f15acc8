"""One run of one cell: find the cell's files by name, drive it, read its
metrics, decide ``correct``, and assemble the result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration, ``configs/<config>.json``, and its traffic and limits,
``workloads/<cell>.json``, whose ``driver`` names ``drivers/<driver>.py``.
Each metric of ``BENCHMARK.json`` is read by ``metrics/<metric>.py``'s
``read(run, cell)``, which returns a number or None where it finds nothing
to read.  A driver's ``run(cell, run)`` sets up the program, measures the
window and returns its state; its ``check(cell, run, state)`` frees the
program, runs the plain reference and returns ``{name: (value, limit)}``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    chips: int
    files: Path           # where configs/, workloads/, drivers/, metrics/ are
    config: dict          # configs/<config>.json
    workload: dict        # workloads/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclass
class Run:
    """What a run measured, for the metric readers."""
    device: str                     # "cuda" or "cpu"
    seed: int
    seconds: float
    trace: bool
    t0: float                       # host clock at the process's start
    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    peak_bytes: Optional[int] = None
    attempted: int = 0
    failed: int = 0
    records: List[dict] = field(default_factory=list)   # per iteration or request
    spans: Dict[str, List[float]] = field(default_factory=dict)
    profile: Optional[dict] = None
    extra: dict = field(default_factory=dict)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None, overrides: Optional[dict] = None,
              files: Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``), with its
    files under ``files``; ``overrides`` ({"config": {...}, "workload":
    {...}}) replace keys of either, for tests at a reduced size."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = load_json(files / "configs" / f"{entry['config']}.json")
    workload = load_json(files / "workloads" / f"{name}.json")
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    workload.update(overrides.get("workload", {}))
    return Cell(name, entry["chips"], files, config, workload,
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)])


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    return load_file(cell.files / "drivers" / f"{cell.workload['driver']}.py",
                     f"perfbench_driver_{cell.workload['driver']}")


def reader(cell: Cell, metric: str) -> Callable:
    return load_file(cell.files / "metrics" / f"{metric}.py", f"perfbench_metric_{metric}").read


def read_metrics(cell: Cell, run: Run) -> Dict[str, dict]:
    """The cell's end-to-end metrics (``--trace 0``) or per-layer ones
    (``--trace 1``) that the run has something for.  Off the card only
    the program's counters are read: a CPU run writes no device metric."""
    out = {}
    for m in (cell.per_layer if run.trace else cell.end_to_end):
        if run.device != "cuda" and m["source"] != "program_counter":
            continue
        value = reader(cell, m["name"])(run, cell)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` states it (a share of a
    published peak assumes the full 700 W); copied from
    ``repro_torch/kernels/timing.py::card_line``."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True,
                              timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def device_info(run: Run, chips: int) -> dict:
    import torch
    if run.device == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": run.peak_bytes,
                "power_limit": power_limit()}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": None}
    if run.trace and run.profile is not None:
        info["busy_s"] = run.profile["busy_s"]
        info["window_s"] = run.profile["wall_s"]
    return info


def execute(cell: Cell, run: Run, log=print) -> dict:
    """Drive the cell once and return its result line (a dict)."""
    drv = driver(cell)
    state = drv.run(cell, run)
    metrics = read_metrics(cell, run)
    device = device_info(run, cell.chips)
    checks = drv.check(cell, run, state)
    correct = run.failed == 0 and all(
        math.isfinite(v) and v <= limit for v, limit in checks.values())
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    if run.trace and run.profile is not None:
        line["breakdown"] = {"device_ops": run.profile["device_ops"],
                             "idle_gaps": run.profile["idle_gaps"]}
    if "compared_replays" in run.extra:
        line["compared_replays"] = run.extra["compared_replays"]
    line["checks"] = {k: {"value": v, "limit": limit} for k, (v, limit) in checks.items()}
    return line


def emit(line: dict) -> None:
    """Each check beside its limit as the last lines of standard error, and
    the result as the last line of standard output."""
    if "compared_replays" in line:
        print(f"replays in the compared iterations: {line['compared_replays']}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def release() -> None:
    """Return what the program's freed state held to the device, so that the
    reference runs in the room it left."""
    import gc
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def model_config(raw: dict):
    """The program's ``ModelConfig`` from a configuration file's keys."""
    from repro_torch.models.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in raw.items() if k in names})
