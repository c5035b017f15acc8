"""Every cell runs end to end at a reduced size on the CPU; a cell, a
configuration and a metric are found by name; without a card the
benchmark prints nothing."""
import json
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from perfbench import harness  # noqa: E402
from perfbench.tests import tiny  # noqa: E402


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", tiny.cells())
def test_cell_runs_end_to_end_on_cpu(cell, trace, capsys):
    line, run = tiny.execute(tiny.load(cell), trace=trace)
    harness.emit(line)
    out = tiny.last_line(capsys.readouterr().out)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert out["device"]["platform"] == "cpu" and out["device"]["memory_peak_bytes"] is None
    # a CPU run writes no device metric: only the program's counters
    sources = {m["name"]: m["source"] for m in harness.load_json(
        harness.ROOT / "BENCHMARK.json")["per_layer"] + harness.load_json(
        harness.ROOT / "BENCHMARK.json")["end_to_end"]}
    assert all(sources[m] == "program_counter" for m in out["metrics"])
    assert "busy_s" not in out["device"] and "breakdown" not in out
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    for sub in ("configs", "workloads", "drivers", "metrics"):
        shutil.copytree(harness.HERE / sub, tmp_path / sub)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    config = harness.load_json(tmp_path / "configs" / "gwtf-gpt-300m.json")
    (tmp_path / "configs" / "new-model.json").write_text(json.dumps(dict(config, d_ff=8192)))
    workload = harness.load_json(tmp_path / "workloads" / "gpt300m-train-calm.json")
    (tmp_path / "workloads" / "new-cell.json").write_text(
        json.dumps(dict(workload, microbatches=2)))
    (tmp_path / "metrics" / "completed_per_iter.train.py").write_text(
        "def read(run, cell):\n"
        "    return sum(r['completed'] for r in run.records) / len(run.records)\n")
    bench["configs"].append({"name": "new-model", "source": "https://example.org",
                             "file": "perfbench/configs/new-model.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "new-cell", "config": "new-model", "traffic": "t",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "completed_per_iter.train", "unit": "count",
                               "better": "higher", "source": "program_counter", "layer": "x",
                               "moves": "train_tokens_per_s", "workloads": ["new-cell"]})
    cell = tiny.load("new-cell", bench=bench, files=tmp_path)
    assert cell.workload["microbatches"] == 2
    line, _ = tiny.execute(cell, trace=True)
    assert line["correct"]
    assert line["metrics"]["completed_per_iter.train"]["value"] == 2 * cell.workload["data_nodes"]


def test_without_a_card_the_benchmark_exits_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the benchmark would run")
    args = ["--workload", "gpt300m-train-churn10", "--seed", "1", "--seconds", "1", "--trace", "0"]
    proc = subprocess.run([sys.executable, str(harness.HERE / "run.py"), *args],
                          capture_output=True, text=True, timeout=120, cwd=harness.ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


@pytest.mark.card
def test_the_serve_cell_on_the_card_at_a_reduced_size(card, capsys):
    cell = tiny.load("sc2-7b-8l-serve-decode")
    run = harness.Run(device="cuda", seed=5, seconds=0.5, trace=True, t0=0.0)
    line = harness.execute(cell, run)
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert "flash_roofline.serve" in line["metrics"]
