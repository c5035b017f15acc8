"""The device's work and idle charged to the program's spans
(``perfbench/by_span.py``), on synthetic profiler events; the training
cells' host-sync counter and span readings through the harness on the CPU
(``tools/span_breakdown.py``); and, on the card, a reduced training cell
traced with nearly all of its device time inside the program's spans."""
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402

from perfbench import by_span, harness, profiling  # noqa: E402
from perfbench.tests import tiny  # noqa: E402

TOOL = harness.ROOT / "tools" / "span_breakdown.py"
TRAIN = ["gpt300m-train-churn10", "sc2-7b-8l-train-calm", "gpt300m-train-calm"]


def _ev(name, start, end, device=DeviceType.CPU, thread=1, id=0, linked=0):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=device, thread=thread, id=id,
                           linked_correlation_id=linked)


def _gpu(name, start, end, id):
    return _ev(name, start, end, DeviceType.CUDA, thread=0, id=id)


P = by_span.PROGRAM
EVENTS = [
    # the program's spans on the caller's thread
    _ev(P + "iteration", 0, 100), _ev(P + "execute", 10, 90),
    _ev(P + "stage.fwd", 20, 40), _ev(P + "attention.core", 22, 30),
    _ev(P + "stage.bwd", 50, 80),
    # an operator and the runtime calls that launch device work
    # (an operator's id may equal a device operation's correlation id)
    _ev("aten::mm", 23, 27, id=5), _ev("cudaLaunchKernel", 24, 25, id=5, linked=11),
    _ev("cudaMemcpyAsync", 5, 6, id=3, linked=9),
    _ev("cudaLaunchKernel", 33, 34, id=6, linked=12),
    # a backward kernel launched from autograd's device thread
    _ev("cudaLaunchKernel", 60, 61, thread=2, id=7, linked=13),
    _ev("cudaLaunchKernel", 95, 96, id=8, linked=14),
    _ev("cudaLaunchKernel", 105, 106, id=10, linked=15),
    # device work, and the device's copies of the ranges (not work)
    _gpu("Memcpy HtoD", 6, 8, 3), _gpu("gemm", 30, 38, 5), _gpu("relu", 38, 42, 6),
    _gpu("gemm_bwd", 70, 75, 7), _gpu("add", 96, 97, 8), _gpu("copy", 106, 110, 10),
    _gpu(P + "stage.fwd", 30, 42, 0), _gpu("perfbench/_apply_update", 96, 97, 0),
]


def test_device_work_and_idle_go_to_the_innermost_open_span():
    got = by_span.charge(EVENTS)
    dev = {k: round(v * 1e6, 6) for k, v in got["span_device_s"].items()}
    assert dev == {"iteration": 2 + 1, "iteration/execute/stage.fwd/attention.core": 8,
                   "iteration/execute/stage.fwd": 4, "iteration/execute/stage.bwd": 5,
                   "outside": 4}
    assert got["span_launches"] == {"iteration": 2, "iteration/execute/stage.fwd": 1,
                                    "iteration/execute/stage.fwd/attention.core": 1,
                                    "iteration/execute/stage.bwd": 1, "outside": 1}
    # gaps: 0-6 (mid 3), 8-30 (19), 42-70 (56), 75-96 (85.5), 97-106 (101.5)
    idle = {k: round(v * 1e6, 6) for k, v in got["span_idle_s"].items()}
    assert idle == {"iteration": 6, "iteration/execute": 22 + 21,
                    "iteration/execute/stage.bwd": 28, "outside": 9}
    assert got["unmatched_launches"] == 0
    # without its runtime call an operation is charged at its own start
    lost = by_span.charge([e for e in EVENTS if e.id != 6 or e.device_type == DeviceType.CUDA])
    assert lost["unmatched_launches"] == 1
    assert lost["span_device_s"]["iteration/execute/stage.fwd"] == pytest.approx(4e-6)
    # the device's copies of the ranges are left out: busy is the union of the rest
    busy = sum(b - a for a, b in profiling._intervals(
        [e for e in EVENTS if e.device_type == DeviceType.CUDA
         and not e.name.startswith((P, "perfbench/"))])) * 1e-6
    assert sum(got["span_device_s"].values()) == pytest.approx(busy)
    assert by_span.total(got["span_device_s"], ["stage.fwd"], "attention.core") \
        == pytest.approx(8e-6)
    assert by_span.total(got["span_device_s"], ["execute"]) == pytest.approx(17e-6)
    assert by_span.by_name(got["span_device_s"])["stage.fwd"] == pytest.approx(4e-6)


def test_spans_nest_per_thread_and_same_start_goes_to_the_deeper():
    events = [_ev(P + "a", 0, 10), _ev(P + "b", 0, 10), _ev(P + "c", 2, 5, thread=2),
              _ev("cudaLaunchKernel", 1, 2, id=1, linked=1),
              _ev("cudaLaunchKernel", 3, 4, thread=2, id=2, linked=2),
              _gpu("k1", 4, 6, 1), _gpu("k2", 6, 7, 2)]
    got = by_span.charge(events)["span_device_s"]
    assert set(got) == {"a/b", "c"}


def test_the_prefix_is_the_programs():
    from repro_torch import spans
    assert by_span.PROGRAM == spans.PREFIX


@pytest.mark.parametrize("cell", TRAIN)
def test_host_syncs_and_route_read_through_the_harness_on_cpu(cell):
    tool = harness.load_file(TOOL, "span_breakdown")
    c = tiny.load(cell)
    run = harness.Run(device="cpu", seed=2**31 + 41, seconds=0.3, trace=True,
                      t0=time.perf_counter())
    line, prof, got = tool.traced(c, run)
    assert line["correct"] and prof is None
    # the reduced width stacks the cell's microbatches in one chunk a data node
    assert got["host_syncs_per_iter"] == 3 * c.workload["data_nodes"]
    assert got["route_ms"] > 0 and got["init_params_s"] > 0
    assert "plan_ms.train" not in line["metrics"]       # no device metric off the card


@pytest.mark.card
def test_a_traced_training_cell_keeps_its_device_time_inside_the_spans(card):
    tool = harness.load_file(TOOL, "span_breakdown")
    cell = tiny.load("gpt300m-train-churn10")
    run = harness.Run(device="cuda", seed=2**31 + 43, seconds=1.0, trace=True,
                      t0=time.perf_counter())
    line, prof, got = tool.traced(cell, run)
    assert line["correct"]
    assert sum(prof["span_device_s"].values()) <= prof["busy_s"] * (1 + 1e-9)
    assert prof["span_device_s"].get(by_span.OUTSIDE, 0.0) < 0.1 * prof["busy_s"]
    assert got["update_device_ms"] > 0 and got["attention_core_fwd_ms"] > 0


def test_a_kernel_is_named_with_its_operators_and_span():
    tool = harness.load_file(TOOL, "span_breakdown")
    span = _ev(P + "attention.core", 0, 10)
    outer = _ev("aten::repeat_interleave", 1, 5)
    inner = _ev("aten::index_select", 2, 4)
    call = _ev("cudaLaunchKernel", 3, 4, id=4, linked=1)
    outer.cpu_parent, inner.cpu_parent, call.cpu_parent, span.cpu_parent = span, outer, inner, None
    # launched from another thread: no operator of the span's thread around it
    bwd = _ev("cudaLaunchKernel", 6, 7, thread=2, id=5, linked=2)
    bwd.cpu_parent = None
    kernel = _gpu("indexSelectLargeIndex", 5, 9, 4)
    mm = _gpu("gemm_bwd", 9, 10, 5)
    stray = _gpu("copy", 12, 13, 99)
    got = tool.by_kernel([span, outer, inner, call, bwd, kernel, mm, stray])
    assert got[0][:4] == ["indexSelectLargeIndex", "aten::repeat_interleave",
                          "aten::index_select", "attention.core"]
    assert got[0][4] == pytest.approx(4e-6)
    assert [g[:4] for g in got[1:]] == [["gemm_bwd", "-", "-", "attention.core"],
                                        ["copy", "-", "-", by_span.OUTSIDE]]
