"""``torch.profiler`` over a short stretch of work, reduced to numbers.

Built on ``chip_smoke.py::profiled`` (device busy time and launches from
the CUDA events), with the timeline read as well: busy time is the union
of the device's activity intervals, so nothing counts twice; each idle
gap between them is charged to what the host was doing at its middle
(the innermost host event open then: a ``perfbench/`` span or an
operator, ``python`` where none was open). The device's copies of the
benchmark's own ``perfbench/`` ranges are annotations, not work, and are
left out. The profiler's own cost lengthens the host's work, so an idle
share read here is an upper bound; it is read from traced runs only.
"""
from __future__ import annotations

import heapq
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

ANNOTATIONS = ("perfbench/",)


def _intervals(events) -> List[Tuple[float, float]]:
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    merged: List[List[float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _top(totals: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def summarize(events, wall_s: float) -> dict:
    """Busy seconds, launches, device time and launches by operation name,
    and idle seconds by host activity, from a profile's events."""
    from torch.autograd import DeviceType
    # a host range (``record_function``) also shows on the device's
    # timeline as an annotation over all it launched: not device work
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith(ANNOTATIONS)]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    busy = _intervals(dev)
    by_op: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    for e in dev:
        by_op[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
        count[e.name] += 1
    start = min([e.time_range.start for e in host] + [s for s, _ in busy[:1]] or [0.0])
    end = max([e.time_range.end for e in host] + [e for _, e in busy[-1:]] or [0.0])
    edges = [start] + [x for iv in busy for x in iv] + [end]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    idle: Dict[str, float] = defaultdict(float)
    order = sorted(host, key=lambda e: e.time_range.start)
    heap: List[tuple] = []
    i = 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        t = (a + b) / 2
        while i < len(order) and order[i].time_range.start <= t:
            e = order[i]
            heapq.heappush(heap, (-e.time_range.start, i, e))
            i += 1
        while heap and heap[0][2].time_range.end < t:
            heapq.heappop(heap)
        idle[heap[0][2].name if heap else "python"] += (b - a) * 1e-6
    return {"wall_s": wall_s,
            "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "launches": len(dev),
            "device_s": dict(by_op), "device_count": dict(count),
            "device_ops": _top(by_op), "idle_gaps": _top(idle)}


def profile(fn: Callable[[], object]) -> Tuple[dict, object]:
    """Run ``fn`` once under the profiler, the device synchronized on both
    sides; returns (summary, fn's result)."""
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return summarize(prof.events(), wall), out
