"""The device's work and idle time of a profile, charged to the program's
spans (``repro_torch.spans``: ``record_function`` ranges named
``repro_torch/<span>``).

``charge(events)`` reads the events of a ``torch.profiler`` run in which
the program traced its spans, and returns, keyed by each span's path (its
name under its enclosing spans on the same thread, ``iteration/execute/
chunk/stage.fwd``), or ``outside`` where no span was open:

* ``span_device_s``, ``span_launches``: a device operation is charged to
  the innermost program span open, on any thread, when the host launched
  it.  The launch is the runtime call (``cudaLaunchKernel``,
  ``cudaMemcpyAsync``, ...) with the operation's correlation id: a
  backward kernel is launched from autograd's device thread while
  ``stage.bwd`` is open on the caller's;
* ``span_idle_s``: each gap between the device's busy intervals is charged
  to the innermost program span open at its middle;
* ``unmatched_launches``: the device operations whose runtime call the
  profile lacks, charged at their own start instead.

The device's copies of the benchmark's and of the program's ranges are
annotations, not work, and are left out, as ``profiling.summarize`` leaves
out the benchmark's; busy time is the union of the rest, as there.
"""
from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from perfbench.profiling import ANNOTATIONS, _intervals

PROGRAM = "repro_torch/"        # repro_torch.spans.PREFIX
OUTSIDE = "outside"


def _paths(spans: list, prefix: str) -> List[str]:
    """Each span's path, from its nesting among the spans of its thread."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i].time_range.start,
                                                     -spans[i].time_range.end))
    stacks: Dict[int, List[int]] = defaultdict(list)
    paths = [""] * len(spans)
    for i in order:
        e, stack = spans[i], stacks[spans[i].thread]
        while stack and spans[stack[-1]].time_range.end < e.time_range.end:
            stack.pop()
        name = e.name[len(prefix):]
        paths[i] = f"{paths[stack[-1]]}/{name}" if stack else name
        stack.append(i)
    return paths


def _innermost(spans: list, depth: List[int], times: List[float]
               ) -> List[Optional[int]]:
    """For each time, the span open then that started last (the deepest of
    those that started together), or None."""
    order = sorted(range(len(spans)), key=lambda i: spans[i].time_range.start)
    out: List[Optional[int]] = [None] * len(times)
    heap: List[tuple] = []
    k = 0
    for j in sorted(range(len(times)), key=times.__getitem__):
        t = times[j]
        while k < len(order) and spans[order[k]].time_range.start <= t:
            i = order[k]
            heapq.heappush(heap, (-spans[i].time_range.start, -depth[i], i))
            k += 1
        while heap and spans[heap[0][2]].time_range.end < t:
            heapq.heappop(heap)
        out[j] = heap[0][2] if heap else None
    return out


def _launch_times(dev: list, host: list) -> Tuple[List[float], int]:
    """When the host launched each device operation: the start of the
    runtime call with its correlation id, else the operation's own start;
    and how many took the latter."""
    calls = {e.id: e.time_range.start for e in host
             if e.name.startswith("cu") and "::" not in e.name
             and getattr(e, "linked_correlation_id", 1) != 0}
    times = [calls.get(e.id) for e in dev]
    return ([e.time_range.start if t is None else t for e, t in zip(dev, times)],
            times.count(None))


def charge(events, prefix: str = PROGRAM) -> Dict[str, dict]:
    """``span_device_s``, ``span_launches`` and ``span_idle_s`` of a
    profile's events, each keyed by span path, and ``unmatched_launches``
    (see the module)."""
    from torch.autograd import DeviceType
    left_out = tuple(ANNOTATIONS) + (prefix,)
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith(left_out)]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    spans = [e for e in host if e.name.startswith(prefix)]
    paths = _paths(spans, prefix)
    depth = [p.count("/") for p in paths]

    def key(i: Optional[int]) -> str:
        return OUTSIDE if i is None else paths[i]

    device: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    launched, unmatched = _launch_times(dev, host)
    for e, i in zip(dev, _innermost(spans, depth, launched)):
        device[key(i)] += (e.time_range.end - e.time_range.start) * 1e-6
        launches[key(i)] += 1
    busy = _intervals(dev)
    start = min([e.time_range.start for e in host] + [s for s, _ in busy[:1]] or [0.0])
    end = max([e.time_range.end for e in host] + [e for _, e in busy[-1:]] or [0.0])
    edges = [start] + [x for iv in busy for x in iv] + [end]
    gaps: List[Tuple[float, float]] = [(a, b) for a, b in zip(edges[0::2], edges[1::2])
                                       if b > a]
    idle: Dict[str, float] = defaultdict(float)
    mids = [(a + b) / 2 for a, b in gaps]
    for (a, b), i in zip(gaps, _innermost(spans, depth, mids)):
        idle[key(i)] += (b - a) * 1e-6
    return {"span_device_s": dict(device), "span_launches": dict(launches),
            "span_idle_s": dict(idle), "unmatched_launches": unmatched}


def by_name(totals: Dict[str, float]) -> Dict[str, float]:
    """Totals keyed by path, summed by the innermost span's name."""
    out: Dict[str, float] = defaultdict(float)
    for path, v in totals.items():
        out[path.rsplit("/", 1)[-1]] += v
    return dict(out)


def total(totals: Dict[str, float], within, leaf: Optional[str] = None) -> float:
    """The sum of ``totals`` over the paths that pass through a span named
    in ``within`` and, with ``leaf``, end in a span of that name."""
    out = 0.0
    for path, v in totals.items():
        names = path.split("/")
        if (leaf is None or names[-1] == leaf) and any(w in names for w in within):
            out += v
    return out
