"""Timing on the card, shared by ``chip_smoke.py`` and ``tools/``.

``median_ms`` times single calls with the host's enqueue inside;
``device_ms`` times calls queued back to back behind a spin, the device's
time alone; ``card_line`` names the card and its power limit, to stand
beside every time.  All need the card; nothing here runs at import.
"""
from __future__ import annotations

import statistics
import subprocess

import torch


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def median_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median over ``reps`` single calls, each timed with CUDA events: the
    host's enqueue is inside the window, so for a kernel shorter than its
    wrapper's host work this measures the host."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int, runs: int = 3, warmup: int = 3):
    """Device time per call: ``reps`` calls between two CUDA events, queued
    behind a spin kernel so that the device runs them back to back and the
    host's enqueue stays out.  A run counts only if the start event was
    still pending when the host had queued the last call, which shows that
    the spin outlasted the enqueue; otherwise the spin doubles and the run
    is repeated.  The median over ``runs`` runs that count, or None if no
    spin up to 2^30 cycles (~0.5 s) outlasts the enqueue: then a call
    waits on the device, and its device time is not taken.  Inputs stay in
    L2 between calls, as they come to attention from the projection just
    before it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin, times = 1 << 20, []                     # cycles, ~0.5 ms
    while len(times) < runs:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_behind_spin = not start.query()
        end.synchronize()
        if queued_behind_spin:
            times.append(start.elapsed_time(end) / reps)
        elif spin >= 1 << 30:
            return None
        else:
            spin *= 2
    return statistics.median(times)


def show(ms) -> str:
    return "not taken, a call waits on the device" if ms is None else f"{ms:.4f} ms"
