"""Tokens of the microbatches that completed, over every iteration the
window ran, divided by the window's whole wall time (each iteration ends
with the device synchronized)."""


def read(run, cell):
    if not run.records or not run.window_s:
        return None
    return sum(r["tokens"] for r in run.records) / run.window_s
