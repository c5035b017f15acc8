"""The median, over every request of the window, of the time from its
send to the end of its prefill, ms (a request is a batch of prompts, all
with the same first-token time; the count is the line's ``attempted``)."""
import statistics


def read(run, cell):
    times = [r["ttft_s"] * 1e3 for r in run.records]
    return statistics.median(times) if times else None
