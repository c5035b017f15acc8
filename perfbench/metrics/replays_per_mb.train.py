"""Stage-local recomputes and replays (``fwd_recomputes`` +
``bwd_replays``) per completed microbatch, over the window."""


def read(run, cell):
    done = sum(r["completed"] for r in run.records)
    if not done:
        return None
    return sum(r["fwd_recomputes"] + r["bwd_replays"] for r in run.records) / done
