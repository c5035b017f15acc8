"""Share of the launched microbatches that the routing dropped (churn's
doing, not a failure), over the window, %."""


def read(run, cell):
    launched = sum(r["launched"] for r in run.records)
    return 100.0 * sum(r["dropped"] for r in run.records) / launched if launched else None
