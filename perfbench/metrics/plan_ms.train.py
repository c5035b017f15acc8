"""Host ms an iteration in the trainer's planning: the spans around
``trainer.policy.plan`` (flow routing) and ``trainer.recovery.resolve``
(crash resolution), summed over the window, over its iterations."""


def read(run, cell):
    spans = run.spans.get("plan", []) + run.spans.get("resolve", [])
    if not run.records or not spans:
        return None
    return sum(spans) / len(run.records) * 1e3
