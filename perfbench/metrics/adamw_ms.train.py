"""ms an iteration in the update: the span around
``RuntimeTrainer._apply_update`` (AdamW over every tree), the device
synchronized on both sides, over the window's iterations."""


def read(run, cell):
    spans = run.spans.get("_apply_update", [])
    if not run.records or not spans:
        return None
    return sum(spans) / len(run.records) * 1e3
