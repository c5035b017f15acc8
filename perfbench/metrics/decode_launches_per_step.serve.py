"""Device operations a decode step: those of a traced request less those
of a traced prefill of the same prompts alone, over the request's steps."""


def read(run, cell):
    pre = run.extra.get("prefill_profile")
    if run.profile is None or pre is None:
        return None
    return (run.profile["launches"] - pre["launches"]) / cell.workload["gen"]
