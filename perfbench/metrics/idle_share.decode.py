"""Share of a traced request's decode time in which the device ran
nothing, %: the request's busy time less its prefill's (traced alone),
against the request's own ``decode_s``."""


def read(run, cell):
    pre = run.extra.get("prefill_profile")
    if run.profile is None or pre is None:
        return None
    busy = run.profile["busy_s"] - pre["busy_s"]
    return 100.0 * (1.0 - busy / run.extra["profiled_decode_s"])
