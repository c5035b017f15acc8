"""Share of the traced iterations' wall time in which the device ran
nothing, %: 1 - busy / wall, from the profiler's trace (which lengthens the
host's work, so this is an upper bound)."""


def read(run, cell):
    if run.profile is None:
        return None
    return 100.0 * (1.0 - run.profile["busy_s"] / run.profile["wall_s"])
