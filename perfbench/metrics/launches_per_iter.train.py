"""Device operations (kernels, copies, sets) an iteration, counted in the
profiler's trace of the traced iterations after the window."""


def read(run, cell):
    if run.profile is None:
        return None
    return run.profile["launches"] / run.extra["profile_iterations"]
