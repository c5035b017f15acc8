"""Set-up seconds: from the process's start (imports, weights, the
program's build and warm-up, kernel builds on a first run) to the window."""


def read(run, cell):
    return run.setup_s
