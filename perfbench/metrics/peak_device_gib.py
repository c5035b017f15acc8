"""Peak device memory, GiB: ``torch.cuda.max_memory_allocated()`` from a
reset at the start of set-up to the end of the window."""


def read(run, cell):
    return None if run.peak_bytes is None else run.peak_bytes / 2**30
