"""The program's expert-load counter (``IterationResult.expert_load_max``):
the worst MoE layer's most-loaded expert over its mean load, routed pairs
counted on the device over an iteration, read in the iteration the driver
profiles with the program's spans on; the mean over those iterations."""


def read(run, cell):
    loads = run.extra.get("expert_load_max")
    if not loads:
        return None
    return sum(loads) / len(loads)
