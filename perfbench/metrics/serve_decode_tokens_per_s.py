"""All tokens decoded in the window over all the decode time
(``generate``'s ``decode_s``, the device synchronized)."""


def read(run, cell):
    decode = sum(r["decode_s"] for r in run.records)
    return sum(r["decoded"] for r in run.records) / decode if decode else None
