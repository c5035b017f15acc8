"""Device ms an iteration under the program's ``moe`` span in a stage's
forward (``stage.fwd``) or a replay (``replay``), from the iteration the
driver profiles with the program's spans on; the backward is not split
(it runs under ``stage.bwd``)."""


def read(run, cell):
    prof = run.extra.get("span_profile")
    if prof is None:
        return None
    total = 0.0
    for path, s in prof["span_device_s"].items():
        names = path.split("/")
        if "moe" in names and ("stage.fwd" in names or "replay" in names):
            total += s
    return total / prof["iterations"] * 1e3
