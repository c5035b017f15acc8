"""Model FLOPs of a prefill (``flops.prefill_flops``) over the mean of the
window's ``prefill_s`` (``generate``'s span, the device synchronized), as a
share of the H100's 989 TFLOP/s bf16, %."""
from perfbench import flops


def read(run, cell):
    if not run.records:
        return None
    w = cell.workload
    mean = sum(r["prefill_s"] for r in run.records) / len(run.records)
    return 100.0 * flops.prefill_flops(cell.config, w["batch"], w["prompt_len"]) / mean \
        / flops.PEAK_FLOPS_BF16
