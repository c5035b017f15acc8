"""Model FLOPs of the microbatches completed in the window
(``flops_mla_moe.train_flops``: the active weights of latent attention,
the chosen and shared experts, the router, the dense layers and the head,
forward and backward, plus the causal attention; no recompute or replay)
over the window's wall time, as a share of the H100's 989 TFLOP/s bf16, %."""
from perfbench import flops, flops_mla_moe


def read(run, cell):
    if not run.records or not run.window_s:
        return None
    w = cell.workload
    seqs = sum(r["completed"] for r in run.records) * w["batch"]
    return 100.0 * flops_mla_moe.train_flops(cell.config, seqs, w["seq_len"]) / run.window_s \
        / flops.PEAK_FLOPS_BF16
