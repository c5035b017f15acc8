"""The routed experts' share of the bf16 peak in the stages' forward, %:
the three expert products' FLOPs (``flops_mla_moe.expert_forward_flops``,
2 x pairs x 3 x D x F a MoE layer, pairs = tokens x k) of the profiled
iteration's completed microbatches, over the device time of everything the
program launched under its ``moe.experts`` spans in ``stage.fwd`` (the
grouped products, and the gather, activation and combine around them), at
989 TFLOP/s."""
from perfbench import flops, flops_mla_moe


def read(run, cell):
    prof = run.extra.get("span_profile")
    if prof is None:
        return None
    secs = sum(s for path, s in prof["span_device_s"].items()
               if "moe.experts" in path.split("/") and "stage.fwd" in path.split("/"))
    if not secs:
        return None
    c, w = cell.config, cell.workload
    tokens = prof["completed"] * w["batch"] * w["seq_len"]
    work = (c["num_layers"] - c["first_dense_layers"]) * flops_mla_moe.expert_forward_flops(
        c, tokens)
    return 100.0 * work / secs / flops.PEAK_FLOPS_BF16
