"""The bf16 flash-attention kernel's share of its roofline in the traced
request's prefill, %: ``flops.bound`` of one launch at the prefill's shape
(batch, prompt, heads, K/V heads, head size; causal) over the mean device
time of the launches whose name holds ``flash_fwd``."""
from perfbench import flops


def read(run, cell):
    if run.profile is None:
        return None
    names = [k for k in run.profile["device_s"] if "flash_fwd" in k]
    count = sum(run.profile["device_count"][k] for k in names)
    if not count:
        return None
    c, w = cell.config, cell.workload
    shape = (w["batch"], w["prompt_len"], c["num_heads"], c["num_kv_heads"], c["head_dim"])
    ms, _ = flops.bound(shape, 2 if c["param_dtype"] == "bfloat16" else 4, True, None)
    return 100.0 * ms / (sum(run.profile["device_s"][k] for k in names) / count * 1e3)
