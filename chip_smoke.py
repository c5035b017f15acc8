#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

from the root of a checkout.  It builds the hand-written CUDA kernel from
the checkout's sources and stops with a non-zero exit at the first phase
that fails:

1. device: the card's name and power limit, torch and CUDA versions, the
   kernel's build time;
2. the flash-attention kernel against its plain PyTorch version on the
   card, at the serving shapes and at f32, ragged, GQA, windowed and
   non-causal shapes, each with its time, the plain version's, the time of
   ``scaled_dot_product_attention`` (a yardstick the port never calls)
   and the least time the card could take;
3. ``gwtf-llama-300m`` and 4. ``tinyllama-1.1b`` served at full width
   (bf16 params, f32 cache, batch 8, prompt 512, 32 greedy tokens) through
   ``repro_torch.launch.serve.generate``, one model on the card at a time,
   the kernel's launches counted over exactly each serve (the main path),
   then where the time goes: wall time, device busy time and the top
   kernels of one prefill and of 8 decode steps, from ``torch.profiler``;
5. the port on the GPU against the port on the CPU, reduced f32 models on
   the same weights: logits within 1e-3, greedy streams equal;
6. a JSON line of the kernels, then the card, then the result line.

It needs no network and exits non-zero, printing no result, without a
GPU or outside a checkout of the repository.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.runtime.serving import serving_inputs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models.transformer import (decode_step, init_cache,  # noqa: E402
                                            prefill)

# NVIDIA H100 SXM data sheet, dense: HBM rate and peak rates by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# name, (B, S, H, KH, D), dtype, causal, window, tolerance (rtol = atol)
KERNEL_CASES = [
    ("serve gwtf-llama-300m", (8, 512, 16, 16, 64), torch.bfloat16, True, None, 2e-2),
    ("serve tinyllama-1.1b GQA 32/4", (8, 512, 32, 4, 64), torch.bfloat16, True, None, 2e-2),
    ("f32 S=256 D=128", (2, 256, 8, 8, 128), torch.float32, True, None, 2e-4),
    ("ragged S=100", (4, 100, 16, 16, 64), torch.float32, True, None, 2e-4),
    ("window 64", (8, 512, 16, 16, 64), torch.bfloat16, True, 64, 2e-2),
    ("bf16 D=128 GQA 8/2 window 32 ragged S=200", (2, 200, 8, 2, 128), torch.bfloat16,
     True, 32, 2e-2),
    ("non-causal ragged S=130", (2, 130, 8, 8, 64), torch.float32, False, None, 2e-4),
]
SERVE = dict(batch=8, prompt_len=512, gen=32)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def median_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median over ``reps`` single calls, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attended_pairs(S: int, causal: bool, window) -> int:
    """(query, key) pairs the rows attend: what this input needs."""
    return sum((i + 1 if causal else S) - (max(0, i - window + 1) if window else 0)
               for i in range(S))


def bound(shape, dtype, causal, window):
    B, S, H, KH, D = shape
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * B * S * H * D + 2 * B * S * KH * D) * elem   # q, o, k, v
    flops = 4 * D * attended_pairs(S, causal, window) * B * H   # QK^T and PV
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    print("== 1. device")
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    fa.load()
    print(f"flash_attention kernel built in {fa.build_seconds or 0.0:.1f}s "
          f"(load {time.perf_counter() - t0:.1f}s)")
    for line in fa.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def phase_kernel():
    print("== 2. flash-attention kernel against its plain version")
    results = {}
    for name, shape, dtype, causal, window, tol in KERNEL_CASES:
        B, S, H, KH, D = shape
        g = torch.Generator(device="cuda").manual_seed(S + H + D)
        q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, S, KH, D, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, S, KH, D, generator=g, device="cuda").to(dtype)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = ops.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
        err = (out.float() - ref.float()).abs().max().item()

        ms = median_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                   window=window), reps=20)
        plain_ms = median_ms(lambda: ops.flash_attention_plain(
            q, k, v, causal=causal, window=window), reps=5)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal, enable_gqa=H != KH)
        else:
            pos = torch.arange(S, device="cuda")
            mask = pos[None, :] > pos[:, None] - window
            if causal:
                mask &= pos[None, :] <= pos[:, None]
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=H != KH)
        lib_err = (lib().transpose(1, 2).float() - ref.float()).abs().max().item()
        library_ms = median_ms(lib, reps=20)
        bound_ms, bound_by = bound(shape, dtype, causal, window)
        print(f"{name}: B={B} S={S} H={H} KH={KH} D={D} {dtype} causal={causal} "
              f"window={window} max_abs_err={err:.3g} (tol {tol}) kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms "
              f"(err {lib_err:.3g}), bound {bound_ms:.4f} ms by {bound_by}")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms)
    return results


def run_serve(label: str, arch: str) -> int:
    """Serve ``arch`` at full width as the main path; returns the kernel's
    launches counted over exactly this serve."""
    cfg = get_config(arch)
    print(f"== {label}: {cfg.name} full width, {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, H/KH {cfg.num_heads}/{cfg.num_kv_heads}, "
          f"vocab {cfg.vocab_size}, bf16 params, f32 cache")
    model, prompt, g = serving_inputs(cfg, seed=0, batch=SERVE["batch"],
                                      prompt_len=SERVE["prompt_len"],
                                      device="cuda")
    # warm-up: one-time set-up (cuBLAS handles, lazy module loads) stays
    # out of the numbers below
    generate(model, cfg, prompt, gen=2, window=None, temperature=0.0,
             generator=g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.flash_attention.launches = 0      # the main path starts here
    out = generate(model, cfg, prompt, gen=SERVE["gen"], window=None,
                   temperature=0.0, generator=g)
    launches = ops.flash_attention.launches
    B = SERVE["batch"]
    if launches != cfg.num_layers:
        raise SystemExit(f"flash kernel launched {launches} times in the "
                         f"prefill, want {cfg.num_layers}")
    if out.tokens.shape != (B, SERVE["gen"] + 1):
        raise SystemExit(f"tokens of shape {tuple(out.tokens.shape)}")
    if int(out.tokens.min()) < 0 or int(out.tokens.max()) >= cfg.vocab_size:
        raise SystemExit("a token out of the vocabulary")
    if not torch.isfinite(out.logits).all():
        raise SystemExit("non-finite logits")
    print(f"prefill {out.prefill_s * 1e3:.2f} ms (batch {B} x prompt "
          f"{SERVE['prompt_len']}), decode {B * SERVE['gen'] / out.decode_s:.1f} "
          f"tok/s ({SERVE['gen']} steps x {B} seqs in {out.decode_s:.3f}s), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"flash launches {launches}")
    print("sample:", out.tokens[0, :16].tolist())
    print("where the time goes (torch.profiler):")
    profile_serve(cfg, model, prompt)
    return launches


def profile_serve(cfg, model, prompt, steps: int = 8):
    """Wall time against device busy time for one prefill and ``steps``
    greedy decode steps, and the kernels that take the device's time.
    The profiler's own cost inflates the profiled wall time; the
    unprofiled wall time of the same work is printed beside it."""
    B, P = prompt.shape

    def run(label, fn):
        fn()                                             # unprofiled
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_prof = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        launches = sum(e.count for e in kernels)
        print(f"{cfg.name} {label}: wall {wall:.2f} ms, profiled {wall_prof:.2f} ms, "
              f"device busy {busy:.2f} ms in {launches} kernels "
              f"(idle share {1 - busy / wall_prof:.1%} of the profiled wall)")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
                  f"{e.key[:90]}")

    def do_prefill():
        cache = init_cache(cfg, B, P + steps, dtype=torch.float32,
                           device=prompt.device)
        return prefill(model, cfg, tokens=prompt, cache=cache)

    logits, cache = do_prefill()
    tok = logits.argmax(dim=-1)[:, None]

    def do_decode():
        for i in range(steps):
            decode_step(model, cfg, tokens=tok, cache=cache, index=P + i)

    run("prefill", do_prefill)
    run(f"decode x{steps}", do_decode)


def phase_gpu_vs_cpu():
    print("== 5. port on cuda against port on cpu (f32, TF32 off)")
    for arch in ("gwtf-gpt-300m", "gwtf-llama-300m"):
        cfg = get_config(arch).reduced()
        runs = {}
        for device in ("cpu", "cuda"):
            # drawn on the CPU both times, so both runs hold the same weights
            model, prompt, _ = serving_inputs(cfg, seed=0, batch=2,
                                              prompt_len=64, device="cpu")
            runs[device] = generate(model.to(device), cfg, prompt.to(device),
                                    gen=8, window=None, temperature=0.0,
                                    generator=None)
        cpu, gpu = runs["cpu"], runs["cuda"]
        torch.testing.assert_close(gpu.logits.cpu(), cpu.logits, rtol=1e-3,
                                   atol=1e-3)
        if not torch.equal(gpu.tokens.cpu(), cpu.tokens):
            raise SystemExit(f"{arch}: greedy streams differ on cuda and cpu")
        err = (gpu.logits.cpu() - cpu.logits).abs().max().item()
        print(f"{cfg.name}: logits max_abs_err {err:.3g} (tol 1e-3) over "
              f"{cpu.logits.shape[0]} steps, greedy streams equal")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 1
    # f32 results are compared below: keep f32 products in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_device()
    timings = phase_kernel()

    # each serve is one main path, counted from 0 with its model alone
    # on the card; the kernels line reports their sum
    launches = run_serve("3. serve", "gwtf-llama-300m")
    torch.cuda.empty_cache()
    launches += run_serve("4. serve", "tinyllama-1.1b")
    torch.cuda.empty_cache()

    phase_gpu_vs_cpu()

    main_case = timings[KERNEL_CASES[0][0]]
    kernels = [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:30",
        launches=launches, **main_case)]
    print(f"kernels: flash_attention launches={launches} "
          f"max_abs_err={main_case['max_abs_err']:.3g}")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
