#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

from the root of a checkout.  It builds the hand-written CUDA kernels
from the checkout's sources (one nvcc per kernel, started together) and
stops with a non-zero exit at the first phase that fails:

1. device: the card's name and power limit, torch and CUDA versions, each
   kernel's build time and ptxas register and spill lines;
2. the flash-attention kernel against its plain PyTorch version on the
   card, at the three serving shapes and at f32, ragged, GQA, windowed and
   non-causal shapes, each with the body it ran (bf16 on the tensor cores,
   ``flash_attention_sm90.cu``; f32 on the CUDA cores,
   ``flash_attention.cu``), the median time of a single call (CUDA
   events, the host's enqueue inside), the plain version's, the time of
   ``scaled_dot_product_attention`` (a yardstick the port never calls)
   and the least time the card could take, then the device time per
   call of the kernel, the plain version and SDPA (calls queued back to
   back between CUDA events, the host's enqueue left out);
3. the SSD scan (two kernels a call, ``ssd_scan.cu``: C Bᵀ per batch
   and chunk, then the scan on the tensor cores in 3xTF32) against its
   plain version (``ssd_chunked``) at ``mamba2-130m``'s and
   ``hymba-1.5b``'s serving shapes, both with contiguous inputs and with
   x, B and C split from one packed tensor as ``apply_mamba`` passes
   them, at ``mamba2-130m``'s width with a live initial state and with a
   ragged S = 500, and at bf16, ragged and non-zero initial-state shapes,
   and once against the sequential recurrence; each with the tile of P
   rows and the blocks per SM the launch picked, a single call's time,
   the plain version's and the least time the card could take at the
   CUDA cores' f32 rate and at the tensor cores' 3xTF32 rate (no single
   PyTorch call computes it), then the device times per call, as for
   flash;
4. ``gwtf-llama-300m``, ``tinyllama-1.1b``, ``mamba2-130m`` and
   ``hymba-1.5b`` served at full width (bf16 params, f32 cache, batch 8,
   prompt 512, 32 greedy tokens) through
   ``repro_torch.launch.serve.generate``, one model on the card at a time,
   each kernel's launches counted over exactly each serve (the main path)
   and held to one per attention or SSM layer of the prefill, every flash
   launch on the bf16 tensor-core body, then where the
   time goes: wall time, device busy time, the top kernels and the port's
   own kernels (each with its share of the busy time) of one prefill and
   of 8 decode steps, from ``torch.profiler``;
5. the port on the GPU against the port on the CPU, reduced f32 models of
   all four families' configs on the same weights: logits within 1e-3,
   greedy streams equal;
6. a JSON line of the kernels, then the card, then the result line.

It needs no network and exits non-zero, printing no result, without a
GPU or outside a checkout of the repository.
"""
from __future__ import annotations

import json
import re
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels.ref import ssd_reference  # noqa: E402
from repro_torch.kernels.timing import (card_line, device_ms,  # noqa: E402
                                        median_ms, show)
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models.transformer import (decode_step, init_cache,  # noqa: E402
                                            prefill)

# NVIDIA H100 SXM data sheet, dense: HBM rate and peak rates by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# f32 products on the tensor cores as 3xTF32: three TF32 passes at 495 TFLOP/s
PEAK_FLOPS_3XTF32 = 495e12 / 3

# name, (B, S, H, KH, D), dtype, causal, window, tolerance (rtol = atol)
KERNEL_CASES = [
    ("serve gwtf-llama-300m", (8, 512, 16, 16, 64), torch.bfloat16, True, None, 2e-2),
    ("serve tinyllama-1.1b GQA 32/4", (8, 512, 32, 4, 64), torch.bfloat16, True, None, 2e-2),
    ("serve hymba-1.5b GQA 25/5", (8, 512, 25, 5, 64), torch.bfloat16, True, None, 2e-2),
    ("f32 S=256 D=128", (2, 256, 8, 8, 128), torch.float32, True, None, 2e-4),
    ("ragged S=100", (4, 100, 16, 16, 64), torch.float32, True, None, 2e-4),
    ("bf16 ragged S=100", (4, 100, 16, 16, 64), torch.bfloat16, True, None, 2e-2),
    ("window 64", (8, 512, 16, 16, 64), torch.bfloat16, True, 64, 2e-2),
    ("bf16 D=128 GQA 8/2 window 32 ragged S=200", (2, 200, 8, 2, 128), torch.bfloat16,
     True, 32, 2e-2),
    ("non-causal ragged S=130", (2, 130, 8, 8, 64), torch.float32, False, None, 2e-4),
    ("bf16 non-causal ragged S=130", (2, 130, 8, 8, 64), torch.bfloat16, False,
     None, 2e-2),
]
# name, (B, S, H, P, N), dtype, initial state ("zero" as the serving
# cache passes it, "none", or "random"), packed (x, B and C strided views
# of one (B, S, H*P + 2N) tensor, as apply_mamba splits the causal conv's
# output), tolerance (rtol = atol): f32 2e-3, since the kernel's chunks
# associate the sums otherwise than the plain version's (a ragged S is one
# chunk there); bf16 10x the bf16 2e-2, as in tests/test_kernels.py.  The
# first case is the main path's: its numbers go to the kernels line.
SSD_CASES = [
    ("serve mamba2-130m packed", (8, 512, 24, 64, 128), torch.float32, "zero",
     True, 2e-3),
    ("serve hymba-1.5b packed", (8, 512, 50, 64, 16), torch.float32, "zero",
     True, 2e-3),
    ("serve mamba2-130m contiguous", (8, 512, 24, 64, 128), torch.float32,
     "zero", False, 2e-3),
    ("serve hymba-1.5b contiguous", (8, 512, 50, 64, 16), torch.float32, "zero",
     False, 2e-3),
    # decode after a prefill: the state the cache carries is live
    ("serve mamba2-130m packed live h0", (8, 512, 24, 64, 128), torch.float32,
     "random", True, 2e-3),
    ("serve mamba2-130m packed ragged S=500", (8, 500, 24, 64, 128),
     torch.float32, "zero", True, 2e-3),
    ("bf16", (2, 256, 3, 32, 64), torch.bfloat16, "none", False, 2e-1),
    ("ragged S=100", (2, 100, 4, 64, 128), torch.float32, "none", False, 2e-3),
    ("h0 != 0", (2, 192, 4, 48, 40), torch.float32, "random", False, 2e-3),
]
SSD_SEQUENTIAL_CASE = ("sequential oracle", (1, 96, 2, 16, 8), torch.float32,
                       "random", False, 2e-3)
BODY_NAMES = {"flash_attention_sm90": "tensor-core bf16 (flash_attention_sm90.cu)",
              "flash_attention": "CUDA-core f32 (flash_attention.cu)"}
PORT_KERNELS = ("flash_fwd_sm90_kernel", "flash_fwd_kernel", "ssd_cb_kernel",
                "ssd_scan_tf32_kernel")
SERVE = dict(batch=8, prompt_len=512, gen=32)
# a prefill launches the flash kernel once per attention layer and the SSD
# kernel once per SSM layer; decode launches neither
SERVE_ARCHS = ["gwtf-llama-300m", "tinyllama-1.1b", "mamba2-130m", "hymba-1.5b"]


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


def ssd_bound(shape, dtype, h0: bool):
    """Least time for the SSD scan, at two rates of arithmetic: ``f32``
    with every product on the CUDA cores, and ``3xtf32``, the kernel's,
    with C B^T there and the chunk products on the tensor cores in
    3xTF32.  Bytes: x and y in their dtype, dt f32, B and C, A, h0 (if
    given) and h_final f32, each once.  Operations: the causal (row t,
    row s <= t) pairs of each chunk of 64, Q (Q + 1) / 2 for a chunk of Q
    rows (a ragged last chunk counts at its length), each 2 N for C B^T,
    once per (b, chunk) since B and C are shared across heads, and 2 P for
    M x per (b, h); then per (b, h) the state's output and update, 2 P N
    per row each.  Returns {rate: (ms, "bytes" or "operations")}."""
    B, S, H, P, N = shape
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = ((2 * B * S * H * P + 2 * B * S * N) * elem + (B * S * H + H) * 4
              + (2 if h0 else 1) * B * H * P * N * 4)
    pairs = sum(q * (q + 1) // 2 for q in (min(64, S - c) for c in range(0, S, 64)))
    cb_flops = 2 * pairs * N * B
    chunk_flops = 2 * pairs * P * B * H + 4 * S * P * N * B * H
    t_bytes = nbytes / HBM_BYTES_PER_S
    bounds = {}
    for rate, t_ops in (
            ("f32", (cb_flops + chunk_flops) / PEAK_FLOPS[torch.float32]),
            ("3xtf32", cb_flops / PEAK_FLOPS[torch.float32]
             + chunk_flops / PEAK_FLOPS_3XTF32)):
        bounds[rate] = (max(t_bytes, t_ops) * 1e3,
                        "bytes" if t_bytes >= t_ops else "operations")
    return bounds


def phase_device():
    print("== 1. device")
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    libraries = (fa.SM90_LIBRARY, fa.LIBRARY, ssd.LIBRARY)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:   # one nvcc each, together
        list(pool.map(lambda lib: lib.build(), libraries))
    for lib in libraries:
        lib.load()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f}s")
    for lib in libraries:
        print(f"{lib.name} kernel built in {lib.build_seconds or 0.0:.1f}s")
        kernel = ""
        for line in lib.build_log.splitlines():
            if "Compiling entry function" in line:
                kernel = ptxas_kernel(line)
            elif "registers" in line or "spill" in line:
                print(f"  ptxas: {kernel}: {line.split(':')[-1].strip()}")


def ptxas_kernel(line: str) -> str:
    """'name<type, ints>' of the kernel a ptxas 'Compiling entry function'
    line names (its mangled name, template arguments and all)."""
    mangled = line.split("'")[1] if line.count("'") >= 2 else line
    name = next((n for n in PORT_KERNELS if n in mangled), None)
    if name is None:
        return mangled[:60]
    args = mangled.split(name, 1)[1].split("EEv", 1)[0]
    dtype = "bf16" if "bfloat16" in args else "f32" if args[1:2] == "f" else ""
    ints = re.findall(r"Li(\d+)E", args)
    return f"{name}<{', '.join(filter(None, [dtype, *ints]))}>"


def phase_kernel():
    print("== 2. flash-attention kernel against its plain version")
    results = {}
    for name, shape, dtype, causal, window, tol in KERNEL_CASES:
        B, S, H, KH, D = shape
        g = torch.Generator(device="cuda").manual_seed(S + H + D)
        q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, S, KH, D, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, S, KH, D, generator=g, device="cuda").to(dtype)
        before = dict(fa.BODY_LAUNCHES)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ran = [body for body, n in fa.BODY_LAUNCHES.items() if n != before[body]]
        if ran != [fa.BODIES[dtype].name]:
            raise SystemExit(f"{name}: {dtype} ran the bodies {ran}, want "
                             f"{fa.BODIES[dtype].name}")
        ref = ops.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
        err = (out.float() - ref.float()).abs().max().item()

        kernel = lambda: ops.flash_attention(q, k, v, causal=causal,  # noqa: E731
                                             window=window)
        plain = lambda: ops.flash_attention_plain(  # noqa: E731
            q, k, v, causal=causal, window=window)
        ms = median_ms(kernel, reps=20)
        plain_ms = median_ms(plain, reps=5)
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
        dev = dict(device_ms=device_ms(kernel, reps=20),
                   plain_device_ms=device_ms(plain, reps=5),
                   library_device_ms=device_ms(lib, reps=20))
        print(f"{name}: B={B} S={S} H={H} KH={KH} D={D} {dtype} causal={causal} "
              f"window={window} body {BODY_NAMES[ran[0]]} max_abs_err={err:.3g} "
              f"(tol {tol}) a single call: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (err {lib_err:.3g}), "
              f"bound {bound_ms:.4f} ms by {bound_by}; device: kernel "
              f"{show(dev['device_ms'])}, plain {show(dev['plain_device_ms'])}, "
              f"sdpa {show(dev['library_device_ms'])}")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms, **dev)
    return results


def ssd_inputs(shape, dtype, h0_kind, packed, seed):
    B, S, H, P, N = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    if packed:
        conv_out = torch.randn(B, S, H * P + 2 * N, generator=g,
                               device="cuda").to(dtype)
        xs, Bm, Cm = torch.split(conv_out, [H * P, N, N], dim=-1)
        x = xs.reshape(B, S, H, P)
        assert x.data_ptr() == conv_out.data_ptr() and not x.is_contiguous()
    else:
        x = torch.randn(B, S, H, P, generator=g, device="cuda").to(dtype)
        Bm = torch.randn(B, S, N, generator=g, device="cuda").to(dtype)
        Cm = torch.randn(B, S, N, generator=g, device="cuda").to(dtype)
    dt = F.softplus(torch.randn(B, S, H, generator=g, device="cuda"))
    A = -torch.exp(torch.randn(H, generator=g, device="cuda"))
    h0 = {"none": None,
          "zero": torch.zeros(B, H, P, N, device="cuda"),
          "random": torch.randn(B, H, P, N, generator=g, device="cuda")}[h0_kind]
    return x, dt, A, Bm, Cm, h0


def phase_ssd_kernel():
    print("== 3. SSD scan kernel against its plain version")
    results = {}
    for name, shape, dtype, h0_kind, packed, tol in SSD_CASES:
        B, S, H, P, N = shape
        x, dt, A, Bm, Cm, h0 = ssd_inputs(shape, dtype, h0_kind, packed, S + H + N)
        before = ops.ssd_scan.launches
        y, hf = ops.ssd_scan(x, dt, A, Bm, Cm, h0=h0)
        torch.cuda.synchronize()
        launches = ops.ssd_scan.launches - before
        yr, hfr = ops.ssd_scan_plain(x, dt, A, Bm, Cm, h0=h0)
        torch.cuda.synchronize()
        torch.testing.assert_close(y.float(), yr.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(hf, hfr, rtol=tol, atol=tol)
        err = max((y.float() - yr.float()).abs().max().item(),
                  (hf - hfr).abs().max().item())
        plan = ssd.plan(B, H, P, N, dtype)
        kernel = lambda: ops.ssd_scan(x, dt, A, Bm, Cm, h0=h0)  # noqa: E731
        plain = lambda: ops.ssd_scan_plain(x, dt, A, Bm, Cm, h0=h0)  # noqa: E731
        ms = median_ms(kernel, reps=20)
        plain_ms = median_ms(plain, reps=5)
        bounds = ssd_bound(shape, dtype, h0 is not None)
        bound_ms, bound_by = bounds["3xtf32"]   # the kernel's arithmetic
        # the plain version one call at a time: a call launches ~30 kernels
        # a chunk, and a few calls' worth would fill the device's queue of
        # pending launches, where the host waits whatever the spin
        dev = dict(device_ms=device_ms(kernel, reps=20),
                   plain_device_ms=device_ms(plain, reps=1),
                   library_device_ms=None)
        print(f"{name}: B={B} S={S} H={H} P={P} N={N} {dtype} h0={h0_kind} "
              f"x strides {x.stride()} B strides {Bm.stride()} "
              f"max_abs_err={err:.3g} (rtol = atol = {tol}); tile of "
              f"{plan['tile_p']} P rows, {plan['stages']} stages, {plan['blocks']} "
              f"blocks, {plan['blocks_per_sm']} a SM ({plan['smem']} B shared "
              f"memory); "
              f"ssd_scan.launches +{launches} a call, 2 kernels (ssd_cb_kernel, "
              f"ssd_scan_tf32_kernel); a single call: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, no library call; bound {bound_ms:.4f} ms by "
              f"{bound_by} at 3xTF32, {bounds['f32'][0]:.4f} ms by "
              f"{bounds['f32'][1]} at f32; device: kernel "
              f"{show(dev['device_ms'])}, plain {show(dev['plain_device_ms'])}")
        if launches != 1:
            raise SystemExit(f"{name}: ssd_scan.launches rose by {launches}")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=None, **dev)
    name, shape, dtype, h0_kind, packed, tol = SSD_SEQUENTIAL_CASE
    x, dt, A, Bm, Cm, h0 = ssd_inputs(shape, dtype, h0_kind, packed, 7)
    y, hf = ops.ssd_scan(x, dt, A, Bm, Cm, h0=h0)
    torch.cuda.synchronize()
    yr, hfr = ssd_reference(x, dt, A, Bm, Cm, h0=h0)
    torch.testing.assert_close(y, yr, rtol=tol, atol=tol)
    torch.testing.assert_close(hf, hfr, rtol=tol, atol=tol)
    err = max((y - yr).abs().max().item(), (hf - hfr).abs().max().item())
    print(f"{name}: {shape} {dtype} h0={h0_kind} max_abs_err={err:.3g} "
          f"(rtol = atol = {tol}) against the sequential recurrence")
    return results


def run_serve(arch: str):
    """Serve ``arch`` at full width as the main path; returns each kernel's
    launches counted over exactly this serve."""
    cfg = get_config(arch)
    print(f"== 4. serve {cfg.name} full width, {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, H/KH {cfg.num_heads}/{cfg.num_kv_heads}, "
          f"SSD heads {cfg.ssm_heads} (N {cfg.ssm_state}), "
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
    ops.ssd_scan.launches = 0
    for body in fa.BODY_LAUNCHES:
        fa.BODY_LAUNCHES[body] = 0
    out = generate(model, cfg, prompt, gen=SERVE["gen"], window=None,
                   temperature=0.0, generator=g)
    launches = {"flash_attention": ops.flash_attention.launches,
                "ssd_scan": ops.ssd_scan.launches}
    bodies = dict(fa.BODY_LAUNCHES)
    B = SERVE["batch"]
    want = {"flash_attention": cfg.num_layers if cfg.has_attention else 0,
            "ssd_scan": cfg.num_layers if cfg.has_ssm else 0}
    if launches != want:
        raise SystemExit(f"kernel launches {launches} over the serve, want "
                         f"{want}")
    if bodies[fa.LIBRARY.name]:     # bf16 serves: every launch on the sm90 body
        raise SystemExit(f"flash bodies {bodies}: the f32 body ran in a serve")
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
          f"launches {launches}, flash bodies {bodies}")
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
        ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
        # the top six, then the port's own kernels wherever they rank
        for rank, e in enumerate(ranked):
            if rank < 6 or any(name in e.key for name in PORT_KERNELS):
                print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
                      f"({e.self_device_time_total / 1e3 / busy:.1%}) {e.key[:90]}")

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
    for arch in ("gwtf-gpt-300m", "gwtf-llama-300m", "mamba2-130m", "hymba-1.5b"):
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
    flash_timings = phase_kernel()
    ssd_timings = phase_ssd_kernel()

    # each serve is one main path, counted from 0 with its model alone
    # on the card; the kernels line reports their sums
    launches = {"flash_attention": 0, "ssd_scan": 0}
    for arch in SERVE_ARCHS:
        for name, n in run_serve(arch).items():
            launches[name] += n
        torch.cuda.empty_cache()

    phase_gpu_vs_cpu()

    kernels = [
        # the main path's body (bf16) is the source; f32 runs the other
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             sources=["src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
                      "src/repro_torch/kernels/csrc/flash_attention.cu"],
             replaces="src/repro/kernels/flash_attention.py:30",
             launches=launches["flash_attention"],
             **flash_timings[KERNEL_CASES[0][0]]),
        dict(name="ssd_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:31",
             launches=launches["ssd_scan"], **ssd_timings[SSD_CASES[0][0]]),
    ]
    print("kernels: " + ", ".join(
        f"{k['name']} launches={k['launches']} max_abs_err={k['max_abs_err']:.3g}"
        for k in kernels))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
