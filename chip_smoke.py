#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

from the root of a checkout.  It builds the hand-written CUDA kernels
from the checkout's sources (one nvcc per kernel, started together) and
stops with a non-zero exit at the first phase that fails:

1. device: the card's name and power limit, torch and CUDA versions, each
   kernel's build time and ptxas register and spill lines;
2. the flash-attention kernel against its plain PyTorch version on the
   card, at the three serving shapes, the cohorts of 1, 3 and 4 rows that
   phase 7 prefills in bf16 and phase 8b in f32, and at f32, ragged, GQA,
   windowed, non-causal and S = 8 shapes, each with the body it ran
   (bf16 on the tensor cores, ``flash_attention_sm90.cu``; f32 on the CUDA cores,
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
6. training, the port's second main path: ``gwtf-llama-300m`` at full
   width (16 layers, bf16 params) through ``repro_torch.launch.train``'s
   ``build_gwtf`` and ``train_iteration``, 4 stages x 3 relays of capacity
   4, 2 data nodes with 4 microbatches of 4 sequences of 512 tokens each,
   3 iterations at churn 0 (a warm-up, one timed, one under
   ``torch.profiler``: device busy time, idle share, top kernels) and 3 at
   churn 0.1, each with its loss, completed/launched/dropped/rerouted, wall ms
   and tokens/s, the trainer's counter invariants held, every loss
   finite, and the kernels' launches counted over the run (the training
   path attends through ``_online_attention``, which autograd
   differentiates, and launches neither kernel); the peak memory, and the
   time of the gradient screen's host copy of one stage's gradient tree
   (the screen runs only under corrupt-gradient churn); then, reduced, in
   a child process with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and
   ``torch.use_deterministic_algorithms(True)`` (which the serves above
   run without), churn 0 against ``CentralizedTrainer`` and the fused path
   against remat, bit for bit in losses and every parameter, f32 and
   bf16; and three reduced f32 iterations on cuda against the cpu:
   counters equal, each loss within ``TRAIN_LOSS_RTOL``, the AdamW
   moments (which see the gradients' magnitudes) within
   ``TRAIN_MOMENT_RTOL`` after the first and the third, the parameters
   after the first as stated at ``TRAIN_PARAM_TOL``;
7. serving under churn, the port's third main path: ``gwtf-llama-300m``
   at full width (bf16 params, f32 cache) through the flow-routed
   ``ServeTrainer`` on a full-width variant of the corpus scenario
   ``serve-churn-under-load`` (``SERVE_CHURN`` with ``SERVE_CHURN_FULL``:
   prompt 512, a 512-token profile microbatch, the crash moved), defended,
   calm (the churn stripped) and undefended (``reroute=False``), each
   with its kernels' launches counted over the run and held to one flash
   launch per layer of each prefill call, all on the bf16 body; per run
   the wall ms of each iteration, of each prefill, decode dispatch and
   cache replay, the counters, decoded tokens per second of wall time,
   the peak memory and the engine's summary in simulated seconds; the
   defended run must requeue mid-decode and replay caches, and every
   completed request holds ``gen_tokens`` tokens of the vocabulary; then
   the crash iteration of a repeat of the defended run under
   ``torch.profiler``; 7b. the scenario itself, reduced, f32, on cuda
   against the cpu, as ``gwtf-llama-300m`` and as ``hymba-1.5b`` (both
   kernels at S = 8): ledgers, summaries, timelines, counters and token
   streams exactly equal, the defended streams equal to the calm ones,
   and each kernel launched once per layer of each prefill call;
8. the port's scenario harness (``repro_torch.core.scenarios.harness``),
   its fourth main path: 8a. ``run_checks`` with every applicable check on
   every spec of the standard corpus and on the hybrid variant of
   ``serve-churn-under-load``, on cuda (serving models drawn on the cpu),
   each check's seconds printed; the zero-churn bit-equalities in a child
   with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``; on ``HARNESS_CPU_TOO`` and
   the hybrid variant the same checks on the cpu, with results, chain
   plans, timelines, counters and streams equal and losses within
   ``TRAIN_LOSS_RTOL``; 8b. ``HARNESS_FULL``, full-width variants of
   corpus specs (``gwtf-llama-300m`` in f32 through the scenario
   generator), each check with its seconds, wall ms per runtime
   iteration and peak memory; every check's kernel launches held to one
   per layer of each prefill call of the serving check, all on the f32
   body, and none elsewhere;
9. a JSON line of the kernels, then the card, then the result line.

It needs no network and exits non-zero, printing no result, without a
GPU or outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.flow.graph import geo_distributed_network  # noqa: E402
from repro_torch.core.runtime.serving import (ServeTrainer,  # noqa: E402
                                              serving_inputs)
from repro_torch.core.runtime import serving  # noqa: E402
from repro_torch.core.scenarios import corpus, harness  # noqa: E402
from repro_torch.core.scenarios import generate as scenarios  # noqa: E402
from repro_torch.core.scenarios.spec import ScenarioSpec  # noqa: E402
from repro_torch.core.runtime.trainer import (CentralizedTrainer,  # noqa: E402
                                              RuntimeTrainer)
from repro_torch.core.sim.faults import BernoulliChurn, TraceChurn  # noqa: E402
from repro_torch.core.sim.metrics import summarize_serving  # noqa: E402
from repro_torch.core.sim.policies import make_policy  # noqa: E402
from repro_torch.data.pipeline import DataConfig, DataNodeShard  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels.ref import ssd_reference  # noqa: E402
from repro_torch.kernels.timing import (card_line, device_ms,  # noqa: E402
                                        median_ms, show)
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models.transformer import (decode_step, init_cache,  # noqa: E402
                                            prefill)
from repro_torch.tree import leaves  # noqa: E402

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
    # phase 7's ServeTrainer prefills cohorts of 1, 3 and 4 rows of 512
    ("serve cohort of 1", (1, 512, 16, 16, 64), torch.bfloat16, True, None, 2e-2),
    ("serve cohort of 3", (3, 512, 16, 16, 64), torch.bfloat16, True, None, 2e-2),
    ("serve cohort of 4", (4, 512, 16, 16, 64), torch.bfloat16, True, None, 2e-2),
    # phase 8b prefills the same cohorts through the harness, f32 (the
    # standalone decode of its zero-churn stream check: one row)
    ("f32 serve cohort of 1", (1, 512, 16, 16, 64), torch.float32, True, None, 2e-4),
    ("f32 serve cohort of 3", (3, 512, 16, 16, 64), torch.float32, True, None, 2e-4),
    ("f32 serve cohort of 4", (4, 512, 16, 16, 64), torch.float32, True, None, 2e-4),
    # the reduced serves of phases 7b and 8a prefill 8 tokens
    ("S=8", (1, 8, 16, 16, 64), torch.float32, True, None, 2e-4),
    ("bf16 S=8", (1, 8, 16, 16, 64), torch.bfloat16, True, None, 2e-2),
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
    # the reduced hybrid serve of phase 7b prefills 8 tokens
    ("S=8", (1, 8, 4, 32, 16), torch.float32, "zero", False, 2e-3),
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
# the training phase: launch.train's flags at full width, then the churn
# of the last three iterations
TRAIN_ARGS = ["--arch", "gwtf-llama-300m", "--mode", "gwtf", "--stages", "4",
              "--relays-per-stage", "3", "--capacity", "4", "--data-nodes", "2",
              "--microbatches", "4", "--batch", "4", "--seq-len", "512",
              "--churn", "0.0", "--lr", "1e-3", "--seed", "0", "--device", "cuda"]
TRAIN_ITERS, TRAIN_CHURN = 3, 0.1
# three reduced f32 iterations on cuda against the cpu: each iteration's
# loss within its TRAIN_LOSS_RTOL (the second and third hang on the
# updates); the AdamW moments after the first and the third iteration,
# linear in the aggregated gradients, within TRAIN_MOMENT_RTOL of each
# leaf's largest magnitude (they see the gradients' magnitudes); after the
# first, a parameter within TRAIN_PARAM_TOL, except where its gradient is
# so near 0 that its sign differs between the devices (AdamW's first step
# moves every weight by lr * sign(g), plus the decay), which at most
# TRAIN_FLIP_SHARE of them may do, each by at most 2 lr
TRAIN_LOSS_RTOL = (1e-4, 1e-3, 1e-3)
TRAIN_MOMENT_RTOL, TRAIN_PARAM_TOL, TRAIN_FLIP_SHARE = 1e-3, 1e-5, 1e-3
# phase 7b: the corpus scenario serve-churn-under-load, from the port's
# copy of the corpus
SERVE_CHURN = "serve-churn-under-load"
# phase 7: a full-width variant of it, not the corpus's traffic: prompt
# 512, as phase 4 prefills, and the profile of the model served.  The
# engine prices a prefill at prompt_len / (microbatch_size x seq_len)
# microbatch forwards a stage: at the corpus's 16 tokens a microbatch a
# 512-token prefill outlasts the 4 iterations and nothing decodes, so a
# microbatch holds 512 tokens here.  At this profile no chain crosses relay
# 5, so the crash moves to relay 2 at 0.5 of iteration 1, where the spike's
# 4 requests are 23 tokens into their decode.
SERVE_CHURN_FULL = dict(
    name="serve-churn-under-load, full-width variant",
    prompt_len=512, seq_len=512, model_layers=16, model_d=1024,
    model_vocab=32000,
    churn=[{"kind": "trace", "events": [[1, "crash", 2, 0.5]]}])
# phase 7b: the reduced scenario as each model, f32
SERVE_CHURN_MODELS = [{}, {"model": "hymba-1.5b", "model_d": 64}]
SERVE_COUNTERS = ("prefill_calls", "decode_dispatches", "stacked_rows",
                  "replay_steps")
# phase 8a: the corpus specs whose checks also run on the cpu, and the
# hybrid variant of the serving scenario swept beside the corpus
HARNESS_CPU_TOO = ("trace-crash-rejoin", "adversarial-corrupt", SERVE_CHURN)
HARNESS_HYBRID = (SERVE_CHURN, SERVE_CHURN_MODELS[1])
# phase 8b: full-width variants of corpus specs, so that the scenario
# generator's model_config gives gwtf-llama-300m at full width, in f32;
# each is (spec name, corpus spec, changes, checks run in this process)
FULL_WIDTH = dict(model_layers=16, model_d=1024, model_vocab=32000, seq_len=512)
HARNESS_FULL = [
    ("geo-zero-churn, full-width variant", "geo-zero-churn", {},
     ["sim-runtime"]),
    ("trace-crash-rejoin, full-width variant", "trace-crash-rejoin", {},
     ["sim-runtime"]),
    (SERVE_CHURN_FULL["name"], SERVE_CHURN, SERVE_CHURN_FULL,
     ["serving-invariants", "serving-consistency"]),
    (SERVE_CHURN_FULL["name"] + ", churn stripped", SERVE_CHURN,
     {**SERVE_CHURN_FULL, "churn": []},
     ["serving-invariants", "serving-consistency"])]
# run in a child with CUBLAS_WORKSPACE_CONFIG set (the zero-churn check's
# bit-equalities): every corpus spec zero-churn applies to, then this one
HARNESS_FULL_ZERO_CHURN = HARNESS_FULL[0][:3]


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


def reset_launches():
    ops.flash_attention.launches = 0
    ops.ssd_scan.launches = 0
    for body in fa.BODY_LAUNCHES:
        fa.BODY_LAUNCHES[body] = 0


def read_launches():
    return {"flash_attention": ops.flash_attention.launches,
            "ssd_scan": ops.ssd_scan.launches}


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
    reset_launches()                      # the main path starts here
    out = generate(model, cfg, prompt, gen=SERVE["gen"], window=None,
                   temperature=0.0, generator=g)
    launches = read_launches()
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


def profile_run(name: str, label: str, fn):
    """Run ``fn`` unprofiled once, then timed, then under
    ``torch.profiler``; print the wall time against the device busy time
    and the kernels that take the device's time.  The profiler's own cost
    inflates the profiled wall time; the unprofiled wall time of the same
    work is printed beside it."""
    fn()                                             # unprofiled
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    profiled(name, label, fn, (time.perf_counter() - t0) * 1e3)


def profiled(name: str, label: str, fn, wall=None,
             activities=(ProfilerActivity.CPU, ProfilerActivity.CUDA)):
    """Run ``fn`` once under ``torch.profiler``; print its profiled wall
    time (and ``wall``, the unprofiled time of the same work, if known)
    against the device busy time, and the kernels that take the device's
    time.  Leaving out the CPU's activity leaves out the host's operator
    events, which cost the profiler minutes over ~10^5 launches."""
    with profile(activities=list(activities)) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    unprofiled = "not taken" if wall is None else f"{wall:.2f} ms"
    print(f"{name} {label}: wall {unprofiled}, profiled {wall_prof:.2f} ms, "
          f"device busy {busy:.2f} ms in {launches} kernels "
          f"(idle share {1 - busy / wall_prof:.1%} of the profiled wall)")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    # the top six, then the port's own kernels wherever they rank
    for rank, e in enumerate(ranked):
        if rank < 6 or any(k in e.key for k in PORT_KERNELS):
            print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
                  f"({e.self_device_time_total / 1e3 / busy:.1%}) {e.key[:90]}")


def profile_serve(cfg, model, prompt, steps: int = 8):
    """Wall time against device busy time for one prefill and ``steps``
    greedy decode steps, and the kernels that take the device's time."""
    B, P = prompt.shape

    def do_prefill():
        cache = init_cache(cfg, B, P + steps, dtype=torch.float32,
                           device=prompt.device)
        return prefill(model, cfg, tokens=prompt, cache=cache)

    logits, cache = do_prefill()
    tok = logits.argmax(dim=-1)[:, None]

    def do_decode():
        for i in range(steps):
            decode_step(model, cfg, tokens=tok, cache=cache, index=P + i)

    profile_run(cfg.name, "prefill", do_prefill)
    profile_run(cfg.name, f"decode x{steps}", do_decode)


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


def check_counters(r, churn: float):
    """The trainer's invariants on one iteration's counters."""
    ok = (r.completed + r.dropped == r.launched
          and r.fwd_recomputes + r.bwd_replays == r.rerouted
          and r.requeued <= r.rerouted and r.completed > 0)
    if churn == 0:
        ok = ok and r.completed == r.launched and r.rerouted == 0
    if not ok:
        raise SystemExit(f"counters break the trainer's invariants: {r}")
    if not math.isfinite(r.loss):
        raise SystemExit(f"non-finite loss {r.loss}")


def phase_train():
    """Train at full width as the main path; returns each kernel's
    launches counted over exactly this run (0: neither is on the path)."""
    args = train.parser().parse_args(TRAIN_ARGS)
    t0 = time.perf_counter()
    trainer, shards = train.build_gwtf(args)
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    cfg = trainer.cfg
    print(f"== 6. train {cfg.name} full width, {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.param_dtype} params; "
          f"{args.stages} stages x {args.relays_per_stage} relays, capacity "
          f"{args.capacity}, {args.data_nodes} data nodes x {args.microbatches} "
          f"microbatches of {args.batch} x {args.seq_len} tokens")
    print(f"trainer built in {built_s:.1f}s (weights drawn on the host, moved "
          f"to the card)")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                      # the main path starts here

    def step(it: int, churn: float):
        trainer.churn_model = BernoulliChurn(churn)
        r, secs, tokens = train.train_iteration(trainer, shards)
        check_counters(r, churn)
        print(f"iter {it} churn {churn}: loss {r.loss:.4f}, completed "
              f"{r.completed}/{r.launched}, dropped {r.dropped}, rerouted "
              f"{r.rerouted} (requeued {r.requeued}, fwd recomputes "
              f"{r.fwd_recomputes}, bwd replays {r.bwd_replays}), "
              f"{secs * 1e3:.1f} ms, {tokens / secs:.0f} tok/s, store peak "
              f"{r.store_peak_bytes / 2**30:.2f} GiB")

    # the churn-0 iterations are profile_run's three runs: the first warms
    # up, the second is timed, the third runs under the profiler
    print("where the time goes (torch.profiler), iterations 0-2 at churn 0:")
    its = iter(range(TRAIN_ITERS))
    profile_run(cfg.name, "train iteration", lambda: step(next(its), 0.0))
    for it in range(TRAIN_ITERS, 2 * TRAIN_ITERS):
        step(it, TRAIN_CHURN)
    launches = read_launches()
    if any(launches.values()) or any(fa.BODY_LAUNCHES.values()):
        raise SystemExit(f"the training path launched kernels {launches}: its "
                         f"attention must be the differentiable plain path")
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {launches} (neither kernel is on the training path)")
    # the gradient screen (on only when the churn model corrupts gradients)
    # copies every per-microbatch gradient to the host: one stage's worth
    grads = trainer.stage_params[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flat = trainer._flatten_grads(grads)
    print(f"gradient screen: host copy of one stage's gradient tree "
          f"({flat.size / 1e6:.1f} M values, {flat.nbytes / 2**20:.0f} MiB as "
          f"f64) in {(time.perf_counter() - t0) * 1e3:.1f} ms")
    return launches


def _reduced_trainers(dtype: str, device: str, **kw):
    cfg = dataclasses.replace(get_config("gwtf-llama-300m").reduced(),
                              param_dtype=dtype)
    net = geo_distributed_network(
        num_stages=2, relay_capacities=[3] * 6, num_data_nodes=1,
        data_capacity=4, rng=np.random.default_rng(0))
    rt = RuntimeTrainer(cfg, net, lr=1e-3, seed=0, churn_model=TraceChurn([]),
                        device=device, **kw)
    mbs = DataNodeShard(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                   batch_size=8, microbatch_size=2, seed=0),
                        0, 1).microbatches()
    return cfg, rt, net.data_nodes()[0].id, mbs


def train_identities() -> int:
    """Churn 0 against ``CentralizedTrainer`` and fused against remat, bit
    for bit, reduced, under deterministic algorithms (run in a child with
    ``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts)."""
    torch.use_deterministic_algorithms(True)
    for dtype in ("float32", "bfloat16"):
        cfg, rt, dn, mbs = _reduced_trainers(dtype, "cuda")
        _, remat, _, _ = _reduced_trainers(dtype, "cuda", remat=True)
        cen = CentralizedTrainer(cfg, 2, lr=1e-3, seed=0, device="cuda")
        for it in range(3):
            a = rt.iteration({dn: mbs}).loss
            b = cen.iteration(mbs)
            c = remat.iteration({dn: mbs}).loss
            if not a == b == c:
                raise SystemExit(f"{dtype} iteration {it}: losses decentralized "
                                 f"{a!r}, centralized {b!r}, remat {c!r}")
        for name, other, theirs in (("centralized", cen, cen.head_params),
                                    ("remat", remat, remat.head_params[dn])):
            mine = leaves((rt.stage_params, rt.head_params[dn]))
            if not all(torch.equal(x, y) for x, y in
                       zip(mine, leaves((other.stage_params, theirs)))):
                raise SystemExit(f"{dtype}: parameters differ from {name}")
        print(f"{cfg.name} {dtype}: churn 0 = centralized = remat bit for bit "
              f"over 3 iterations (losses {rt.losses}), every parameter equal; "
              f"remat recomputes {remat.stages.remat_recompute_count}, fused "
              f"{rt.stages.remat_recompute_count}")
    return 0


def phase_train_checks():
    print("== 6b. training, reduced: bit-identities under deterministic "
          "algorithms (child process)")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--train-identities"], env=env, capture_output=True,
                          text=True, timeout=600)
    print(proc.stdout, end="")
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"bit-identity child exited {proc.returncode}")


def phase_train_vs_cpu():
    print("== 6c. training, reduced f32: three iterations on cuda against cpu")
    runs = {device: _reduced_trainers("float32", device)[1:]
            for device in ("cpu", "cuda")}
    (tc, dn, mbs), (tg, _, _) = runs["cpu"], runs["cuda"]
    lr = tg.opt.lr
    for it in range(len(TRAIN_LOSS_RTOL)):
        rc, rg = tc.iteration({dn: mbs}), tg.iteration({dn: mbs})
        for f in ("completed", "launched", "dropped", "rerouted", "requeued",
                  "fwd_recomputes", "bwd_replays", "wire_bytes"):
            if getattr(rc, f) != getattr(rg, f):
                raise SystemExit(f"iteration {it} {f}: cpu {getattr(rc, f)}, "
                                 f"cuda {getattr(rg, f)}")
        rel = abs(rg.loss - rc.loss) / abs(rc.loss)
        if rel > TRAIN_LOSS_RTOL[it]:
            raise SystemExit(f"iteration {it}: loss cpu {rc.loss!r}, cuda "
                             f"{rg.loss!r}")
        moments = moment_difference(tg, tc)
        print(f"iteration {it}: counters equal, loss cpu {rc.loss:.6f} cuda "
              f"{rg.loss:.6f} (rel {rel:.3g}, tol {TRAIN_LOSS_RTOL[it]}), "
              f"moments' largest difference {moments:.3g} of a leaf's largest "
              f"magnitude")
        if it in (0, len(TRAIN_LOSS_RTOL) - 1) and moments > TRAIN_MOMENT_RTOL:
            raise SystemExit(f"iteration {it}: AdamW moments differ by "
                             f"{moments:.3g} of a leaf's largest magnitude, "
                             f"tol {TRAIN_MOMENT_RTOL}")
        if it:
            continue
        worst, flipped, total = 0.0, 0, 0
        for g, c in zip(leaves((tg.stage_params, tg.head_params)),
                        leaves((tc.stage_params, tc.head_params))):
            d = (g.cpu() - c).abs()
            flipped += int((d > TRAIN_PARAM_TOL).sum())
            total += d.numel()
            worst = max(worst, float(d.max()))
        if flipped > TRAIN_FLIP_SHARE * total or worst > 2 * lr * (1 + 1e-3):
            raise SystemExit(f"parameters: {flipped} of {total} beyond "
                             f"{TRAIN_PARAM_TOL}, largest difference {worst:.3g}")
        print(f"iteration 0 parameters: {flipped} of {total} beyond "
              f"{TRAIN_PARAM_TOL} (allowed {TRAIN_FLIP_SHARE:.1%}), largest "
              f"difference {worst:.3g} (allowed 2 lr = {2 * lr:.3g})")
    print(f"moments held within {TRAIN_MOMENT_RTOL} after iterations 0 and "
          f"{len(TRAIN_LOSS_RTOL) - 1}")


def moment_difference(tg, tc) -> float:
    """The largest difference between two trainers' AdamW moments (every
    stage and head tree, m and v), each leaf's as a share of its largest
    magnitude on the second trainer."""
    worst = 0.0
    for og, oc in zip(tg.stage_opt + [tg.head_opt[k] for k in sorted(tg.head_opt)],
                      tc.stage_opt + [tc.head_opt[k] for k in sorted(tc.head_opt)]):
        for g, c in zip(leaves((og.m, og.v)), leaves((oc.m, oc.v))):
            diff, scale = float((g.cpu() - c).abs().max()), float(c.abs().max())
            if diff:
                worst = max(worst, diff / scale if scale else math.inf)
    return worst


def serving_trainer(spec: ScenarioSpec, cfg, **kw) -> ServeTrainer:
    """``scenarios.build_serving_runtime``'s construction, in its order (the
    network, the policy's RNG stream, the arrival program, the churn and
    the profile from the port's scenario helpers), with ``cfg`` in place of
    the reduced ``model_config(spec)``."""
    net, _ = scenarios.build_network(spec)
    net.kv_weight = spec.kv_weight
    rng = scenarios._rng(spec, scenarios._SALT_POLICY)
    policy = make_policy(spec.scheduler, net, rng=rng)
    return ServeTrainer(
        cfg, net, policy=policy,
        arrival_program=scenarios.compile_arrivals(spec),
        churn_model=scenarios.build_churn_model(spec, net),
        profile=scenarios.model_profile(spec),
        prompt_len=spec.prompt_len, gen_tokens=spec.gen_tokens,
        serve_batch=spec.serve_batch,
        tokens_per_mb=spec.microbatch_size * spec.seq_len,
        rng=rng, seed=spec.seed, **kw)


def check_serve_launches(label: str, tr: ServeTrainer, launches, body=None):
    """One flash launch per attention layer and one SSD launch per SSM
    layer of each prefill call (admissions and replays); decode launches
    neither.  ``body``: the flash body every launch must have run on."""
    cfg = tr.cfg
    want = {"flash_attention": cfg.num_layers * tr.prefill_calls
            if cfg.has_attention else 0,
            "ssd_scan": cfg.num_layers * tr.prefill_calls if cfg.has_ssm else 0}
    if launches != want:
        raise SystemExit(f"{label}: kernel launches {launches}, want {want} "
                         f"({tr.prefill_calls} prefill calls)")
    if body is not None and fa.BODY_LAUNCHES[body] != want["flash_attention"]:
        raise SystemExit(f"{label}: flash bodies {fa.BODY_LAUNCHES}, want "
                         f"every launch on {body}")


def time_dispatches(tr: ServeTrainer):
    """Wrap the trainer's three dispatch methods, on the instance, to record
    each call's wall ms (the device synchronized on both sides) with its
    rows (prefill, decode) or teacher-forced steps (replay)."""
    times = {"prefill": [], "decode": [], "replay": []}
    for method, key in (("_prefill_cohort", "prefill"),
                        ("_decode_cohort", "decode"),
                        ("_replay_cache", "replay")):
        fn = getattr(tr, method)

        def timed(arg, *rest, _fn=fn, _key=key):
            size = len(arg.stream) - 1 if _key == "replay" else len(arg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _fn(arg, *rest)
            torch.cuda.synchronize()
            times[_key].append(((time.perf_counter() - t0) * 1e3, size))
        setattr(tr, method, timed)
    return times


def spread(values) -> str:
    if not values:
        return "none"
    v = sorted(values)
    return (f"median {v[len(v) // 2]:.2f}, min {v[0]:.2f}, max {v[-1]:.2f} "
            f"over {len(v)}")


def phase_serve_churn():
    """Serve under churn at full width as the main path; returns each
    kernel's launches summed over the three runs, each counted from 0."""
    cfg = get_config("gwtf-llama-300m")
    spec = corpus.get_scenario(SERVE_CHURN).replace(**SERVE_CHURN_FULL)
    print(f"== 7. serve under churn: {cfg.name} full width ({cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, bf16 params, "
          f"f32 cache) through ServeTrainer on {spec.name}: {spec.num_stages} "
          f"stages x {spec.relays_per_stage} relays, {spec.iterations} "
          f"iterations, arrivals {spec.arrivals}, serve_batch "
          f"{spec.serve_batch}, prompt {spec.prompt_len}, {spec.gen_tokens} "
          f"tokens, {spec.microbatch_size * spec.seq_len} tokens a profile "
          f"microbatch, churn {spec.churn}")
    runs, shared = {}, None
    launches = {"flash_attention": 0, "ssd_scan": 0}
    for label, s, kw in (("defended", spec, {}),
                         ("calm", dataclasses.replace(spec, churn=[]), {}),
                         ("undefended", spec, {"reroute": False})):
        tr = serving_trainer(s, cfg, device="cuda", **kw)
        if shared is None:
            shared = (tr.params, tr._prompts)
        tr.params, tr._prompts = shared      # one model and prompt set
        times = time_dispatches(tr)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_launches()                     # the main path starts here
        walls, ms = [], []
        for _ in range(s.iterations):
            t0 = time.perf_counter()
            ms.append(tr.iteration())
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        got = read_launches()
        check_serve_launches(label, tr, got, body=fa.SM90_LIBRARY.name)
        for k in launches:
            launches[k] += got[k]
        done = [rid for rid, rec in tr.engine.requests.items()
                if rec.completion is not None]
        for rid in done:
            stream = tr.token_stream(rid)
            if len(stream) != s.gen_tokens or not all(
                    0 <= t < cfg.vocab_size for t in stream):
                raise SystemExit(f"{label}: request {rid} completed with "
                                 f"{len(stream)} tokens {stream[:8]}...")
        if not done:
            raise SystemExit(f"{label}: no request completed")
        # (kind, request, tokens decoded when it struck) for a requeue
        incidents = [(op[0], op[2], op[-1]) for tl in tr.engine.traces
                     for op in tl if op[0] in ("requeue", "requeue_wait",
                                               "restart")]
        if label == "defended" and not (
                any(kind == "requeue" and k > 0 for kind, _, k in incidents)
                and tr.replay_steps > 0):
            raise SystemExit(f"defended: no requeue mid-decode replayed "
                             f"(incidents {incidents}, replay steps "
                             f"{tr.replay_steps})")
        counters = {c: getattr(tr, c) for c in SERVE_COUNTERS}
        wall_s = sum(walls) / 1e3
        print(f"{label}: iterations {', '.join(f'{w:.1f}' for w in walls)} ms; "
              f"counters {counters}; {tr.stacked_rows} decoded rows in "
              f"{wall_s:.3f} s of wall, {tr.stacked_rows / wall_s:.1f} tok/s; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"({held / 2**30:.2f} GiB held when the run started); "
              f"launches {got}, flash bodies {dict(fa.BODY_LAUNCHES)}; "
              f"{len(done)} of {len(tr.engine.requests)} requests completed, "
              f"{s.gen_tokens} tokens each; incidents {incidents}")
        for key, unit in (("prefill", "rows"), ("decode", "rows"),
                          ("replay", "teacher-forced steps")):
            by_size = {}
            for t, n in times[key]:
                by_size.setdefault(n, []).append(t)
            print(f"  {key} calls, wall ms by {unit}: " + "; ".join(
                f"{n}: {spread(v)}" for n, v in sorted(by_size.items())))
        print(f"  summary (simulated seconds): {summarize_serving(ms)}")
        runs[label] = tr
    calm = runs["calm"]
    for label in ("defended", "undefended"):
        same = total = 0
        for rid in calm.engine.requests:
            a, b = runs[label].token_stream(rid), calm.token_stream(rid)
            same += sum(x == y for x, y in zip(a, b))
            total += min(len(a), len(b))
        print(f"{label} streams against calm: {same} of {total} tokens equal "
              f"(bf16 params; reported, not required)")
    # the crash iteration again, under the profiler, in a repeat of the
    # defended run
    tr = serving_trainer(spec, cfg, device="cuda")
    tr.params, tr._prompts = shared
    crash_it = spec.churn[0]["events"][0][0]
    for _ in range(crash_it):
        tr.iteration()
    torch.cuda.synchronize()
    print("where the time goes (torch.profiler), the crash iteration:")
    profiled(cfg.name, f"serve iteration {crash_it} (crash)", tr.iteration,
             activities=[ProfilerActivity.CUDA])
    return launches


def phase_serve_churn_vs_cpu():
    """The reduced scenario on cuda against the cpu; returns each kernel's
    launches summed over the cuda runs, each counted from 0."""
    print("== 7b. serve under churn, reduced f32: cuda against cpu")
    launches = {"flash_attention": 0, "ssd_scan": 0}
    for over in SERVE_CHURN_MODELS:
        spec = corpus.get_scenario(SERVE_CHURN).replace(**over)
        runs = {}
        for device in ("cpu", "cuda"):
            for label, s in (("defended", spec),
                             ("calm", dataclasses.replace(spec, churn=[]))):
                tr = scenarios.build_serving_runtime(s, device=device)
                # drawn on the CPU both times: one model on both devices
                model, prompts, _ = serving_inputs(
                    tr.cfg, seed=s.seed, batch=tr.max_requests,
                    prompt_len=s.prompt_len, device="cpu")
                tr.params, tr._prompts = model.to(device), prompts.to(device)
                reset_launches()
                ms = tr.run(s.iterations)
                if device == "cuda":
                    got = read_launches()
                    check_serve_launches(f"{spec.model} {label}", tr, got)
                    for k in launches:
                        launches[k] += got[k]
                runs[device, label] = (tr, ms)
        for label in ("defended", "calm"):
            (tc, mc), (tg, mg) = runs["cpu", label], runs["cuda", label]
            checks = {
                "ledgers": [dataclasses.asdict(m) for m in mc]
                == [dataclasses.asdict(m) for m in mg],
                "summaries": ([summarize_serving([m]) for m in mc]
                              == [summarize_serving([m]) for m in mg]),
                "chain plans": tc.engine.chain_plans == tg.engine.chain_plans,
                "timelines": ([vars(r) for r in tc.timeline.records]
                              == [vars(r) for r in tg.timeline.records]),
                "counters": all(getattr(tc, c) == getattr(tg, c)
                                for c in SERVE_COUNTERS),
                "streams": all(tc.token_stream(r) == tg.token_stream(r)
                               for r in tc.engine.requests)}
            failed = [k for k, ok in checks.items() if not ok]
            if failed:
                raise SystemExit(f"{spec.model} {label}: cuda and cpu differ "
                                 f"in {failed}")
        for device in ("cpu", "cuda"):
            (td, _), (tcalm, _) = runs[device, "defended"], runs[device, "calm"]
            for rid in tcalm.engine.requests:
                a, b = td.token_stream(rid), tcalm.token_stream(rid)
                if a[:len(b)] != b[:len(a)]:
                    raise SystemExit(f"{spec.model} on {device}: request {rid} "
                                     f"defended stream left the calm one")
        td = runs["cuda", "defended"][0]
        ks = [op[5] for tl in td.engine.traces for op in tl if op[0] == "requeue"]
        if not (ks and all(k > 0 for k in ks) and td.replay_steps > 0):
            raise SystemExit(f"{spec.model}: requeue prefixes {ks}, replay "
                             f"steps {td.replay_steps}")
        print(f"{spec.model} ({td.cfg.num_layers} layers, d_model "
              f"{td.cfg.d_model}, f32): defended and calm, cuda = cpu in "
              f"ledgers, summaries, chain plans, timelines, counters "
              f"{ {c: getattr(td, c) for c in SERVE_COUNTERS} } and "
              f"{len(td.engine.requests)} streams; defended streams = calm "
              f"on both; requeued at tokens {ks}")
    print(f"launches over the cuda runs {launches}, one per layer of each "
          f"prefill call")
    return launches


@contextlib.contextmanager
def recorded_builders():
    """Wrap, for the block, the port's scenario builders that the harness
    calls (``generate.build_runtime``, ``generate.build_serving_runtime``)
    to record every trainer they build; each trainer's ``walls`` gets the
    wall ms of each iteration (the device synchronized on both sides) and a
    training runtime's ``results`` each ``IterationResult``."""
    built = {"runtime": [], "serving": []}
    real = {"runtime": scenarios.build_runtime,
            "serving": scenarios.build_serving_runtime}

    def timed(tr):
        tr.walls, tr.results, step = [], [], tr.iteration

        def iteration(*args):
            sync = tr.device.type == "cuda"
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args)
            if sync:
                torch.cuda.synchronize()
            tr.walls.append((time.perf_counter() - t0) * 1e3)
            tr.results.append(out)
            return out
        tr.iteration = iteration

    def build_runtime(spec, **kw):
        tr, batches = real["runtime"](spec, **kw)
        timed(tr)
        built["runtime"].append(tr)
        return tr, batches

    def build_serving_runtime(spec, **kw):
        tr = real["serving"](spec, **kw)
        timed(tr)
        built["serving"].append(tr)
        return tr

    scenarios.build_runtime = build_runtime
    scenarios.build_serving_runtime = build_serving_runtime
    try:
        yield built
    finally:
        scenarios.build_runtime = real["runtime"]
        scenarios.build_serving_runtime = real["serving"]


@contextlib.contextmanager
def serving_inputs_drawn_on_cpu():
    """For the block, ``serving_inputs`` draws the model and prompts on the
    CPU and moves them to the device asked for, so that a serving check
    on cuda and on cpu runs one model (drawn on the card, the draws
    differ)."""
    real = serving.serving_inputs

    def drawn(cfg, *, seed, batch, prompt_len, device="cuda"):
        model, prompt, _ = real(cfg, seed=seed, batch=batch,
                                prompt_len=prompt_len, device="cpu")
        return model.to(device), prompt.to(device), None

    serving.serving_inputs = drawn
    try:
        yield
    finally:
        serving.serving_inputs = real


def harness_launches(spec, name: str, out) -> dict:
    """The kernel launches a check must make: one flash launch per
    attention layer and one SSD launch per SSM layer of each prefill call
    of the serving check (the ServeTrainer's and the standalone decode's);
    none elsewhere (training attends through ``_online_attention``)."""
    calls = (out["prefill_calls"] + out["streams_checked"]
             if name == "serving-consistency" else 0)
    cfg = scenarios.model_config(spec)
    return {"flash_attention": cfg.num_layers * calls if cfg.has_attention else 0,
            "ssd_scan": cfg.num_layers * calls if cfg.has_ssm else 0}


def run_harness(spec, checks, device="cuda", launches=None, details=False):
    """``harness.run_checks`` one check at a time on ``device``; returns
    ``(results, {check: seconds}, recorded trainers)``.  On cuda each
    check's kernel launches are counted from 0, held to
    ``harness_launches`` (every flash launch on the f32 body: the
    scenario models are f32) and added to ``launches``; ``details``
    prints each check's wall ms per runtime iteration and peak memory."""
    results, secs = {}, {}
    with recorded_builders() as built:
        for name in checks:
            before = {k: len(v) for k, v in built.items()}
            if device == "cuda":
                # trainers an earlier check dropped may sit in reference
                # cycles (the recorder's wrapper is one): free them first
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
            reset_launches()
            t0 = time.perf_counter()
            results.update(harness.run_checks(spec, [name], device=device))
            secs[name] = time.perf_counter() - t0
            if device != "cuda":
                continue
            got, want = read_launches(), harness_launches(spec, name,
                                                         results[name])
            f32 = fa.BODY_LAUNCHES[fa.LIBRARY.name]
            if got != want or f32 != want["flash_attention"]:
                raise SystemExit(f"{spec.name} {name}: kernel launches {got} "
                                 f"(f32 body {f32}), want {want}")
            for k in launches:
                launches[k] += got[k]
            if details:
                walls = [w for kind in built
                         for tr in built[kind][before[kind]:] for w in tr.walls]
                print(f"  {name}: {secs[name]:.1f} s, wall ms a runtime "
                      f"iteration {spread(walls)}, peak memory "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                      f"({held / 2**30:.2f} GiB held when it started), "
                      f"launches {got}; {summary(results[name])}")
    return results, secs, built


def summary(out: dict) -> str:
    """A check's result without the serving summary's columns."""
    return str({k: v for k, v in out.items() if k != "summary"})


def same_harness_runs(label: str, cpu, gpu):
    """The same checks on cpu and on cuda: results, chain plans, timelines,
    counters and streams equal, losses within ``TRAIN_LOSS_RTOL``."""
    (rc, _, bc), (rg, _, bg) = cpu, gpu
    if rc != rg:
        raise SystemExit(f"{label}: results differ, cpu {rc}, cuda {rg}")
    worst = 0.0
    for tc, tg in zip(bc["runtime"], bg["runtime"]):
        if getattr(tc.policy, "plans", None) != getattr(tg.policy, "plans",
                                                         None):
            raise SystemExit(f"{label}: chain plans differ")
        if [vars(r) for r in tc.timeline.records] != [
                vars(r) for r in tg.timeline.records]:
            raise SystemExit(f"{label}: fault timelines differ")
        for it, (a, b) in enumerate(zip(tc.results, tg.results)):
            if {**vars(a), "loss": 0} != {**vars(b), "loss": 0}:
                raise SystemExit(f"{label} iteration {it}: counters differ, "
                                 f"cpu {a}, cuda {b}")
            rel = abs(b.loss - a.loss) / abs(a.loss)
            worst = max(worst, rel)
            if rel > TRAIN_LOSS_RTOL[min(it, len(TRAIN_LOSS_RTOL) - 1)]:
                raise SystemExit(f"{label} iteration {it}: loss cpu "
                                 f"{a.loss!r}, cuda {b.loss!r}")
    for tc, tg in zip(bc["serving"], bg["serving"]):
        if not (tc.engine.chain_plans == tg.engine.chain_plans
                and tc.engine.traces == tg.engine.traces
                and [vars(r) for r in tc.timeline.records]
                == [vars(r) for r in tg.timeline.records]
                and all(getattr(tc, c) == getattr(tg, c)
                        for c in SERVE_COUNTERS)
                and all(tc.token_stream(r) == tg.token_stream(r)
                        for r in tc.engine.requests)):
            raise SystemExit(f"{label}: the serving runs differ")
    if len(bc["runtime"]) != len(bg["runtime"]) or len(bc["serving"]) != len(
            bg["serving"]):
        raise SystemExit(f"{label}: trainers built differ")
    return worst


def harness_specs():
    """The standard corpus, then the hybrid variant of the serving
    scenario, each with its applicable checks (zero-churn runs apart)."""
    specs = list(corpus.load_corpus())
    name, over = HARNESS_HYBRID
    specs.append(corpus.get_scenario(name).replace(
        name=f"{name}, {over['model']} variant", **over))
    return [(s, [c for c, (_, ok) in harness.CHECKS.items()
                 if ok(s) and c != "zero-churn"]) for s in specs]


def phase_harness():
    """The harness over the reduced corpus on cuda (8a), then full-width
    variants (8b); returns each kernel's launches over the phase."""
    print("== 8a. the scenario harness over the reduced corpus on cuda "
          "(models drawn on the cpu)")
    launches = {"flash_attention": 0, "ssd_scan": 0}
    with serving_inputs_drawn_on_cpu():
        for spec, checks in harness_specs():
            gpu = run_harness(spec, checks, "cuda", launches)
            line = ", ".join(f"{c} {t:.2f} s" for c, t in gpu[1].items())
            if spec.name.split(",")[0] in HARNESS_CPU_TOO:
                worst = same_harness_runs(spec.name, run_harness(
                    spec, checks, "cpu"), gpu)
                line += (f"; cuda = cpu (results, plans, timelines, counters,"
                         f" streams; losses within {worst:.3g})")
            print(f"{spec.name}: {line}")
    zero_churn_child()
    print("== 8b. the scenario harness at full width (gwtf-llama-300m, "
          "f32) on cuda")
    for name, base, over, checks in HARNESS_FULL:
        spec = corpus.get_scenario(base).replace(**{**FULL_WIDTH, **over,
                                                    "name": name})
        print(f"{spec.name}: {spec.num_stages} stages x "
              f"{spec.relays_per_stage} relays, {spec.num_data_nodes} data "
              f"nodes, {spec.microbatches} microbatches of "
              f"{spec.microbatch_size} x {spec.seq_len}, churn {spec.churn}")
        run_harness(spec, checks, "cuda", launches, details=True)
        torch.cuda.empty_cache()
    print(f"launches over phase 8 {launches}, one per layer of each "
          f"prefill call, all on the f32 body")
    return launches


def zero_churn_child():
    print("-- zero-churn in a child with CUBLAS_WORKSPACE_CONFIG=:4096:8")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--harness-zero-churn"], env=env,
                          capture_output=True, text=True, timeout=600)
    print(proc.stdout, end="")
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"zero-churn child exited {proc.returncode}")


def harness_zero_churn() -> int:
    """``check_zero_churn`` (its bit-equalities) on every corpus spec it
    applies to, then on the full-width variant of ``geo-zero-churn``."""
    launches = {"flash_attention": 0, "ssd_scan": 0}
    for spec in corpus.load_corpus():
        if harness.CHECKS["zero-churn"][1](spec):
            _, secs, _ = run_harness(spec, ["zero-churn"], "cuda", launches)
            print(f"{spec.name}: zero-churn {secs['zero-churn']:.2f} s")
    name, base, over = HARNESS_FULL_ZERO_CHURN
    spec = corpus.get_scenario(base).replace(**{**FULL_WIDTH, **over,
                                                "name": name})
    print(f"{spec.name}:")
    run_harness(spec, ["zero-churn"], "cuda", launches, details=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-identities", action="store_true",
                    help="run only phase 6b's bit-identity checks (the child "
                         "process phase 6b starts)")
    ap.add_argument("--harness-zero-churn", action="store_true",
                    help="run only phase 8's zero-churn checks (the child "
                         "process phase 8a starts)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 1
    # f32 results are compared below: keep f32 products in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if opts.train_identities:
        return train_identities()
    if opts.harness_zero_churn:
        return harness_zero_churn()

    start = time.perf_counter()

    def took(phases: str):
        print(f"[phases {phases} done, {time.perf_counter() - start:.1f} s "
              f"into the script]")

    phase_device()
    flash_timings = phase_kernel()
    ssd_timings = phase_ssd_kernel()
    took("1-3")

    # each serve is one main path, counted from 0 with its model alone
    # on the card; the kernels line reports their sums
    launches = {"flash_attention": 0, "ssd_scan": 0}
    for arch in SERVE_ARCHS:
        for name, n in run_serve(arch).items():
            launches[name] += n
        torch.cuda.empty_cache()

    phase_gpu_vs_cpu()
    took("4-5")

    # training launches neither kernel; its counts are checked in the phase
    phase_train()
    torch.cuda.empty_cache()
    phase_train_checks()
    phase_train_vs_cpu()
    took("6-6c")

    # serving under churn: each run a main path counted from 0
    torch.cuda.empty_cache()
    for phase in (phase_serve_churn, phase_serve_churn_vs_cpu):
        for name, n in phase().items():
            launches[name] += n
    took("7-7b")

    # the scenario harness: every check's launches counted from 0
    torch.cuda.empty_cache()
    for name, n in phase_harness().items():
        launches[name] += n
    took("8a-8b")

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
