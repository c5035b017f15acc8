#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

from the root of a checkout.  It builds the hand-written CUDA kernels
from the checkout's sources (one nvcc per kernel, started together) and
stops with a non-zero exit at the first phase that fails:

1. device: the card's name and power limit, torch and CUDA versions, each
   kernel's build time and ptxas register and spill lines, and the TF32
   ``HMMA`` instructions of each f32 flash instantiation in the built
   library's SASS (``cuobjdump -sass``; none fails the phase);
2. the flash-attention kernel against its plain PyTorch version on the
   card, at the serving shapes of phase 4's twelve models (head_dim 64,
   128 and, for ``gemma-7b``, 256), the cohorts of 1, 3 and 4 rows that
   phase 7 prefills in bf16 and phase 8b in f32, and at f32, ragged, GQA,
   windowed, non-causal, S = 8 and D = 256 shapes, each with the body it ran
   (bf16 ``wgmma``, ``flash_attention_sm90.cu``; f32 3xTF32 ``mma.sync``,
   ``flash_attention.cu``; both on the tensor cores), the median time of
   a single call (CUDA events, the host's enqueue inside), the plain
   version's, the time of ``scaled_dot_product_attention`` (a yardstick
   the port never calls) and the least time the card could take (for f32
   at both the CUDA cores' rate and 3xTF32's), then the device time per
   call of the kernel, the plain version and SDPA (calls queued back to
   back between CUDA events, the host's enqueue left out); then, untimed,
   the f32 body over ``F32_SWEEP``'s edges (lengths, windows, GQA);
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
   flash; 3b. the fused AdamW kernel (``adamw.cu``, two launches a tree)
   against its plain version (``ops.adamw_update_plain``) on the same
   inputs at the training cells' trees (``ADAMW_CELLS``: the 7B cell's two
   stages of 4 StarCoder2-7B layers and its head, the GPT-like cells' four
   stages and two heads, the Moonlight cell's two stages, the dense layer
   and 2 MoE layers then 2 MoE layers, and its head; each stage tree of
   other shapes on its own), clipped and divided by 4 microbatches: the
   parameters within ``ADAMW_PARAM_ULPS`` ulp, the moments within
   ``ADAMW_MOMENT_RTOL`` of each leaf's largest, one launch counted a
   tree; each tree's device time, a single call's, the plain version's and
   the byte bound (24 B a bf16 parameter at 3.35 TB/s), and each cell's
   sums; 3c. the split-KV decode attention (``decode_attention.cu``, two
   launches a call) against its plain version (``ops.decode_attention_plain``)
   at the serve cells' shapes (``DECODE_CASES``: StarCoder2-7B's 36/4 heads
   of 128, bf16 q, f32 cache, 64 rows at 1,056 live slots of 1,088 and 32
   rows at 4,064 of 4,096, the middle of each cell's 64 steps): each
   output within one bf16 ulp at its row's magnitude, one launch counted a
   call, the splits the plan picked, the kernel's device time, a single
   call's, the plain version's and the byte bound (the live K and V read
   once at 3.35 TB/s); 3d. training's flash pair
   (``ops.flash_attention_train``: the sm90 forward writing its
   log-sum-exp, then ``flash_attention_bwd_sm90.cu``'s three launches) at
   the training cells' shapes (``TRAIN_ATTENTION_CASES``: the GPT-like
   8 x 1,024 of 16 heads of 64, the 7B cell's 2 x 512 of 36/4 heads of
   128 in its 4,096 window): the output and dQ, dK, dV against autograd of
   ``layers._online_attention`` (relative RMS error), the pair's device
   time (forward and backward, and the backward alone), a single call's,
   ``_online_attention``'s forward and backward, and the bound: 13
   products a causal pair at 989 TFLOP/s (Q Kᵀ and P V forward; S, dP,
   dV, and dS's three terms into dK and dQ backward), against the bytes
   (q, k, v, o, dO once, dQ, dK, dV once) at 3.35 TB/s;
4. ``gwtf-llama-300m``, ``tinyllama-1.1b``, ``mamba2-130m``,
   ``hymba-1.5b``, ``qwen1.5-4b``, ``starcoder2-7b``, ``gwtf-llama-7b``,
   ``gemma-7b`` (head_dim 256), ``granite-moe-3b-a800m``,
   ``qwen2-moe-a2.7b`` (dense experts, as JAX serves), ``musicgen-medium``
   (from stub frame embeddings) and ``llama-3.2-vision-90b`` (stub patch
   embeddings at every step; cut in depth to ``SERVE_LAYERS``) served at
   full width (bf16 params, f32 cache, batch 8, prompt 512, 32 greedy
   tokens) through ``repro_torch.launch.serve.generate``, one model on the
   card at a time, each kernel's launches counted over exactly each serve
   (the main path) and held to one per self-attention or SSM layer of the
   prefill (none from cross-attention), every flash launch on the bf16
   tensor-core body, the decode attention kernel once per self-attention
   layer of each decode step, then where the time goes: wall time, device busy
   time, the top kernels and the port's own kernels (each with its share
   of the busy time) of one prefill and of 8 decode steps, from
   ``torch.profiler`` (the MoE models' with the device's activity only),
   and for the VLM the share of the decode's busy time that the vision
   projection and the cross K/V, recomputed at every step, take;
5. the port on the GPU against the port on the CPU, reduced f32 models of
   every served config, a ``gemma-7b`` variant that keeps head_dim 256 and
   a VLM of two superblocks with its gates set nonzero, on the same
   weights and stub inputs: logits within 1e-3, greedy streams equal, one
   launch per self-attention layer on the f32 body and one decode
   attention launch per self-attention layer of each decode step;
6. training, the port's second main path: ``gwtf-llama-300m`` at full
   width (16 layers, bf16 params) through ``repro_torch.launch.train``'s
   ``build_gwtf`` and ``train_iteration``, 4 stages x 3 relays of capacity
   4, 2 data nodes with 4 microbatches of 4 sequences of 512 tokens each,
   3 iterations at churn 0 (a warm-up, one timed, one under
   ``torch.profiler``: device busy time, idle share, top kernels) and 3 at
   churn 0.1, each with its loss, completed/launched/dropped/rerouted, wall ms
   and tokens/s, the trainer's counter invariants held, every loss
   finite, and the kernels' launches counted over the run (the training
   path attends through the flash pair: the forward once a layer of each
   stage forward, the backward once a layer of each stage backward;
   AdamW's kernel updates each stage and head tree once an iteration);
   the peak memory, and the
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
   after the first as stated at ``TRAIN_PARAM_TOL``; 6d. the paper's 7B
   model (``gwtf-llama-7b``) at full width, cut in depth to
   ``TRAIN_7B_LAYERS`` layers, through ``launch.train``'s ``build_gwtf``
   over 2 stages for ``TRAIN_7B_ITERS`` iterations: loss, counters, ms,
   tokens/s, peak memory;
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
9. the port's examples (``EXAMPLES``), in this process on cuda and then on
   the cpu: each exits, prints finite numbers and, around them, the same
   report on both devices (flows, counters, plans, token ids), its numbers
   within ``EXAMPLE_RTOL``; ``torch_serve_decode``'s flash launches on
   cuda held to one per layer of its prefill;
10. single-program training, the port's fifth main path: ``launch.train
    --mode spmd`` (``SPMD_ARGS``) trains ``gwtf-llama-300m`` at full width
    through ``build_spmd`` and ``spmd_step``, each step's loss (finite),
    ms and tokens/s, the last three steps as ``profile_run``'s (one under
    ``torch.profiler``), peak memory, the flash pair launched once a layer
    a step (the tensors are plain without a mesh) and AdamW's once a step;
    10b. reduced f32
    VLM (with vision, nonzero gates), audio (frame embeddings) and MoE
    models through ``make_train_step`` on cuda against the cpu, each
    step's loss within ``TRAIN_LOSS_RTOL``;
11. the multi-device launch layer, in children started together:
    11a. ``python -m repro_torch.launch.dryrun`` at full width for
    ``DRYRUN_CASES`` (``gemma_7b`` train_4k, ``qwen2_moe_a2_7b``
    prefill_32k and ``qwen1_5_4b`` decode_32k, KV heads padded 20 -> 32, on
    16 x 16; ``llama3_2_vision_90b`` decode_32k and ``hymba_1_5b``
    long_500k on 2 x 16 x 16), each on a fake process group of 256 or 512
    ranks over fake tensors on a ``cuda`` mesh (nothing allocated, the
    card untouched): seconds, per-device dot FLOPs, "x ideal" (dot FLOPs
    x devices over the unsharded step's FLOPs: how many devices repeat
    each product), collective bytes by kind, per-device memory and the
    analytic memory against 80 GB; any exception (an op DTensor refuses
    raises) fails the phase, and so does an "x ideal" above
    ``DRYRUN_X_IDEAL``'s bound for its combination; 11b. phase 10's step (``SPMD_ARGS``) without a mesh
    and through ``make_train_step(mesh=make_host_mesh(), rules=
    ShardingRules())`` on an NCCL group of world size 1, parameters and
    AdamW state DTensors on the (1, 1) mesh, both under deterministic
    algorithms, both updating through AdamW's kernel (the sharded step on
    its DTensors' local shards, once a step each): losses, every parameter
    and AdamW leaf bit for bit equal
    (or, failing that, within ``SHARDED_TOL``, the largest difference
    printed), each step's ms beside phase 10's losses;
12. a JSON line of the kernels, then the card, then the result line.

It needs no network and exits non-zero, printing no result, without a
GPU or outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import io
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
                                              serving_aux_inputs,
                                              serving_inputs)
from repro_torch.core.runtime import cache as train_cache  # noqa: E402
from repro_torch.core.runtime import serving  # noqa: E402
from repro_torch.core.runtime.stages import (init_head_params,  # noqa: E402
                                             init_stage_params, stage_bounds)
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
from repro_torch.kernels.build import toolkit_program  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels.ref import ssd_reference  # noqa: E402
from repro_torch.kernels.timing import (card_line, device_ms,  # noqa: E402
                                        median_ms, show)
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.transformer import (decode_step, init_cache,  # noqa: E402
                                            is_vlm, prefill, superblocks)
from repro_torch.optim.adamw import AdamW  # noqa: E402
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
    # the prefills of the dense and MoE serves that phase 4 adds; gemma-7b
    # is the one at D = 256
    ("serve gemma-7b D=256", (8, 512, 16, 16, 256), torch.bfloat16, True, None,
     2e-2),
    ("serve starcoder2-7b GQA 36/4", (8, 512, 36, 4, 128), torch.bfloat16, True,
     None, 2e-2),
    ("serve qwen1.5-4b", (8, 512, 20, 20, 128), torch.bfloat16, True, None, 2e-2),
    ("serve gwtf-llama-7b", (8, 512, 32, 32, 128), torch.bfloat16, True, None,
     2e-2),
    ("serve granite-moe-3b-a800m GQA 24/8", (8, 512, 24, 8, 64), torch.bfloat16,
     True, None, 2e-2),
    ("serve qwen2-moe-a2.7b", (8, 512, 16, 16, 128), torch.bfloat16, True, None,
     2e-2),
    # D = 256 on the f32 body (phase 5's head_dim-256 variant), and ragged
    # with a window and GQA on the bf16 body
    ("f32 S=256 D=256", (2, 256, 8, 8, 256), torch.float32, True, None, 2e-4),
    ("bf16 D=256 GQA 8/2 window 32 ragged S=200", (2, 200, 8, 2, 256),
     torch.bfloat16, True, 32, 2e-2),
    # the f32 body at a full card (B*H = 128), and ragged with a window
    # and GQA at D = 128 and 256, through its mma tiles
    ("f32 B=8 S=512", (8, 512, 16, 16, 64), torch.float32, True, None, 2e-4),
    ("f32 D=128 GQA 8/2 window 32 ragged S=200", (2, 200, 8, 2, 128),
     torch.float32, True, 32, 2e-4),
    ("f32 D=256 GQA 8/2 window 32 ragged S=200", (2, 200, 8, 2, 256),
     torch.float32, True, 32, 2e-4),
    # the self-attention of the audio and VLM prefills that phase 4 adds
    ("serve musicgen-medium", (8, 512, 24, 24, 64), torch.bfloat16, True, None,
     2e-2),
    ("serve llama-3.2-vision-90b GQA 64/8", (8, 512, 64, 8, 128), torch.bfloat16,
     True, None, 2e-2),
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
# phase 3b: the fused AdamW kernel at the training cells' trees, (arch,
# layers, stages, data nodes): sc2-7b-8l-train-calm's, the gpt300m cells' and
# moonlight-5l-train-calm's stage and head trees (Moonlight's two stages
# differ: 25 leaves, 4-D expert leaves, an f32 router and choice bias; then
# 15), clipped, each update's gradients divided by the
# cells' 4 microbatches; parameters held to ADAMW_PARAM_ULPS ulp of their
# dtype at the operands' magnitude, m and v to ADAMW_MOMENT_RTOL of each
# leaf's largest (the kernel sums the clip norm in another order)
ADAMW_CELLS = [("starcoder2-7b", 8, 2, 1), ("gwtf-gpt-300m", 16, 4, 2),
               ("moonlight-16b-a3b", 5, 2, 1)]
ADAMW_HYPER = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                   grad_clip=1.0, divisor=4)
ADAMW_PARAM_ULPS, ADAMW_MOMENT_RTOL = 1, 1e-6
# phase 3c: the serve cells' decode attention at the middle of their 64
# steps: name, (B, C, kv_valid, H, KH, hd); bf16 q, f32 cache
# phase 3d: the training cells' attention, (B, S, H, KH, D, window)
TRAIN_ATTENTION_CASES = [("gpt300m-train", (8, 1024, 16, 16, 64, None)),
                         ("sc2-7b-8l-train", (2, 512, 36, 4, 128, 4096))]
# products of 2 D flops a causal pair that the pair computes: Q K^T and P V
# forward; S and dP in each of the two backward kernels, dV, and dS's
# three bf16 terms into dK and into dQ
TRAIN_ATTENTION_PRODUCTS = 2 + 2 * 2 + 1 + 2 * 3
DECODE_CASES = [("sc2-7b-8l-serve-decode", (64, 1088, 1056, 36, 4, 128)),
                ("sc2-7b-8l-serve-long", (32, 4096, 4064, 36, 4, 128))]
# phase 2's sweep of the f32 body's edges, untimed, each held at 2e-4
# against the plain version: every D, lengths that end inside a warp's 16
# rows and inside a KV tile, causal or not, windows from 1 key to more than
# a block, MHA and GQA 4:1
F32_SWEEP = dict(D=(64, 128, 256), S=(1, 7, 16, 33, 100, 257),
                 causal=(True, False), window=(None, 1, 5, 32, 100),
                 heads=((4, 4), (4, 1)))
SSD_SEQUENTIAL_CASE = ("sequential oracle", (1, 96, 2, 16, 8), torch.float32,
                       "random", False, 2e-3)
BODY_NAMES = {"flash_attention_sm90": "tensor-core bf16 (flash_attention_sm90.cu)",
              "flash_attention": "tensor-core f32 3xTF32 (flash_attention.cu)"}
PORT_KERNELS = ("flash_fwd_sm90_kernel", "flash_fwd_kernel", "ssd_cb_kernel",
                "ssd_scan_tf32_kernel")
SERVE = dict(batch=8, prompt_len=512, gen=32)
PROFILE_ALL = (ProfilerActivity.CPU, ProfilerActivity.CUDA)
# a prefill launches the flash kernel once per attention layer and the SSD
# kernel once per SSM layer; decode launches neither
SERVE_ARCHS = ["gwtf-llama-300m", "tinyllama-1.1b", "mamba2-130m", "hymba-1.5b",
               "qwen1.5-4b", "starcoder2-7b", "gwtf-llama-7b", "gemma-7b",
               "granite-moe-3b-a800m", "qwen2-moe-a2.7b", "musicgen-medium",
               "llama-3.2-vision-90b"]
# served at full width but cut in depth: all 100 layers of the VLM (about
# 90 B params, 180 GB in bf16) fit no one card; 10 are 2 superblocks of one
# cross and 4 self layers (about 10.7 B params, 21.4 GB)
SERVE_LAYERS = {"llama-3.2-vision-90b": 10}
# phase 5: every served family reduced, f32, and a gemma-7b variant that
# keeps head_dim 256 (2 heads of 256 at d_model 512): the f32 D = 256 body
# inside a model
GPU_VS_CPU_ARCHS = ["gwtf-gpt-300m", "gwtf-llama-300m", "mamba2-130m",
                    "hymba-1.5b", "qwen1.5-4b", "starcoder2-7b",
                    "gwtf-llama-7b", "gemma-7b", "granite-moe-3b-a800m",
                    "qwen2-moe-a2.7b", "musicgen-medium"]
# the reduced VLM of phases 5 and 10b: two superblocks of (cross, self), each
# cross block's (gate_attn, gate_mlp) set off their initial 0, where tanh(0)
# = 0 would hide its cross-attention
VLM = "llama-3.2-vision-90b"
VLM_GATES = ((0.7, -0.4), (-0.3, 0.55))
# the training phase: launch.train's flags at full width, then the churn
# of the last three iterations
TRAIN_ARGS = ["--arch", "gwtf-llama-300m", "--mode", "gwtf", "--stages", "4",
              "--relays-per-stage", "3", "--capacity", "4", "--data-nodes", "2",
              "--microbatches", "4", "--batch", "4", "--seq-len", "512",
              "--churn", "0.0", "--lr", "1e-3", "--seed", "0", "--device", "cuda"]
TRAIN_ITERS, TRAIN_CHURN = 3, 0.1
# phase 6d: the paper's 7B model at full width (d_model 4096, d_ff 11008,
# vocab 32000, bf16), cut in depth only, to TRAIN_7B_LAYERS of its 32
# layers, over 2 stages; launch.train's flags set the rest
TRAIN_7B_LAYERS, TRAIN_7B_ITERS = 4, 2
TRAIN_7B_ARGS = ["--arch", "gwtf-llama-7b", "--mode", "gwtf", "--stages", "2",
                 "--relays-per-stage", "2", "--capacity", "2", "--data-nodes",
                 "1", "--microbatches", "2", "--batch", "2", "--seq-len", "512",
                 "--churn", "0.0", "--lr", "1e-3", "--seed", "0", "--device",
                 "cuda"]
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
# phase 9: the port's examples, run in this process on cuda and on the cpu,
# with the flash launches each makes on cuda (torch_serve_decode: one
# prefill of its 4 layers; the rest train in f32, which launches no
# attention kernel, and AdamW's once a tree an update)
EXAMPLES = [("torch_quickstart", [], 0),
            ("torch_decentralized_train",
             ["--iterations", "3", "--activation-codec", "int8"], 0),
            ("torch_serve_decode", [], 4),
            ("torch_scenario_tour", ["trace-crash-rejoin", "--runtime"], 0)]
# the examples' numbers on cuda against the cpu: losses as TRAIN_LOSS_RTOL's
# loosest
EXAMPLE_RTOL = max(TRAIN_LOSS_RTOL)
NUMBER = re.compile(r"(\d+\.\d+)")
# phase 10: --mode spmd at full width, launch.train's flags; 10b: a reduced
# VLM (with vision), audio (frame embeddings) and MoE model, TRAIN_LOSS_RTOL's
# steps on cuda against the cpu
SPMD_ARGS = ["--arch", "gwtf-llama-300m", "--mode", "spmd", "--batch", "4",
             "--seq-len", "512", "--steps", "5", "--lr", "1e-3", "--seed", "0",
             "--device", "cuda"]
SPMD_KINDS = (VLM, "musicgen-medium", "qwen2-moe-a2.7b")
# phase 11a: the dry run's combinations at full width, (arch, shape, on the
# 2x16x16 mesh); 11b: phase 10's step on a (1, 1) mesh of one NCCL rank,
# held bit for bit to the unsharded step, or, failing that, within
# SHARDED_TOL of it
DRYRUN_CASES = [("gemma_7b", "train_4k", False),
                ("qwen2_moe_a2_7b", "prefill_32k", False),
                ("qwen1_5_4b", "decode_32k", False),
                ("llama3_2_vision_90b", "decode_32k", True),
                ("hymba_1_5b", "long_500k", True)]
# the most "x ideal" each may read, just above what the steps read on
# NVIDIA H100 80GB HBM3, torch 2.11: 1.10 where nothing repeats (the first
# three read 1.0000, 1.0026 and 1.0000); llama3_2_vision_90b repeats its
# vision projection, whose weight has no model-axis dim, over the model
# axis as GSPMD does (2.968), hymba_1_5b its batch of 1 over the data axes
# (15.88).  With DTensor's own layouts the five read 3.55, 3.86, 12.26,
# 12.35 and 114.2.
DRYRUN_X_IDEAL = {"gemma_7b": 1.10, "qwen2_moe_a2_7b": 1.10,
                  "qwen1_5_4b": 1.10, "llama3_2_vision_90b": 3.3,
                  "hymba_1_5b": 17.5}
LAUNCH_TIMEOUT = 600
SHARDED_PORT = 29561
SHARDED_TOL = 2e-4


def attended_pairs(S: int, causal: bool, window) -> int:
    """(query, key) pairs the rows attend: what this input needs."""
    return sum((i + 1 if causal else S) - (max(0, i - window + 1) if window else 0)
               for i in range(S))


def bound(shape, dtype, causal, window, peak=None):
    """Least time for flash attention: q, k, v, o each moved once, and the
    attended pairs' Q K^T and P V at ``peak`` (the dtype's peak rate by
    default); returns (ms, "bytes" or "operations")."""
    B, S, H, KH, D = shape
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * B * S * H * D + 2 * B * S * KH * D) * elem   # q, o, k, v
    flops = 4 * D * attended_pairs(S, causal, window) * B * H   # QK^T and PV
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (peak or PEAK_FLOPS[dtype])
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
    tf32_hmma = sass_tf32_hmma(fa.LIBRARY)
    for kernel, (n, opcodes) in tf32_hmma.items():
        print(f"  sass: {kernel}: {n} TF32 HMMA ({', '.join(sorted(opcodes))})")
    if not tf32_hmma or not all(n for n, _ in tf32_hmma.values()):
        raise SystemExit(f"the f32 flash body issues no TF32 HMMA: {tf32_hmma}")


def sass_tf32_hmma(lib) -> dict:
    """{kernel: (TF32 HMMA instructions, the HMMA opcodes seen)} for each
    flash_fwd_kernel instantiation in the built library's SASS."""
    sass = subprocess.run([toolkit_program("cuobjdump"), "-sass", str(lib.path())],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    found, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            kernel = ptxas_kernel(name) if "flash_fwd_kernel" in name else None
            if kernel:
                found[kernel] = (0, set())
        elif kernel and "HMMA" in line:
            opcode = re.search(r"HMMA\S*", line).group(0)
            n, opcodes = found[kernel]
            found[kernel] = (n + ("TF32" in opcode), opcodes | {opcode})
    return found


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
        bounds = f"bound {bound_ms:.4f} ms by {bound_by}"
        if dtype == torch.float32:   # the CUDA cores' rate, then 3xTF32's
            tc_ms, tc_by = bound(shape, dtype, causal, window, PEAK_FLOPS_3XTF32)
            bounds += f" at f32, {tc_ms:.4f} ms by {tc_by} at 3xTF32"
        dev = dict(device_ms=device_ms(kernel, reps=20),
                   plain_device_ms=device_ms(plain, reps=5),
                   library_device_ms=device_ms(lib, reps=20))
        print(f"{name}: B={B} S={S} H={H} KH={KH} D={D} {dtype} causal={causal} "
              f"window={window} body {BODY_NAMES[ran[0]]} max_abs_err={err:.3g} "
              f"(tol {tol}) a single call: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (err {lib_err:.3g}), "
              f"{bounds}; device: kernel "
              f"{show(dev['device_ms'])}, plain {show(dev['plain_device_ms'])}, "
              f"sdpa {show(dev['library_device_ms'])}")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms, **dev)
    return results


def phase_kernel_sweep():
    """The f32 body against its plain version over ``F32_SWEEP``, untimed."""
    worst, n = (0.0, None), 0
    for D in F32_SWEEP["D"]:
        for S in F32_SWEEP["S"]:
            for causal in F32_SWEEP["causal"]:
                for window in F32_SWEEP["window"]:
                    for H, KH in F32_SWEEP["heads"]:
                        g = torch.Generator(device="cuda").manual_seed(n)
                        q, k, v = (torch.randn(2, S, heads, D, generator=g,
                                               device="cuda")
                                   for heads in (H, KH, KH))
                        before = fa.BODY_LAUNCHES[fa.LIBRARY.name]
                        out = ops.flash_attention(q, k, v, causal=causal,
                                                  window=window)
                        ref = ops.flash_attention_plain(q, k, v, causal=causal,
                                                        window=window)
                        case = (2, S, H, KH, D, causal, window)
                        if fa.BODY_LAUNCHES[fa.LIBRARY.name] != before + 1:
                            raise SystemExit(f"f32 sweep {case}: not on the f32 body")
                        torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-4,
                                                   msg=lambda m: f"{case}: {m}")
                        err = (out - ref).abs().max().item()
                        worst = max(worst, (err, case), key=lambda w: w[0])
                        n += 1
    print(f"f32 sweep: {n} cases (B, S, H, KH, D, causal, window) on the f32 "
          f"body within 2e-4 of the plain version, the largest error "
          f"{worst[0]:.3g} at {worst[1]}")


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


def adamw_gaps(got, want, before) -> dict:
    """The kernel's update against the plain version's: the largest
    parameter gap, absolute and in ulps of the parameter's dtype at the
    magnitude of the leaf before and both results, and the largest moment
    gap over its leaf's largest moment."""
    ulps = err = moment = 0.0
    for a, b, p in zip(got[0], want[0], before):
        if a.numel() == 0:
            continue
        x, y = a.float(), b.float()
        mag = torch.maximum(torch.maximum(x.abs(), y.abs()), p.float().abs())
        bits = 7 if a.dtype == torch.bfloat16 else 23
        ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - bits)
        gap = (x - y).abs()
        err = max(err, float(gap.max()))
        ulps = max(ulps, float((gap / ulp).max()))
        del x, y, mag, ulp, gap
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        if a.numel():
            top = float(b.abs().max())
            moment = max(moment, float((a - b).abs().max()) / max(top, 1e-30))
    return dict(max_abs_err=err, param_ulps=ulps, moment_rel=moment)


def phase_adamw_kernel():
    """3b: ``ops.adamw_update`` against ``ops.adamw_update_plain`` at the
    training cells' trees, on the same inputs; returns the 7B cell's
    numbers for the kernels line."""
    print("== 3b. fused AdamW kernel against its plain version at the "
          "training cells' trees")
    results = {}
    for arch, layers, stages, heads in ADAMW_CELLS:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        gen = torch.Generator()
        # the stage trees by their leaves' shapes: (name, tree, how many)
        trees = {}
        for s in range(stages):
            tree = init_stage_params(cfg, s, stages, gen, device="meta")
            shape = tuple((tuple(t.shape), t.dtype) for t in leaves(tree))
            name, _, count = trees.get(shape, (f"stage{s}", tree, 0))
            trees[shape] = (name, tree, count + 1)
        trees = [*trees.values(),
                 ("head", init_head_params(cfg, gen, device="meta"), heads)]
        cell = dict(device_ms=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                    params=0, max_abs_err=0.0, param_ulps=0.0, moment_rel=0.0)
        for name, tree, count in trees:
            metas = leaves(tree)
            g = torch.Generator(device="cuda").manual_seed(len(metas) + layers)
            draw = (lambda t, k: torch.randn(  # noqa: E731
                t.shape, generator=g, device="cuda") * k)
            ps = [draw(t, 1.0).to(t.dtype) for t in metas]
            args = ([draw(t, 3.0).to(t.dtype) for t in metas], ps,
                    [draw(t, 1e-3) for t in metas],
                    [draw(t, 1e-3).abs() for t in metas],
                    torch.zeros((), dtype=torch.int32, device="cuda"))
            before = ops.adamw_update.launches
            got = ops.adamw_update(*args, **ADAMW_HYPER)
            if ops.adamw_update.launches != before + 1:
                raise SystemExit(f"3b {cfg.name} {name}: adamw_update.launches "
                                 f"rose by {ops.adamw_update.launches - before}")
            want = ops.adamw_update_plain(*args, **ADAMW_HYPER)
            gaps = adamw_gaps(got, want, ps)
            if int(got[3]) != int(want[3]) or gaps["param_ulps"] > ADAMW_PARAM_ULPS \
                    or gaps["moment_rel"] > ADAMW_MOMENT_RTOL:
                raise SystemExit(f"3b {cfg.name} {name}: {gaps}, steps "
                                 f"{int(got[3])} and {int(want[3])}; limits "
                                 f"{ADAMW_PARAM_ULPS} ulp, {ADAMW_MOMENT_RTOL}")
            del got, want
            kernel = lambda: ops.adamw_update(*args, **ADAMW_HYPER)  # noqa: E731
            plain = lambda: ops.adamw_update_plain(  # noqa: E731
                *args, **ADAMW_HYPER)
            dev = device_ms(kernel, reps=3)
            ms, plain_ms = median_ms(kernel, reps=5), median_ms(plain, reps=3)
            n = sum(t.numel() for t in ps)
            nbytes = sum(t.numel() * (2 * gr.element_size() + 2 * t.element_size()
                                      + 16) for t, gr in zip(ps, args[0]))
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            print(f"{cfg.name} {name} tree x{count}: {len(ps)} leaves, "
                  f"{n / 1e6:.1f} M params, {nbytes / 1e9:.2f} GB to move; "
                  f"kernel device {show(dev)}, a single call {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms at "
                  f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; against the plain version: "
                  f"params {gaps['param_ulps']:.3g} ulp (largest difference "
                  f"{gaps['max_abs_err']:.3g}), moments {gaps['moment_rel']:.3g} "
                  f"of the leaf's largest")
            for k, v in (("device_ms", dev), ("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", bound_ms), ("params", n)):
                cell[k] = None if v is None or cell[k] is None else cell[k] + count * v
            for k in ("max_abs_err", "param_ulps", "moment_rel"):
                cell[k] = max(cell[k], gaps[k])
            del args, ps, kernel, plain
            torch.cuda.empty_cache()
        share = (f"{cell['bound_ms'] / cell['device_ms']:.1%} of the bound"
                 if cell["device_ms"] else "device time not taken")
        print(f"{cfg.name} cell, {stages} stages and {heads} heads, "
              f"{cell['params'] / 1e9:.3f} B params: kernel device "
              f"{show(cell['device_ms'])} ({share}), plain {cell['plain_ms']:.2f} "
              f"ms a single call each tree, bound {cell['bound_ms']:.2f} ms")
        results[arch] = cell
    return results[ADAMW_CELLS[0][0]]


def row_ulps(got, want) -> float:
    """The largest gap of ``got`` from ``want`` in bf16 ulps at the
    magnitude of each row (the largest element of its last dim)."""
    x, y = got.double(), want.double()
    row = y.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    return float(((x - y).abs() / torch.exp2(torch.floor(torch.log2(row)) - 7)).max())


def phase_decode_attention_kernel():
    """3c: ``ops.decode_attention`` against ``ops.decode_attention_plain``
    at the serve cells' shapes; returns the decode cell's numbers for the
    kernels line."""
    from repro_torch.kernels import decode_attention as dec
    print("== 3c. split-KV decode attention against its plain version at the "
          "serve cells' shapes")
    results = {}
    for name, (B, C, kv_valid, H, KH, hd) in DECODE_CASES:
        g = torch.Generator(device="cuda").manual_seed(C + kv_valid)
        q = torch.randn(B, 1, H, hd, generator=g, device="cuda").bfloat16()
        ck = torch.randn(B, C, KH * hd, generator=g, device="cuda") * 2
        cv = torch.randn(B, C, KH * hd, generator=g, device="cuda")
        before = ops.decode_attention.launches
        got = ops.decode_attention(q, ck, cv, kv_valid, KH, hd)
        if ops.decode_attention.launches != before + 1:
            raise SystemExit(f"3c {name}: decode_attention.launches rose by "
                             f"{ops.decode_attention.launches - before}")
        want = ops.decode_attention_plain(q, ck, cv, kv_valid, KH, hd)
        ulps = row_ulps(got, want)
        err = float((got.float() - want.float()).abs().max())
        if not ulps <= 1.0:
            raise SystemExit(f"3c {name}: {ulps} bf16 ulp from the plain "
                             f"version, limit 1")
        del got, want
        kernel = lambda: ops.decode_attention(  # noqa: E731
            q, ck, cv, kv_valid, KH, hd)
        plain = lambda: ops.decode_attention_plain(  # noqa: E731
            q, ck, cv, kv_valid, KH, hd)
        dev = device_ms(kernel, reps=50)
        ms, plain_ms = median_ms(kernel, reps=20), median_ms(plain, reps=5)
        nbytes = (2 * B * KH * kv_valid * hd * ck.element_size()
                  + 2 * q.numel() * q.element_size())
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        splits, chunk = dec.plan(B * KH, kv_valid)
        share = f"{bound_ms / dev:.1%} of the bound" if dev else "not taken"
        print(f"{name}: B={B} C={C} kv_valid={kv_valid} H/KH={H}/{KH} hd={hd} "
              f"bf16 q, f32 cache, {splits} splits of {chunk} slots "
              f"({splits * B * KH} blocks); {ulps:.3g} bf16 ulp at the row's "
              f"magnitude (largest difference {err:.3g}); kernel device "
              f"{show(dev)} ({share}), a single call {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} "
              f"MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
        results[name] = dict(max_abs_err=err, bf16_ulps=ulps, device_ms=dev,
                             ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        del q, ck, cv, kernel, plain
        torch.cuda.empty_cache()
    return results[DECODE_CASES[0][0]]


def train_attention_bound(shape):
    """(ms, "bytes" or "operations"): the least time for the pair's forward
    and backward at ``shape``: ``TRAIN_ATTENTION_PRODUCTS`` products a
    causal pair at 989 TFLOP/s against q, k, v, o, dO read and dQ, dK, dV
    written once at 3.35 TB/s."""
    B, S, H, KH, D, window = shape
    pairs = attended_pairs(S, True, window) * B * H
    t_ops = 2 * D * TRAIN_ATTENTION_PRODUCTS * pairs / PEAK_FLOPS[torch.bfloat16]
    t_bytes = 2 * (5 * B * S * H * D + 4 * B * S * KH * D) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_flash_train_kernel():
    """3d: training's flash pair against autograd of ``_online_attention``
    at the training cells' shapes; returns the GPT-like shape's numbers
    for the kernels line."""
    print("== 3d. training's flash pair (forward with lse, hand-written "
          "backward) against autograd of _online_attention")
    results = {}
    for name, (B, S, H, KH, D, window) in TRAIN_ATTENTION_CASES:
        g = torch.Generator(device="cuda").manual_seed(S + H)
        q, dout = (torch.randn(B, S, H, D, generator=g, device="cuda").bfloat16()
                   for _ in range(2))
        k, v = (torch.randn(B, S, KH, D, generator=g, device="cuda").bfloat16()
                for _ in range(2))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]

        def grads(fn):
            out = fn(*leaves)
            return [out] + list(torch.autograd.grad(out, leaves, dout))

        pair = lambda q, k, v: ops.flash_attention_train(  # noqa: E731
            q, k, v, window=window)
        plain = lambda q, k, v: layers._online_attention(  # noqa: E731
            q, k, v, 0, causal=True, window=window)
        before = ops.flash_attention_bwd.launches
        got = grads(pair)
        if ops.flash_attention_bwd.launches != before + 1:
            raise SystemExit(f"3d {name}: flash_attention_bwd.launches rose by "
                             f"{ops.flash_attention_bwd.launches - before}")
        want = grads(plain)
        errs = {n: float((a.detach().double() - b.detach().double()).norm()
                         / b.detach().double().norm())
                for n, a, b in zip(("o", "dq", "dk", "dv"), got, want)}
        if not max(errs.values()) < 1e-2:
            raise SystemExit(f"3d {name}: relative RMS errors {errs} against "
                             f"_online_attention, limit 1e-2")
        del got, want
        out, lse = ops.flash_attention_lse(q, k, v, window=window)
        backward = lambda: ops.flash_attention_bwd(  # noqa: E731
            q, k, v, out, lse, dout, window=window)
        dev, dev_bwd = device_ms(lambda: grads(pair), reps=20), device_ms(backward, reps=20)
        ms = median_ms(lambda: grads(pair), reps=20)
        plain_ms = median_ms(lambda: grads(plain), reps=5)
        bound_ms, bound_by = train_attention_bound((B, S, H, KH, D, window))
        share = f"{bound_ms / dev:.1%} of the bound" if dev else "not taken"
        print(f"{name}: B={B} S={S} H/KH={H}/{KH} D={D} window={window}; "
              f"relative RMS error against _online_attention "
              f"{', '.join(f'{n} {e:.2e}' for n, e in errs.items())}; pair "
              f"device {show(dev)} ({share}; backward alone {show(dev_bwd)}), "
              f"a single call {ms:.4f} ms, _online_attention forward and "
              f"backward {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}: {TRAIN_ATTENTION_PRODUCTS} products a causal "
              f"pair at 989 TFLOP/s)")
        results[name] = dict(max_abs_err=max(errs.values()), device_ms=dev,
                             backward_device_ms=dev_bwd, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms)
        del q, k, v, dout, leaves, out, lse
        torch.cuda.empty_cache()
    return results[TRAIN_ATTENTION_CASES[0][0]]


def stage_dispatches(trainer) -> tuple:
    """(attention forwards, attention backwards) the trainer's stage
    dispatches so far call for: a layer's forward per stage forward (fused,
    plain, or remat's recompute), a layer's backward per stage backward."""
    c = trainer.stages
    n = len(c.fwd_calls)
    per = [hi - lo for lo, hi in (stage_bounds(trainer.cfg, s, n) for s in range(n))]
    fwd = sum(L * (f + m) for L, f, m in zip(per, c.fwd_calls, c.remat_recomputes))
    return fwd, sum(L * b for L, b in zip(per, c.bwd_calls))


def check_train_attention(label: str, launches: dict, want: tuple):
    """Training attends through the flash pair: ``want`` (forwards,
    backwards) calls, all on the bf16 body; no SSD scan."""
    fwd, bwd = want
    got = (launches["flash_attention"], ops.flash_attention_bwd.launches)
    if got != (fwd, bwd) or not bwd or launches["ssd_scan"] \
            or fa.BODY_LAUNCHES[fa.SM90_LIBRARY.name] != fwd:
        raise SystemExit(f"{label}: flash forward and backward launches {got}, "
                         f"want {(fwd, bwd)} (one a layer of each stage "
                         f"dispatch), bodies {fa.BODY_LAUNCHES}, {launches}")


def reset_launches():
    ops.flash_attention.launches = 0
    ops.flash_attention_bwd.launches = 0
    ops.ssd_scan.launches = 0
    ops.adamw_update.launches = 0
    ops.decode_attention.launches = 0
    for body in fa.BODY_LAUNCHES:
        fa.BODY_LAUNCHES[body] = 0


def read_launches():
    return {"flash_attention": ops.flash_attention.launches,
            "ssd_scan": ops.ssd_scan.launches}


def prefill_launches(cfg) -> dict:
    """Each kernel's launches in one prefill: flash once per self-attention
    layer (a VLM's cross layers attend through the plain path), the SSD
    scan once per SSM layer; decode launches neither."""
    nb, k = superblocks(cfg) if is_vlm(cfg) else (cfg.num_layers, 2)
    return {"flash_attention": nb * (k - 1) if cfg.has_attention else 0,
            "ssd_scan": cfg.num_layers if cfg.has_ssm else 0}


def check_decode_launches(cfg, steps: int) -> int:
    """The decode attention kernel's launches since the last reset: one a
    self-attention layer of each of ``steps`` decode steps (the layers the
    prefill attends through flash)."""
    want = prefill_launches(cfg)["flash_attention"] * steps
    if ops.decode_attention.launches != want:
        raise SystemExit(f"{cfg.name}: decode_attention.launches "
                         f"{ops.decode_attention.launches} over {steps} decode "
                         f"steps, want {want}")
    return want


def run_serve(arch: str):
    """Serve ``arch`` at full width (cut in depth to ``SERVE_LAYERS``) as
    the main path; returns each kernel's launches counted over exactly this
    serve."""
    t_start = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=SERVE_LAYERS.get(arch,
                                                               full.num_layers))
    experts = (f", {cfg.num_experts} experts of d_ff {cfg.d_ff}, top "
               f"{cfg.num_experts_per_tok}, {cfg.num_shared_experts} shared, "
               f"moe_impl dense" if cfg.is_moe else "")
    cut = (f" (cut in depth from {full.num_layers}: {superblocks(cfg)[0]} "
           f"superblocks of 1 cross and {cfg.cross_attn_every - 1} self layers, "
           f"{cfg.num_image_tokens} image tokens of {cfg.vision_dim})"
           if cfg.num_layers != full.num_layers else "")
    stub = (" from stub frame embeddings" if cfg.audio_frontend else "")
    print(f"== 4. serve {cfg.name} full width, {cfg.num_layers} layers{cut}, "
          f"d_model {cfg.d_model}, H/KH {cfg.num_heads}/{cfg.num_kv_heads} of "
          f"{cfg.head_dim}, SSD heads {cfg.ssm_heads} (N {cfg.ssm_state}), "
          f"vocab {cfg.vocab_size}{experts}{stub}, bf16 params "
          f"({cfg.param_count() / 1e9:.2f} B), f32 cache")
    model, prompt, g = serving_inputs(cfg, seed=0, batch=SERVE["batch"],
                                      prompt_len=SERVE["prompt_len"],
                                      device="cuda")
    vision, embeds = serving_aux_inputs(cfg, seed=0, batch=SERVE["batch"],
                                        prompt_len=SERVE["prompt_len"],
                                        device="cuda")
    aux = dict(vision=vision, embeds=embeds)
    # warm-up: one-time set-up (cuBLAS handles, lazy module loads) stays
    # out of the numbers below
    generate(model, cfg, prompt, gen=2, window=None, temperature=0.0,
             generator=g, **aux)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                      # the main path starts here
    out = generate(model, cfg, prompt, gen=SERVE["gen"], window=None,
                   temperature=0.0, generator=g, **aux)
    launches = read_launches()
    bodies = dict(fa.BODY_LAUNCHES)
    B = SERVE["batch"]
    want = prefill_launches(cfg)
    if launches != want:
        raise SystemExit(f"kernel launches {launches} over the serve, want "
                         f"{want}")
    launches["decode_attention"] = check_decode_launches(cfg, SERVE["gen"])
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
    profile_serve(cfg, model, prompt, **aux)
    print(f"{cfg.name}: drawn, served and profiled in "
          f"{time.perf_counter() - t_start:.1f} s")
    return launches


def profile_run(name: str, label: str, fn, activities=PROFILE_ALL):
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
    return profiled(name, label, fn, (time.perf_counter() - t0) * 1e3,
                    activities)


def profiled(name: str, label: str, fn, wall=None, activities=PROFILE_ALL):
    """Run ``fn`` once under ``torch.profiler``; print its profiled wall
    time (and ``wall``, the unprofiled time of the same work, if known)
    against the device busy time, and the kernels that take the device's
    time; returns the busy ms.  Leaving out the CPU's activity leaves out
    the host's operator events, which cost the profiler minutes over ~10^5
    launches."""
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
    return busy


def profile_serve(cfg, model, prompt, steps: int = 8, vision=None,
                  embeds=None):
    """Wall time against device busy time for one prefill and ``steps``
    greedy decode steps, and the kernels that take the device's time.  An
    MoE model's dense experts launch ~10^4 kernels a decode step: its
    trace takes the device's activity only (the host's operator events
    would cost the profiler minutes).  A VLM's decode recomputes the
    vision projection and each cross layer's K/V at every step: their
    device time, timed alone on the same inputs, as a share of the
    decode's busy time."""
    B, P = prompt.shape

    def do_prefill():
        cache = init_cache(cfg, B, P + steps, dtype=torch.float32,
                           device=prompt.device)
        if embeds is not None:
            return prefill(model, cfg, embeds=embeds, cache=cache)
        return prefill(model, cfg, tokens=prompt, vision=vision, cache=cache)

    logits, cache = do_prefill()
    tok = logits.argmax(dim=-1)[:, None]

    def do_decode():
        for i in range(steps):
            decode_step(model, cfg, tokens=tok, vision=vision, cache=cache,
                        index=P + i)

    activities = [ProfilerActivity.CUDA] if cfg.is_moe else PROFILE_ALL
    profile_run(cfg.name, "prefill", do_prefill, activities)
    busy = profile_run(cfg.name, f"decode x{steps}", do_decode, activities)
    if vision is None:
        return

    @torch.inference_mode()
    def recompute():
        vis = vision.to(torch.bfloat16) @ model.vision_proj["w_proj"]
        for cp in model.cross_blocks:
            vis @ cp.xattn["wk"], vis @ cp.xattn["wv"]

    ms = device_ms(recompute, reps=5)
    flops = 2 * B * cfg.num_image_tokens * cfg.d_model * (
        cfg.vision_dim + 2 * len(model.cross_blocks) * cfg.kv_dim)
    print(f"{cfg.name} decode: the vision projection and the cross K/V "
          f"({flops / 1e12:.2f} TFLOP a step) take device {show(ms)} a step "
          f"timed alone, "
          f"{'not taken' if ms is None else f'{steps * ms / busy:.1%}'} of the "
          f"decode's busy time ({busy:.2f} ms over {steps} steps); bound "
          f"{flops / PEAK_FLOPS[torch.bfloat16] * 1e3:.4f} ms at the bf16 peak")


def head_dim_256(cfg):
    """``gemma-7b`` reduced to 2 layers of d_model 512 with its head_dim 256
    kept (``reduced`` caps head_dim at 64)."""
    return dataclasses.replace(cfg.reduced(num_layers=2, d_model=512),
                               name=f"{cfg.name}-smoke-hd256", num_heads=2,
                               num_kv_heads=2, head_dim=256)


def reduced_vlm():
    """The reduced VLM: 4 layers as two superblocks of (cross, self)."""
    return dataclasses.replace(get_config(VLM).reduced(num_layers=4),
                               cross_attn_every=2)


def phase_gpu_vs_cpu():
    print("== 5. port on cuda against port on cpu (f32, TF32 off)")
    cfgs = [get_config(a).reduced() for a in GPU_VS_CPU_ARCHS]
    for cfg in cfgs + [head_dim_256(get_config("gemma-7b")), reduced_vlm()]:
        runs = {}
        for device in ("cpu", "cuda"):
            # drawn on the CPU both times, so both runs hold the same weights
            model, prompt, _ = serving_inputs(cfg, seed=0, batch=2,
                                              prompt_len=64, device="cpu")
            vision, embeds = serving_aux_inputs(cfg, seed=0, batch=2,
                                                prompt_len=64, device="cpu")
            with torch.no_grad():
                for cp, gates in zip(getattr(model, "cross_blocks", []),
                                     VLM_GATES):
                    cp.gate_attn.fill_(gates[0])
                    cp.gate_mlp.fill_(gates[1])
            to = lambda t: None if t is None else t.to(device)  # noqa: E731
            reset_launches()
            runs[device] = generate(model.to(device), cfg, prompt.to(device),
                                    gen=8, window=None, temperature=0.0,
                                    generator=None, vision=to(vision),
                                    embeds=to(embeds))
        # one prefill: each kernel once per layer that has it, flash on
        # the f32 body
        want = prefill_launches(cfg)
        if (read_launches() != want
                or fa.BODY_LAUNCHES[fa.LIBRARY.name] != want["flash_attention"]):
            raise SystemExit(f"{cfg.name}: launches {read_launches()}, bodies "
                             f"{fa.BODY_LAUNCHES}, want {want} on the f32 body")
        decode = check_decode_launches(cfg, 8)
        cpu, gpu = runs["cpu"], runs["cuda"]
        torch.testing.assert_close(gpu.logits.cpu(), cpu.logits, rtol=1e-3,
                                   atol=1e-3)
        if not torch.equal(gpu.tokens.cpu(), cpu.tokens):
            raise SystemExit(f"{cfg.name}: greedy streams differ on cuda and "
                             f"cpu")
        err = (gpu.logits.cpu() - cpu.logits).abs().max().item()
        inputs = ("vision, gates " + ", ".join(map(str, VLM_GATES))
                  if is_vlm(cfg) else "frame embeddings"
                  if cfg.audio_frontend else "tokens")
        print(f"{cfg.name} (head_dim {cfg.head_dim}, {inputs}): logits "
              f"max_abs_err {err:.3g} (tol 1e-3) over {cpu.logits.shape[0]} "
              f"steps, greedy streams equal, launches {read_launches()} on the "
              f"f32 body, decode attention {decode}")


def check_adamw_launches(label: str, calm: int, iters: int, trees: int,
                         churned=None):
    """AdamW's kernel once a tree an update: ``trees`` (stages and data
    nodes) in each of ``iters`` calm iterations, and, over as many churned
    iterations, at most as many (a stage left without gradients is not
    updated)."""
    if calm != iters * trees or (
            churned is not None and not 0 < churned <= iters * trees):
        raise SystemExit(f"{label}: AdamW kernel launches {calm} over {iters} "
                         f"calm iterations of {trees} trees, {churned} over "
                         f"the churned ones")


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
    launches counted over exactly this run (attention: the flash pair once
    a layer of each stage dispatch; AdamW: one a tree updated)."""
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
    dispatched = stage_dispatches(trainer)

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
    calm_updates = ops.adamw_update.launches
    for it in range(TRAIN_ITERS, 2 * TRAIN_ITERS):
        step(it, TRAIN_CHURN)
    launches = read_launches()
    check_train_attention("phase 6", launches, tuple(
        a - b for a, b in zip(stage_dispatches(trainer), dispatched)))
    launches["flash_attention_bwd"] = ops.flash_attention_bwd.launches
    launches["adamw_update"] = ops.adamw_update.launches
    check_adamw_launches("phase 6", calm_updates, TRAIN_ITERS,
                         args.stages + args.data_nodes,
                         launches["adamw_update"] - calm_updates)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {launches} (attention through the flash pair, once a "
          f"layer of each stage dispatch; AdamW's kernel updates each tree)")
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


def phase_train_7b():
    """The paper's 7B model, cut in depth only, through ``launch.train``;
    returns each kernel's launches over the run (attention: the flash pair
    once a layer of each stage dispatch; AdamW: one a tree updated)."""
    args = train.parser().parse_args(TRAIN_7B_ARGS)
    full = get_config(args.arch)
    cfg = dataclasses.replace(full, num_layers=TRAIN_7B_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, shards = train.build_gwtf(args, cfg)
    torch.cuda.synchronize()
    print(f"== 6d. train {cfg.name} at full width (d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.param_dtype}), cut in depth to "
          f"{cfg.num_layers} of its {full.num_layers} layers "
          f"({cfg.param_count() / 1e9:.2f} B params); {args.stages} stages x "
          f"{args.relays_per_stage} relays, {args.data_nodes} data node x "
          f"{args.microbatches} microbatches of {args.batch} x {args.seq_len} "
          f"tokens; trainer built in {time.perf_counter() - t0:.1f}s")
    reset_launches()                      # the main path starts here
    dispatched = stage_dispatches(trainer)
    for it in range(TRAIN_7B_ITERS):
        r, secs, tokens = train.train_iteration(trainer, shards)
        check_counters(r, 0.0)
        print(f"iter {it}: loss {r.loss:.4f}, completed {r.completed}/"
              f"{r.launched}, {secs * 1e3:.1f} ms, {tokens / secs:.0f} tok/s, "
              f"store peak {r.store_peak_bytes / 2**30:.2f} GiB")
    launches = read_launches()
    check_train_attention("phase 6d", launches, tuple(
        a - b for a, b in zip(stage_dispatches(trainer), dispatched)))
    launches["flash_attention_bwd"] = ops.flash_attention_bwd.launches
    launches["adamw_update"] = ops.adamw_update.launches
    check_adamw_launches("phase 6d", launches["adamw_update"], TRAIN_7B_ITERS,
                         args.stages + args.data_nodes)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {launches}")
    del trainer
    train_cache.clear()                   # the initial parameters it drew
    gc.collect()
    return launches


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
    none elsewhere (training in f32 attends through ``_online_attention``)."""
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


def load_example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_example(name: str, argv, device: str):
    """``main(argv + --device device)`` of a fresh copy of the example, in
    this process: ``(stdout, seconds)``.  ``torch_serve_decode`` draws its
    model and prompt on the cpu and moves them, so both devices serve one
    model."""
    module = load_example(name)
    if hasattr(module, "serving_inputs"):
        real = module.serving_inputs

        def drawn(cfg, *, seed, batch, prompt_len, device):
            model, prompt, _ = real(cfg, seed=seed, batch=batch,
                                    prompt_len=prompt_len, device="cpu")
            return model.to(device), prompt.to(device), None
        module.serving_inputs = drawn
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        module.main([*argv, "--device", device])
    return buf.getvalue(), time.perf_counter() - t0


def same_report(name: str, gpu: str, cpu: str):
    """The text around every number equal (counters, flows, plans, token
    ids); numbers within ``EXAMPLE_RTOL`` (``gap=``, a difference of two
    means, within the sum of theirs); times not compared; nothing
    non-finite."""
    if re.search(r"\b(nan|inf)\b", gpu + cpu, re.I):
        raise SystemExit(f"{name}: a non-finite number in\n{gpu}")
    g_lines, c_lines = gpu.splitlines(), cpu.splitlines()
    if len(g_lines) != len(c_lines):
        raise SystemExit(f"{name}: {len(g_lines)} lines on cuda, "
                         f"{len(c_lines)} on cpu")
    for g, c in zip(g_lines, c_lines):
        gs, cs = NUMBER.split(g), NUMBER.split(c)
        if gs[::2] != cs[::2]:
            raise SystemExit(f"{name}: cuda printed\n{g}\ncpu\n{c}")
        means = [float(x) for x in cs[1::2]]
        for label, after, a, b in zip(gs[::2], gs[2::2], gs[1::2], cs[1::2]):
            a, b = float(a), float(b)
            if after.startswith("s)"):             # a time
                continue
            tol = EXAMPLE_RTOL * (sum(means[:2]) if label.endswith("gap=")
                                  else abs(b))
            if abs(a - b) > tol:
                raise SystemExit(f"{name}: {label.strip()} {a} on cuda, {b} "
                                 f"on cpu\n{g}")


def phase_examples():
    """The port's examples on cuda against the same on the cpu; returns each
    kernel's launches over the cuda runs, each counted from 0."""
    print("== 9. the examples on cuda against the cpu")
    launches = {"flash_attention": 0, "ssd_scan": 0, "adamw_update": 0}
    for name, argv, flash in EXAMPLES:
        reset_launches()                  # the main path starts here
        gpu, gpu_s = run_example(name, argv, "cuda")
        got = read_launches()
        updates = ops.adamw_update.launches
        if flash and updates:
            raise SystemExit(f"{name}: {updates} AdamW kernel launches from "
                             f"the serving example")
        if got != {"flash_attention": flash, "ssd_scan": 0} or fa.BODY_LAUNCHES[
                fa.LIBRARY.name] != flash:
            raise SystemExit(f"{name}: launches {got}, bodies "
                             f"{fa.BODY_LAUNCHES}, want {flash} on the f32 body")
        for k in got:
            launches[k] += got[k]
        launches["adamw_update"] += updates
        cpu, cpu_s = run_example(name, argv, "cpu")
        same_report(name, gpu, cpu)
        print(f"examples/{name}.py {' '.join(argv)}: exit 0, cuda {gpu_s:.1f} "
              f"s, cpu {cpu_s:.1f} s, the same report (counters exactly, "
              f"numbers within {EXAMPLE_RTOL}), launches {got}, AdamW "
              f"{updates}; on cuda:")
        for line in gpu.splitlines()[-4:]:
            print(f"    {line}")
    if not launches["adamw_update"]:
        raise SystemExit("the training examples launched no AdamW kernel")
    return launches


def phase_spmd():
    """``--mode spmd`` at full width as the main path, through
    ``launch.train``'s ``build_spmd`` and ``spmd_step``; returns each
    kernel's launches over the run (attention: without a mesh the tensors
    are plain, so the flash pair once a layer a step, and its forward once
    more where remat recomputes it; AdamW: one a step)."""
    args = train.parser().parse_args(SPMD_ARGS)
    device = torch.device(args.device)
    before = torch.cuda.memory_allocated()    # what earlier phases still hold
    t0 = time.perf_counter()
    cfg, params, opt_state, train_step, shard = train.build_spmd(args)
    torch.cuda.synchronize()
    print(f"== 10. train {cfg.name} full width through --mode spmd: "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype} params ({cfg.param_count() / 1e6:.0f} M), remat "
          f"{cfg.remat}; batch {args.batch} x {args.seq_len} tokens, lr "
          f"{args.lr}, {args.steps} steps; weights drawn on the host and "
          f"moved in {time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                      # the main path starts here
    state = dict(params=params, opt_state=opt_state, step=0)
    del params, opt_state                 # the state holds the only references
    losses = []

    def step():
        state["params"], state["opt_state"], loss, secs, tokens = train.spmd_step(
            train_step, state["params"], state["opt_state"], shard, device)
        if not math.isfinite(loss):
            raise SystemExit(f"step {state['step']}: non-finite loss {loss}")
        losses.append(loss)
        print(f"step {state['step']}: loss {loss:.4f}, {secs * 1e3:.1f} ms, "
              f"{tokens / secs:.0f} tok/s")
        state["step"] += 1

    # steps 0-1, then profile_run's three: unprofiled, timed, profiled
    for _ in range(args.steps - 3):
        step()
    print("where the time goes (torch.profiler), the last three steps:")
    profile_run(cfg.name, "spmd step", step)
    launches = read_launches()
    n = cfg.num_layers * args.steps
    check_train_attention("--mode spmd", launches,
                          (n * (2 if cfg.remat else 1), n))
    launches["flash_attention_bwd"] = ops.flash_attention_bwd.launches
    launches["adamw_update"] = ops.adamw_update.launches
    if launches["adamw_update"] != args.steps:
        raise SystemExit(f"--mode spmd: {launches['adamw_update']} AdamW "
                         f"kernel launches over {args.steps} steps")
    gib = lambda n: f"{(n - before) / 2**30:.2f} GiB"  # noqa: E731
    print(f"peak memory {gib(torch.cuda.max_memory_allocated())} above the "
          f"{before / 2**30:.2f} GiB earlier phases held, launches {launches}; "
          f"losses {[round(x, 4) for x in losses]}, all finite (at lr 1e-3 "
          f"with no warmup the full-width loss may rise first)")
    # where the peak is reached: the forward and backward, then AdamW's
    # update, each alone on one more batch
    b = shard.next_batch()
    batch = {k: torch.from_numpy(b[k]).to(device) for k in ("tokens", "labels")}
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, grads = steps.loss_and_grads(state["params"], batch, cfg)
    fwd_bwd = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    AdamW(lr=args.lr).update(grads, state["opt_state"], state["params"])
    update = torch.cuda.max_memory_allocated()
    print(f"peak memory split, above what earlier phases held: {gib(held)} "
          f"held between steps (params, AdamW moments), forward and backward "
          f"peak {gib(fwd_bwd)}, AdamW update peak {gib(update)}")
    return launches, losses


def spmd_batch(cfg, seed: int, device):
    """A reduced batch of 2 x 64 from ``seed``: labels, tokens (frame
    embeddings for an audio model) and, for a VLM, patch embeddings."""
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab_size, (2, 64))}
    if cfg.audio_frontend:
        b["embeds"] = rng.standard_normal((2, 64, cfg.d_model), np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (2, 64))
    if is_vlm(cfg):
        b["vision"] = rng.standard_normal(
            (2, cfg.num_image_tokens, cfg.vision_dim), np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def phase_spmd_vs_cpu():
    print("== 10b. --mode spmd steps, reduced f32: cuda against cpu")
    for arch in SPMD_KINDS:
        cfg = (reduced_vlm() if arch == VLM
               else get_config(arch).reduced(max_experts=8))
        runs = {}
        for device in ("cpu", "cuda"):
            params = train.spmd_params(cfg, 0, device)
            if is_vlm(cfg):
                for i, name in enumerate(("gate_attn", "gate_mlp")):
                    params["cross_blocks"][name] = torch.tensor(
                        [g[i] for g in VLM_GATES], device=device)
            opt = AdamW(lr=1e-3)
            opt_state, train_step = opt.init(params), steps.make_train_step(
                cfg, opt)
            reset_launches()
            losses = []
            for i in range(len(TRAIN_LOSS_RTOL)):
                params, opt_state, loss = train_step(
                    params, opt_state, spmd_batch(cfg, i, device))
                losses.append(float(loss))
            if any(read_launches().values()) or (
                    ops.adamw_update.launches
                    != (len(losses) if device == "cuda" else 0)):
                raise SystemExit(f"{cfg.name}: training launched kernels "
                                 f"{read_launches()}, AdamW "
                                 f"{ops.adamw_update.launches} over "
                                 f"{len(losses)} steps on {device}")
            runs[device] = losses
        rel = [abs(g - c) / abs(c) for g, c in zip(runs["cuda"], runs["cpu"])]
        if any(r > tol for r, tol in zip(rel, TRAIN_LOSS_RTOL)):
            raise SystemExit(f"{cfg.name}: losses cpu {runs['cpu']}, cuda "
                             f"{runs['cuda']}, tol {TRAIN_LOSS_RTOL}")
        print(f"{cfg.name}: losses cpu {[f'{x:.6f}' for x in runs['cpu']]}, "
              f"cuda {[f'{x:.6f}' for x in runs['cuda']]} (rel "
              f"{', '.join(f'{r:.3g}' for r in rel)}; tol {TRAIN_LOSS_RTOL})")


def dryrun_command(arch: str, shape: str, multi_pod: bool, out: Path):
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
            "--shape", shape, *(["--multi-pod"] if multi_pod else []),
            "--device", "cuda", "--out", str(out)]


def print_dryrun(r: dict, seconds: float):
    """One combination of 11a: its seconds, per-device dot FLOPs, collective
    bytes by kind, per-device memory and analytic memory against 80 GB."""
    gb = lambda n: f"{n / 1e9:.2f} GB"  # noqa: E731
    mem, analytic = r["memory"], r["analytic_memory"]
    print(f"{r['arch']} x {r['shape']} x {r['mesh']}: {seconds:.1f} s "
          f"(trace {r['trace_s']} s), grad_accum {r['grad_accum']} (traced "
          f"{r['grad_accum_traced']}); dot FLOPs a device {r['dot_flops']:.4e} "
          f"(global {r['global_flops']:.4e}); collective bytes a device "
          f"{r['collective_bytes']:.4e} = "
          + ", ".join(f"{k} {v:.4e}" for k, v in r["collective_detail"].items()
                      if v)
          + f" over {int(r['collective_count'])} collectives; memory a device: "
          f"arguments {gb(mem['argument_size'])}, the step's own peak "
          f"{gb(mem['temp_size'])}, total {gb(mem['peak'])}; analytic "
          f"{gb(analytic['total'])} of 80 GB ("
          f"{'fits' if r['fits'] else 'does not fit'}); x ideal "
          f"{r['x_ideal']:.4f} (at most {DRYRUN_X_IDEAL[r['arch']]})")


def sharded_step() -> int:
    """11b, in a child: phase 10's step (``SPMD_ARGS``: full-width
    ``gwtf-llama-300m``, bf16, 4 x 512, the same seed and batches) without a
    mesh and through ``make_train_step(mesh=make_host_mesh(),
    rules=ShardingRules())`` on a process group of world size 1 (NCCL),
    parameters and AdamW state DTensors on the (1, 1) mesh, both under
    deterministic algorithms; prints one JSON line.  Both update through
    AdamW's kernel: the sharded step on its DTensors' local shards.  Both
    attend through ``_online_attention``: the sharded step's DTensors take
    it, and the run without a mesh, whose plain tensors the flash pair
    would take, is held to it (the route patched here) so that the two
    compute the same function."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import ShardingRules, distribute
    torch.use_deterministic_algorithms(True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{SHARDED_PORT}",
                            rank=0, world_size=1)
    try:
        mesh, rules = make_host_mesh("cuda"), ShardingRules()
        args = train.parser().parse_args(SPMD_ARGS)
        runs = {}
        route = ops.flash_attention_train_route
        for on_mesh in (False, True):
            ops.flash_attention_train_route = (
                route if on_mesh else lambda q, k, v: False)
            cfg, params, opt_state, _, shard = train.build_spmd(args)
            step = steps.make_train_step(cfg, AdamW(lr=args.lr),
                                         mesh=mesh if on_mesh else None,
                                         rules=rules)
            losses, secs = [], []
            ops.adamw_update.launches = 0
            for i in range(args.steps):
                b = shard.next_batch()
                batch = {k: torch.from_numpy(b[k]).cuda()
                         for k in ("tokens", "labels")}
                if on_mesh and i == 0:
                    (ps, os_, bs), _ = steps.train_shardings(
                        cfg, params, opt_state, batch, rules, mesh)
                    params = distribute(params, ps, mesh)
                    opt_state = distribute(opt_state, os_, mesh)
                if on_mesh:
                    batch = distribute(batch, bs, mesh)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt_state, loss = step(params, opt_state, batch)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(loss.full_tensor() if on_mesh else loss)
            full = (lambda t: t.full_tensor()) if on_mesh else (lambda t: t)
            runs[on_mesh] = dict(
                losses=losses, secs=secs, adamw=ops.adamw_update.launches,
                leaves=[full(t) for t in leaves(params) + leaves(opt_state)],
                dtensor=on_mesh and all(type(t).__name__ == "DTensor" for t in
                                        leaves(params) + leaves(opt_state)))
            del params, opt_state
        plain, sharded = runs[False], runs[True]
        diffs = [float((a.float() - b.float()).abs().max()) for a, b in
                 zip(plain["losses"] + plain["leaves"],
                     sharded["losses"] + sharded["leaves"])]
        print(json.dumps({
            "losses": [float(x) for x in plain["losses"]],
            "sharded_losses": [float(x) for x in sharded["losses"]],
            "bitwise": all(torch.equal(a, b) for a, b in zip(
                plain["losses"] + plain["leaves"],
                sharded["losses"] + sharded["leaves"])),
            "max_abs_diff": max(diffs), "leaves": len(plain["leaves"]),
            "all_dtensor": sharded["dtensor"],
            "adamw_launches": [plain["adamw"], sharded["adamw"]],
            "ms": [x * 1e3 for x in plain["secs"]],
            "sharded_ms": [x * 1e3 for x in sharded["secs"]]}))
    finally:
        dist.destroy_process_group()
    return 0


def phase_launch(spmd_losses):
    """11a, the dry runs of ``DRYRUN_CASES`` at full width, each a
    ``launch.dryrun`` child on a fake group of 256 or 512 ranks; 11b,
    ``sharded_step`` in a child with ``CUBLAS_WORKSPACE_CONFIG`` set; all
    six started together (the dry runs use the host's cores, not the
    card), each killed if it outlives ``LAUNCH_TIMEOUT``."""
    print("== 11. the multi-device launch layer: 11a dry runs at full width "
          "(fake tensors on a fake process group, nothing allocated; FLOPs, "
          "collectives and memory counted from the trace, not measured), 11b "
          "phase 10's step sharded on a (1, 1) mesh (children)")
    out_dir = ROOT / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    children = []
    try:
        for arch, shape, multi_pod in DRYRUN_CASES:
            out = out_dir / f"{arch}_{shape}.json"
            out.unlink(missing_ok=True)
            children.append((f"{arch} x {shape}", out, time.perf_counter(),
                             subprocess.Popen(
                                 dryrun_command(arch, shape, multi_pod, out),
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, cwd=ROOT)))
        sharded = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--sharded-step"],
            env=dict(env, CUBLAS_WORKSPACE_CONFIG=":4096:8"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        children.append(("11b", None, time.perf_counter(), sharded))
        failed = []
        print("-- 11a:")
        for name, out, t0, proc in children:
            stdout, stderr = proc.communicate(timeout=LAUNCH_TIMEOUT)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                print(stderr[-3000:], file=sys.stderr)
                failed.append(f"{name} exited {proc.returncode}")
            elif out is not None:
                r = json.loads(out.read_text())[-1]
                print_dryrun(r, seconds)
                counts = [r["dot_flops"], r["global_flops"], r["collective_bytes"],
                          *r["collective_detail"].values(),
                          *r["memory"].values()]
                devices = 512 if r["mesh"] == "2x16x16" else 256
                if (min(counts) < 0 or r["dot_flops"] <= 0
                        or r["dot_flops"] * devices < r["global_flops"] * (1 - 1e-9)):
                    failed.append(f"{name}: counts {counts}: each must be "
                                  f"non-negative and the devices' dot FLOPs "
                                  f"at least the global count")
                if r["x_ideal"] > DRYRUN_X_IDEAL[r["arch"]]:
                    failed.append(f"{name}: x ideal {r['x_ideal']:.4f} above "
                                  f"{DRYRUN_X_IDEAL[r['arch']]}")
            else:
                result = json.loads(stdout.splitlines()[-1])
    finally:
        for *_, proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise SystemExit(f"phase 11: {failed}")
    print(f"-- 11b: phase 10's step on {SPMD_ARGS[1]} in a child: without a "
          f"mesh, losses {result['losses']} ({', '.join(f'{x:.1f}' for x in result['ms'])} ms); "
          f"on the (1, 1) mesh, parameters and AdamW state DTensors "
          f"({result['all_dtensor']}), losses {result['sharded_losses']} "
          f"({', '.join(f'{x:.1f}' for x in result['sharded_ms'])} ms); losses "
          f"and all {result['leaves']} parameter and AdamW leaves bit for bit "
          f"equal: {result['bitwise']} (largest difference "
          f"{result['max_abs_diff']:.3g}); AdamW kernel launches without and "
          f"on the mesh {result['adamw_launches']}; phase 10's own losses "
          f"{[round(x, 6) for x in spmd_losses]} (its run without "
          f"deterministic algorithms)")
    if not result["all_dtensor"]:
        raise SystemExit("11b: the sharded step's state is not all DTensors")
    n_steps = train.parser().parse_args(SPMD_ARGS).steps
    if result["adamw_launches"] != [n_steps, n_steps]:
        raise SystemExit(f"11b: AdamW kernel launches {result['adamw_launches']}"
                         f", want one a step, {n_steps} in each run")
    if not result["bitwise"] and result["max_abs_diff"] > SHARDED_TOL:
        raise SystemExit(f"11b: sharded and unsharded differ by "
                         f"{result['max_abs_diff']} > {SHARDED_TOL}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-identities", action="store_true",
                    help="run only phase 6b's bit-identity checks (the child "
                         "process phase 6b starts)")
    ap.add_argument("--harness-zero-churn", action="store_true",
                    help="run only phase 8's zero-churn checks (the child "
                         "process phase 8a starts)")
    ap.add_argument("--sharded-step", action="store_true",
                    help="run only phase 11b's sharded step (the child "
                         "process phase 11 starts)")
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
    if opts.sharded_step:
        return sharded_step()

    start = time.perf_counter()

    def took(phases: str):
        print(f"[phases {phases} done, {time.perf_counter() - start:.1f} s "
              f"into the script]")

    phase_device()
    flash_timings = phase_kernel()
    phase_kernel_sweep()
    ssd_timings = phase_ssd_kernel()
    adamw_timings = phase_adamw_kernel()
    decode_timings = phase_decode_attention_kernel()
    train_attention_timings = phase_flash_train_kernel()
    torch.cuda.empty_cache()
    took("1-3d")

    # each serve is one main path, counted from 0 with its model alone
    # on the card; the kernels line reports their sums
    launches = {"flash_attention": 0, "ssd_scan": 0, "adamw_update": 0,
                "decode_attention": 0, "flash_attention_bwd": 0}
    for arch in SERVE_ARCHS:
        for name, n in run_serve(arch).items():
            launches[name] += n
        torch.cuda.empty_cache()

    phase_gpu_vs_cpu()
    took("4-5")

    # training attends through the flash pair, once a layer of each stage
    # dispatch, and AdamW's kernel runs once a tree an update; the phases
    # check the counts, each counted from 0
    for phase in (phase_train, phase_train_checks, phase_train_vs_cpu,
                  phase_train_7b):
        for name, n in (phase() or {}).items():
            launches[name] += n
        torch.cuda.empty_cache()
    took("6-6d")

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

    # the examples: each cuda run a main path counted from 0
    torch.cuda.empty_cache()
    for name, n in phase_examples().items():
        launches[name] += n
    took("9")

    # --mode spmd: a main path counted from 0; AdamW's kernel once a step
    torch.cuda.empty_cache()
    spmd_launches, spmd_losses = phase_spmd()
    for name, n in spmd_launches.items():
        launches[name] += n
    torch.cuda.empty_cache()
    phase_spmd_vs_cpu()
    took("10-10b")

    # the launch layer: the dry runs and the sharded step in children
    torch.cuda.empty_cache()
    phase_launch(spmd_losses)
    took("11a-11b")

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
        # phase 3b's 7B cell: its three trees' device time, byte bound and
        # the plain version's time, summed
        dict(name="adamw_update", route="cuda",
             source="src/repro_torch/kernels/csrc/adamw.cu", replaces=None,
             launches=launches["adamw_update"], **adamw_timings),
        # phase 3c's decode cell; launches over phase 4's serves
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/decode_attention.cu",
             replaces=None, launches=launches["decode_attention"],
             **decode_timings),
        # phase 3d's GPT-like shape; launches (calls) over phases 6-6d, 10
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
             replaces=None, launches=launches["flash_attention_bwd"],
             **train_attention_timings),
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
