#!/usr/bin/env python3
"""How the f32 flash body's sizes were chosen.

    python3 tools/flash_f32_tuning.py

from the root of a checkout, on a machine with an NVIDIA GPU and nvcc.
It builds altered copies of ``src/repro_torch/kernels/csrc/flash_attention.cu``
through ``KernelLibrary``, all at once, each with one head dim's
``Config<D>`` replaced by a candidate (row warps RW, warps splitting the
head dim DS, groups of warps over the KV tiles KS, keys a tile BK, Q split
in registers or f32 in shared memory, blocks an SM asked of ptxas), and prints each copy's ptxas registers and spills and its device
time per call (``timing.device_ms``) at ``chip_smoke.py``'s phase 2 f32
cases of that head dim, and at one shape a head dim that fills the card,
each held against the plain version at the f32 tolerance and printed with
its largest error; SDPA's device time stands beside each shape.  A
candidate whose shared memory exceeds a block's 227 KB is left out.
"""
from __future__ import annotations

import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from chip_smoke import KERNEL_CASES  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.build import BUILD_ROOT, KernelLibrary  # noqa: E402
from repro_torch.kernels.timing import card_line, device_ms, show  # noqa: E402

OUT = BUILD_ROOT / "flash_f32_tuning"
TOL = 2e-4
SMEM_LIMIT = 232448          # bytes of shared memory a block can use
# (RW, DS, KS, BK, Q split in registers, MIN_BLOCKS) per head dim; the
# first is the kernel's
CANDIDATES = {
    64: [(2, 1, 2, 32, True, 2), (4, 1, 2, 32, True, 1), (2, 2, 2, 32, True, 2),
         (2, 1, 2, 32, False, 2), (2, 1, 4, 32, True, 1), (2, 1, 2, 64, True, 1)],
    128: [(2, 1, 2, 16, False, 2), (2, 2, 2, 16, False, 1), (2, 1, 4, 16, False, 1),
          (2, 2, 2, 32, False, 1), (4, 1, 2, 16, False, 1)],
    256: [(2, 2, 2, 16, False, 1), (2, 1, 2, 16, False, 1), (2, 2, 2, 8, False, 2),
          (2, 2, 4, 8, False, 1), (4, 2, 2, 8, False, 1)],
}
# beside phase 2's f32 cases, a shape a head dim that fills the card
FULL = {64: (8, 512, 16, 16, 64), 128: (4, 512, 16, 16, 128),
        256: (4, 512, 16, 16, 256)}


def smem_bytes(D, RW, DS, KS, BK, q_regs, _blocks) -> int:
    """Layout<D>::BYTES of csrc/flash_attention.cu."""
    ring = 2 * KS * BK * ((D + 8) + (D + 4))
    merge = (KS - 1) * RW * DS * 32 * (D // DS // 2 + 4)
    q = 0 if q_regs else 16 * RW * (D + 8)
    swap = KS * RW * DS * 32 * (BK // 2) if DS > 1 else 0
    return 4 * (max(ring, merge) + q + swap)


def variant_source(src: str, D: int, cfg) -> str:
    RW, DS, KS, BK, q_regs, blocks = cfg
    body = (f"struct Config<{D}> {{\n  static constexpr int RW = {RW}, DS = {DS}, "
            f"KS = {KS}, BK = {BK}, MIN_BLOCKS = {blocks};\n  static constexpr "
            f"bool Q_REGS = {'true' if q_regs else 'false'};\n}};")
    new, n = re.subn(rf"struct Config<{D}> \{{.*?\}};", body, src, flags=re.S)
    if n != 1:
        raise SystemExit(f"Config<{D}> not found once in flash_attention.cu")
    return new


def ptxas(library: KernelLibrary, D: int) -> str:
    """The ptxas lines of flash_fwd_kernel<D> in the copy's build log."""
    lines, mine = [], False
    for line in library.build_log.splitlines():
        if "Compiling entry function" in line:
            mine = f"flash_fwd_kernelILi{D}E" in line
        elif mine and ("registers" in line or "spill" in line):
            lines.append(line.split(":")[-1].strip())
    # a source built before this run (the kernel's own, by chip_smoke.py)
    # left no log here
    return "; ".join(lines) or "in the earlier build's log"


def inputs(shape, seed):
    B, S, H, KH, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(B, S, heads, D, generator=g, device="cuda")
            for heads in (H, KH, KH)]


def sdpa(q, k, v, causal, window):
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    if window is None:
        return lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=gqa)
    S = q.shape[1]
    pos = torch.arange(S, device="cuda")
    mask = pos[None, :] > pos[:, None] - window
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    return lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=gqa)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_f32_tuning: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in f32
    OUT.mkdir(parents=True, exist_ok=True)
    src = fa.LIBRARY.source.read_text()
    variants, built = [], {}     # a copy equal to another shares its build
    for D, configs in CANDIDATES.items():
        for cfg in configs:
            if smem_bytes(D, *cfg) > SMEM_LIMIT:
                print(f"D={D} {cfg}: {smem_bytes(D, *cfg)} B of shared memory, "
                      f"left out")
                continue
            text = variant_source(src, D, cfg)
            if text not in built:
                source = OUT / f"flash_attention_v{len(built)}.cu"
                source.write_text(text)
                built[text] = KernelLibrary("flash_attention", fa._bind,
                                            source=source)
            variants.append((D, cfg, built[text]))
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(KernelLibrary.build, built.values()))
    print(f"card: {card_line()}")
    cases = {D: [(name, shape, causal, window) for name, shape, dtype, causal,
                 window, _ in KERNEL_CASES
                 if dtype == torch.float32 and shape[4] == D]
             + [("fills the card", FULL[D], True, None)] for D in CANDIDATES}
    for D, shapes in cases.items():
        print(f"== D = {D}")
        data = {}
        for i, (name, shape, causal, window) in enumerate(shapes):
            q, k, v = inputs(shape, i)
            want = ops.flash_attention_plain(q, k, v, causal=causal, window=window)
            data[name] = (q, k, v, causal, window, want)
            print(f"  {name} {shape} window={window}: sdpa "
                  f"{show(device_ms(sdpa(q, k, v, causal, window), reps=20))}")
        for d, cfg, library in variants:
            if d != D:
                continue
            times = []
            for name, (q, k, v, causal, window, want) in data.items():
                run = lambda: fa.launch(q, k, v, causal=causal,  # noqa: E731
                                        window=window, library=library)
                out = run()
                torch.testing.assert_close(out, want, rtol=TOL, atol=TOL)
                err = (out - want).abs().max().item()
                times.append(f"{name} {show(device_ms(run, reps=20))} "
                             f"(err {err:.3g})")
            print(f"  RW={cfg[0]} DS={cfg[1]} KS={cfg[2]} BK={cfg[3]} Q in "
                  f"{'registers' if cfg[4] else 'shared memory'} MIN_BLOCKS={cfg[5]}, "
                  f"{smem_bytes(D, *cfg)} B shared, ptxas "
                  f"{ptxas(library, D)}: " + "; ".join(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
