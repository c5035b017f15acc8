#!/usr/bin/env python3
"""Where the SSD scan kernel's time goes, and how its launch plan was chosen.

    python3 tools/ssd_scan_ablation.py

from the root of a checkout, on a machine with an NVIDIA GPU and nvcc.
It builds altered copies of ``src/repro_torch/kernels/csrc/ssd_scan.cu``
through ``KernelLibrary``, all at once, and prints each copy's plan (P
rows a block, stages, blocks per SM) and device time per call
(``timing.device_ms``) at ``mamba2-130m``'s and ``hymba-1.5b``'s packed
serving shapes, in f32 as the model runs them.  Copies of three kinds:

- one part of the work removed each (their results are wrong; only their
  times count);
- the launch's pick pinned: a tile of 16, 32 or 64 P rows, or one or two
  stages of loads;
- the split's hi part rounded to nearest, with ``cvt.rna.tf32.f32`` or
  with Veltkamp's three f32 operations, where the kernel cuts it.

Every copy that keeps the work is also held against the plain version at
the kernel's f32 tolerance, and its largest error printed.  A copy whose
anchor text is no longer in the source stops the run: update the anchor
with the kernel.
"""
from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels.build import BUILD_ROOT, KernelLibrary  # noqa: E402
from repro_torch.kernels.timing import card_line, device_ms, show  # noqa: E402

OUT = BUILD_ROOT / "ablation"
SHAPES = {"mamba2-130m": (8, 512, 24, 64, 128),   # (B, S, H, P, N)
          "hymba-1.5b": (8, 512, 50, 64, 16)}
TOL = 2e-3                                        # chip_smoke.py's f32 SSD tolerance

# the regions a copy leaves out, as (first line, text just past the end)
M_FORM = ("      if (s_col <= t_row) {",
          "#pragma unroll\n      for (int k = 0; k < CPT / 4; ++k) Mrow[k]")
STATE_OUT = ("#pragma unroll\n      for (int k0 = 0; k0 < NP; k0 += 8) {",
             "    }\n\n    if (ST == 2 || warp == 0) {  // inclusive scan")
M_X = ("#pragma unroll\n      for (int ks = 0; ks < Q / 8; ++ks) {\n"
       "        if (ks > 2 * mt + 1) break;",
       "    }\n#pragma unroll\n    for (int j = 0; j < NT; ++j) {\n      const int p = y0")
UPDATE = ("#pragma unroll\n    for (int ks = 0; ks < Q / 8; ++ks) {\n"
          "      const int s0 = 8 * ks + t, s1 = s0 + 4;\n      const float w0",
          "    const float decay")
PRODUCTS = (M_FORM, STATE_OUT, M_X, UPDATE)
# text replaced, as (old, new)
NO_SHARED_LOADS = (("i < Q * NCH; i += THREADS", "i < 0; i += THREADS"),
                   ("i < Q * (Q / 4); i += THREADS", "i < 0; i += THREADS"))
NO_Y_STORES = (("        if (s < S) {\n          T* yr = yb + s * ys + p;",
                "        if (false) {\n          T* yr = yb + s * ys + p;"),)
CB_ONLY = (("float* __restrict__ hf, Dims d) {\n  using L = Tile<T, PT, NP>;",
            "float* __restrict__ hf, Dims d) {\n  return;\n  using L = Tile<T, PT, NP>;"),)
SPLIT = ("  hi = __float_as_uint(x) & 0xFFFFE000u;\n"
         "  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));")
CVT_SPLIT = ((SPLIT,
              "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(hi) : \"f\"(x));\n"
              "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(lo)"
              " : \"f\"(x - __uint_as_float(hi)));"),)
VELTKAMP_SPLIT = ((SPLIT,
                   "  const float t = __fmul_rn(x, 8193.f);\n"
                   "  const float h = __fsub_rn(t, __fsub_rn(t, x));\n"
                   "  hi = __float_as_uint(h);\n"
                   "  lo = __float_as_uint(__fsub_rn(x, h));"),)


def pin_tile(rows: int):
    head = "Plan choose(int B, int H, int P) {\n"
    return ((head, f"{head}  return plan_for<T, NP>({rows}, B, H, P);\n"),)


def pin_stages(stages: int):
    head = "Plan plan_for(int pt, int B, int H, int P) {\n"
    return ((head, f"{head}  return plan_st<T, NP, {stages}>(pt, B, H, P);\n"),)


# name: (regions cut, text swapped, keeps the work)
VARIANTS = {
    "kernel": ((), (), True),
    "without forming M": ((M_FORM,), (), False),
    "without C h^T": ((STATE_OUT,), (), False),
    "without M x": ((M_X,), (), False),
    "without the state update": ((UPDATE,), (), False),
    "without M and the three products": (PRODUCTS, (), False),
    "... and without B, C, C B^T loads": (PRODUCTS, NO_SHARED_LOADS, False),
    "... and without y stores": (PRODUCTS, NO_SHARED_LOADS + NO_Y_STORES, False),
    "C B^T kernel only": ((), CB_ONLY, False),
    "kernel, tile pinned to 16 P rows": ((), pin_tile(16), True),
    "kernel, tile pinned to 32 P rows": ((), pin_tile(32), True),
    "kernel, tile pinned to 64 P rows": ((), pin_tile(64), True),
    "kernel, one stage": ((), pin_stages(1), True),
    "kernel, two stages": ((), pin_stages(2), True),
    "kernel, hi rounded by cvt.rna": ((), CVT_SPLIT, True),
    "kernel, hi rounded by Veltkamp's split": ((), VELTKAMP_SPLIT, True),
}


def anchor(src: str, text: str, start: int = 0) -> int:
    i = src.find(text, start)
    if i < 0:
        raise SystemExit(f"anchor not in ssd_scan.cu: {text[:60]!r}")
    return i


def variant_source(src: str, cuts, swaps) -> str:
    for first, after in cuts:
        i = anchor(src, first)
        j = anchor(src, after, i)
        src = src[:i] + "#if 0\n" + src[i:j] + "#endif\n" + src[j:]
    for old, new in swaps:
        anchor(src, old)
        src = src.replace(old, new)
    return src


def variant_library(index: int, cuts, swaps) -> KernelLibrary:
    source = OUT / f"ssd_scan_v{index}.cu"
    source.write_text(variant_source(ssd.LIBRARY.source.read_text(), cuts, swaps))
    return KernelLibrary("ssd_scan", ssd._bind, source=source)


def packed_inputs(shape, seed: int = 1):
    """x, B and C split from one tensor as ``apply_mamba`` passes them, a
    zero initial state as the serving cache passes it."""
    B, S, H, P, N = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    conv_out = torch.randn(B, S, H * P + 2 * N, generator=g, device="cuda")
    xs, Bm, Cm = torch.split(conv_out, [H * P, N, N], dim=-1)
    dt = F.softplus(torch.randn(B, S, H, generator=g, device="cuda"))
    A = -torch.exp(torch.randn(H, generator=g, device="cuda"))
    return xs.reshape(B, S, H, P), dt, A, Bm, Cm, torch.zeros(B, H, P, N, device="cuda")


def measure(library: KernelLibrary, args, want, keeps_work: bool) -> str:
    B, S, H, P = args[0].shape
    plan = ssd.plan(B, H, P, args[3].shape[-1], args[0].dtype, library=library)
    if plan["blocks_per_sm"] == 0:
        return "does not fit"
    run = lambda: ssd.launch(*args, library=library)  # noqa: E731
    text = (f"{plan['tile_p']} rows, {plan['stages']} st, {plan['blocks']} blocks, "
            f"{plan['blocks_per_sm']} a SM, {show(device_ms(run, reps=20))}")
    if keeps_work:
        (y, hf), (yr, hfr) = run(), want
        torch.testing.assert_close(y, yr, rtol=TOL, atol=TOL)
        torch.testing.assert_close(hf, hfr, rtol=TOL, atol=TOL)
        err = max((y - yr).abs().max().item(), (hf - hfr).abs().max().item())
        text += f", err {err:.3g}"
    return text


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_scan_ablation: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in f32
    OUT.mkdir(parents=True, exist_ok=True)
    libraries = [variant_library(i, cuts, swaps)
                 for i, (cuts, swaps, _) in enumerate(VARIANTS.values())]
    with ThreadPoolExecutor(len(libraries)) as pool:
        list(pool.map(KernelLibrary.build, libraries))
    print(f"card: {card_line()}")
    inputs = {name: packed_inputs(shape) for name, shape in SHAPES.items()}
    want = {name: ops.ssd_scan_plain(*args[:5], h0=args[5])
            for name, args in inputs.items()}
    print("device ms a call, f32 packed: " + ", ".join(SHAPES))
    for (name, (_, _, keeps_work)), library in zip(VARIANTS.items(), libraries):
        print(f"  {name}: " + "; ".join(
            measure(library, args, want[shape], keeps_work)
            for shape, args in inputs.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
