// Chunked Mamba2/SSD scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` in
// src/repro/kernels/ssd_scan.py:31 (driven by `ssd_scan_bhsp`, wrapped by
// `repro.kernels.ops.ssd_scan`).  It computes what the model's chunked SSD
// (`ssd_chunked` in src/repro/models/ssm.py, its oracle) computes, with an
// initial state h0, per (batch b, head h), chunk after chunk of Q = 64 rows:
//
//   L      = inclusive cumsum over the chunk of dt * A (f32)
//   M[t,s] = (C_t . B_s) * exp(L_t - L_s) * dt_s  for s <= t, else 0
//            (the exponent is never taken for s > t: it would overflow)
//   y_t    = sum_s M[t,s] x_s  +  exp(L_t) * (h C_t)
//   h     <- exp(L_end) h  +  sum_s exp(L_end - L_s) dt_s x_s (x) B_s
//
// y is written in x's dtype and the final h in f32.
//
// Layout.  x is (B, S, H, P), dt (B, S, H), Bm and Cm (B, S, N), read in
// place with the strides the caller passes (the last dimension of x, Bm and
// Cm is contiguous): in the model x, Bm and Cm are strided slices of the
// causal conv's output, so nothing is transposed or copied around the
// call.  Bm and Cm are shared across heads.  y is (B, S, H, P) contiguous;
// h0 (or null, for zeros) and h_final are (B, H, P, N) contiguous f32.  Any
// S works: rows of the last chunk past S load as x = B = C = dt = 0, which
// leaves L flat and adds nothing to h.  P <= 128 and N <= 128; x, Bm, Cm in
// f32 or bf16, dt and A in f32.  Tiles are copied with 16-byte cp.async, so
// the caller checks that x, Bm and Cm and all their strides but the last
// are 16-byte aligned.
//
// Bound on the H100 (SXM, 3.35 TB/s; 67 TFLOP/s f32 on the CUDA cores,
// 495 TFLOP/s TF32 on the tensor cores, so 165 TFLOP/s for 3xTF32).  At
// mamba2-130m's serving shape (B, S, H, P, N) = (8, 512, 24, 64, 128) in
// f32 the function moves about 67.5 MB (x, y, dt, B, C, h0, h_final),
// 20 us.  The causal pairs s <= t of a chunk, Q (Q + 1) / 2 = 2080, cost
// C B^T once per (b, chunk) (2 N a pair, 34 MFLOP, f32 on the CUDA cores,
// 0.5 us) and per (b, h) M x (2 P a pair), the state's output (2 S P N) and
// the state update (2 S P N): 3.63 GFLOP in 3xTF32, 22 us.  So operations
// bound it, at about 0.022 ms (0.055 ms at the CUDA cores' f32 rate).  At
// hymba-1.5b's (8, 512, 50, 64, 16): about 110 MB (33 us) against
// 1.70 GFLOP (10 us), so bytes bound it, at about 0.033 ms.
//
// Design, two kernels a call.
//  1. C B^T once per (b, chunk): `ssd_cb_kernel` writes the causal 64 x 64
//     f32 product of each chunk (zero above the diagonal and in rows past S)
//     to a (B, chunks, 64, 64) scratch buffer the wrapper allocates, 1 MB at
//     mamba2-130m's shape, which stays in L2.  B and C are shared across
//     heads, so the scan no longer forms it again for every head.
//  2. The card filled: rows p of the state are independent (h[p, :] reads
//     only x[:, p], y[:, p] only h[p, :]), so `ssd_scan_tf32_kernel` runs one
//     block of 8 warps per (b, h, tile of PT rows of P), its PT x N slice of
//     the state in shared memory for the whole sequence: 384 blocks at
//     mamba2-130m's shape, two an SM (waves of 264 and 120), 400 at
//     hymba-1.5b's, two an SM.  PT is 16, 32 or 64: the launch takes the
//     widest that holds two blocks an SM
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and is less than twice
//     P, since a block's time is mostly the fixed cost of its chunks, which
//     a wider tile spreads over more rows and a second block hides.
//  3. The three chunk products on the tensor cores in 3xTF32:
//     `mma.sync.m16n8k8` TF32 with fragments loaded from shared memory in
//     the layout each product needs (TF32 `wgmma` takes no transposed
//     operand, and x and B are not K-major for M x and (x w)^T B).  Each
//     f32 operand a is split into hi, a cut to TF32 (its low 13 bits
//     cleared), and lo = a - hi, and hi*hi + hi*lo + lo*hi is summed in f32
//     (two accumulators, so two chains of dependent mma): single-pass TF32
//     misses the f32 tolerance 25-fold at N = 128
//     (tests/test_torch_ssd_sm90.py), the split meets it.  The split is two
//     instructions; rounding hi with cvt.rna.tf32.f32 costs more, and
//     instructions, not the tensor cores, bound this kernel.
//     L is scanned in f32 with warp shuffles (point 4 says by whom).  M =
//     C B^T * exp(L_t - L_s) * dt_s is formed once for the block, in f32 and
//     in place of its C B^T tile (the exponent masked before exp), then split
//     as the fragments are loaded.  Warp w owns y's rows 16 (w % 4) .. + 15
//     and half of the PT columns: C h^T over N as soon as the chunk lands
//     (it needs neither L nor M; each row scaled by exp(L) afterwards), then,
//     after the block barrier that also ends every read of the old state,
//     M x over the 2 (w % 4) + 2 causal steps of 8 columns.  The state
//     update (x w)^T B runs on the (PT / 16) x (N / 8) tiles of h dealt
//     round the warps, each updating its own entries in place.  Row strides
//     of the tiles are padded so that the fragment loads hit 32 distinct
//     banks.
//  4. Loads in flight under compute: x, B, C, C B^T and dt come in 16-byte
//     cp.async copies (zero-filled past S, P and N), each stage completing
//     on its own mbarrier (cp.async.mbarrier.arrive), whose wait traps after
//     2^26 polls instead of hanging the card.  With two stages the next
//     chunk's copies are issued as soon as the chunk before is done with
//     their stage, under this chunk's products; where two stages fit only
//     one block an SM and one stage fits two (mamba2-130m's N = 128), the
//     block takes one stage and the other block on the SM computes while
//     it loads.  Two block barriers a chunk remain (three with one stage,
//     whose single copy of L waits for warp 0): before a stage is refilled
//     and the state read, and before M x and the state update.
// bf16 inputs take the same body: tiles land in shared memory in bf16 and
// are widened to f32 as the fragments are loaded.
//
// On the H100 this runs at about 7x its bound at mamba2-130m's shape and
// 3.4x at hymba-1.5b's: instruction issue and latency in the chunk phases
// (the splits, fragment loads, M's formation), not the tensor cores, take
// the time (tools/ssd_scan_ablation.py, PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;               // rows per chunk
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int CB_THREADS = 256;     // ssd_cb_kernel: a 16 x 16 grid of threads
constexpr int MAX_DIM = 128;        // largest P and N
constexpr int MAX_SMEM = 232448;    // a block's shared memory on the H100
constexpr int LDQ = Q + 4;          // row stride of the C B^T tile, in floats
constexpr int YW = WARPS / 4;       // warps on each 16 rows of y
constexpr int TPR = THREADS / Q;    // threads on each row of M
static_assert(WARPS % 4 == 0 && THREADS % Q == 0, "warps: 4 row tiles of y, rows of M");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
// two neighbours at an even offset in one store
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

struct Dims {
  int S, H, P, N;
  long long sxb, sxs, sxh;     // x strides (the last is 1)
  long long sdb, sds, sdh;     // dt strides
  long long sbb, sbs;          // Bm strides (the last is 1)
  long long scb, scs;          // Cm strides (the last is 1)
};

// One stage of the scan kernel's shared memory, in bytes: x (Q x PT),
// B (Q x NP), C (Q x NP) in T, C B^T (Q x Q) and dt (Q) in f32.  NP is N
// rounded up to 16, 32, 64 or 128.  The row strides make the fragment
// loads conflict-free: x and B are read as (s = lane % 4, column =
// lane / 4), so their strides are 8 mod 32 words; C, C B^T and the state
// as (row = lane / 4, k = lane % 4), so 4 mod 32.
template <typename T, int PT, int NP>
struct Tile {
  static constexpr int EPC = 16 / (int)sizeof(T);   // elements per 16-byte copy
  static constexpr int LDX = PT + 8;
  static constexpr int LDB = NP + 8;
  static constexpr int LDC = NP + EPC;              // keeps bf16 rows 16-byte aligned
  static constexpr int LDH = NP + 4;
  static constexpr int X_OFF = 0;
  static constexpr int B_OFF = X_OFF + Q * LDX * (int)sizeof(T);
  static constexpr int C_OFF = B_OFF + Q * LDB * (int)sizeof(T);
  static constexpr int CB_OFF = C_OFF + Q * LDC * (int)sizeof(T);
  static constexpr int DT_OFF = CB_OFF + Q * LDQ * 4;
  static constexpr int STAGE = DT_OFF + Q * 4;
};

// The block's shared memory with ST stages (1 or 2): the stages, the state
// (PT x NP f32), L, exp(L) and w (3 x Q f32) and the stages' mbarriers.
// With two stages each warp scans into its own copy of L, exp(L) and w;
// with one, warp 0 scans into one copy, which saves the memory a second
// block an SM needs at N = 128.
template <typename T, int PT, int NP, int ST>
struct Smem {
  static constexpr int H_OFF = ST * Tile<T, PT, NP>::STAGE;
  static constexpr int SCAN_OFF = H_OFF + PT * Tile<T, PT, NP>::LDH * 4;
  static constexpr int BAR_OFF = SCAN_OFF + (ST == 2 ? WARPS : 1) * 3 * Q * 4;
  static constexpr int BYTES = BAR_OFF + 16;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copies `bytes` (0 to 16) and zero-fills the rest of the 16
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// the barrier's phase completes when every thread's earlier copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// a copy that never lands traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t tries = 0;
  do {
    if (++tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// x = hi + lo: hi is x cut to TF32 (its low 13 bits cleared, one integer
// op), lo = x - hi exactly (one f32 op), which the tensor core reads at
// TF32 precision, losing at most 2^-21 of x; hi*hi + hi*lo + lo*hi then
// keeps about 2^-20 of each f32 product.  Rounding hi to nearest
// (cvt.rna.tf32.f32, or Veltkamp's three f32 ops) halves that error but
// costs two to three instructions more a split, and the splits are half
// the kernel's instructions: it took 12-27 % longer at the two serving
// shapes (tools/ssd_scan_ablation.py, PERF.md).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b and e += the small terms of a b, in 3xTF32: d + e at the end
// is hi*hi + hi*lo + lo*hi.  Two accumulators make two chains of
// dependent mma instead of one of three a step.  Fragments of m16n8k8 with
// g = lane / 4, t = lane % 4: a = (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); b = (t, g), (t + 4, g); d = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1), as (row, column).
__device__ __forceinline__ void mma3(float (&d)[4], float (&e)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(e, al, bh);
  mma_tf32(d, ah, bh);
  mma_tf32(e, ah, bl);
}

// C B^T of one (b, chunk), in f32 on the CUDA cores: 256 threads, each a
// 4 x 4 tile of rows tr + 16 i and columns tc + 16 j, over N in slices of 32
template <typename T>
__global__ void __launch_bounds__(CB_THREADS)
ssd_cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ cb,
              Dims d) {
  __shared__ float Cs[Q][33];
  __shared__ float Bs[Q][33];
  const int c = blockIdx.x, b = blockIdx.y, c0 = c * Q;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const T* Bb = Bm + b * d.sbb;
  const T* Cb = Cm + b * d.scb;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int n0 = 0; n0 < d.N; n0 += 32) {
    __syncthreads();
    for (int i = tid; i < Q * 32; i += CB_THREADS) {
      const int r = i >> 5, n = i & 31, s = c0 + r;
      const bool in = s < d.S && n0 + n < d.N;
      Cs[r][n] = in ? to_f32(Cb[s * d.scs + n0 + n]) : 0.f;
      Bs[r][n] = in ? to_f32(Bb[s * d.sbs + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int n = 0; n < 32; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = Cs[tr + 16 * i][n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[tc + 16 * j][n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
    }
  }
  float* out = cb + ((long long)b * gridDim.x + c) * Q * Q;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = tr + 16 * i, s = tc + 16 * j;
      out[t * Q + s] = s <= t ? acc[i][j] : 0.f;
    }
}

// one stage: the chunk at row c0 of x (PT columns from the block's first),
// B, C, its C B^T tile and dt, each 16-byte copy zero-filled where it runs
// past S, P or N; completes on `bar`
template <typename T, int PT, int NP>
__device__ __forceinline__ void load_chunk(unsigned char* st, uint32_t bar, const T* xb,
                                           int p_left, const T* Bb, const T* Cb,
                                           const float* cbc, const float* dtb, int c0,
                                           const Dims& d) {
  using L = Tile<T, PT, NP>;
  constexpr int EPC = L::EPC;
  constexpr int XCH = PT / EPC;   // copies a row of x
  constexpr int NCH = NP / EPC;   // copies a row of B or C
  const int tid = threadIdx.x;
  const uint32_t base = smem_addr(st);
  for (int i = tid; i < Q * XCH; i += THREADS) {
    const int r = i / XCH, p = (i - r * XCH) * EPC, s = c0 + r;
    const int n = s < d.S ? min(EPC, max(0, p_left - p)) : 0;
    cp_async16(base + L::X_OFF + (r * L::LDX + p) * (int)sizeof(T),
               n ? xb + s * d.sxs + p : xb, n * (int)sizeof(T));
  }
  for (int i = tid; i < Q * NCH; i += THREADS) {
    const int r = i / NCH, k = (i - r * NCH) * EPC, s = c0 + r;
    const int n = s < d.S ? min(EPC, max(0, d.N - k)) : 0;
    cp_async16(base + L::B_OFF + (r * L::LDB + k) * (int)sizeof(T),
               n ? Bb + s * d.sbs + k : Bb, n * (int)sizeof(T));
    cp_async16(base + L::C_OFF + (r * L::LDC + k) * (int)sizeof(T),
               n ? Cb + s * d.scs + k : Cb, n * (int)sizeof(T));
  }
  for (int i = tid; i < Q * (Q / 4); i += THREADS) {
    const int r = i / (Q / 4), k = (i - r * (Q / 4)) * 4;
    cp_async16(base + L::CB_OFF + (r * LDQ + k) * 4, cbc + r * Q + k, 16);
  }
  for (int r = tid; r < Q; r += THREADS) {
    const int s = c0 + r;
    cp_async4(base + L::DT_OFF + r * 4, s < d.S ? dtb + s * d.sds : dtb, s < d.S ? 4 : 0);
  }
  cp_async_arrive(bar);
}


template <typename T, int PT, int NP, int ST>
__global__ void __launch_bounds__(THREADS, 2)
ssd_scan_tf32_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const float* __restrict__ cb,
                     const float* __restrict__ h0, T* __restrict__ y,
                     float* __restrict__ hf, Dims d) {
  using L = Tile<T, PT, NP>;
  // y: warp w takes rows 16 (w % 4) .. + 15 and one YW-th of the columns
  constexpr int NT = PT / (8 * YW);                // its 8-column tiles
  static_assert(NT >= 1, "a tile of P rows narrower than the warps on y");
  // the state's 16 x 8 tiles: WN warps along N, WM along P
  constexpr int MT = PT / 16, NTN = NP / 8;
  constexpr int WN = WARPS < NTN ? WARPS : NTN;
  constexpr int WM = WARPS / WN;
  constexpr int MI = (MT + WM - 1) / WM;           // 16-row tiles a warp
  constexpr int NI = NTN / WN;                     // 8-column tiles a warp
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int P = d.P, N = d.N, S = d.S, H = d.H;
  const int tiles_p = (P + PT - 1) / PT;
  const int head = blockIdx.x / tiles_p;            // b * H + h
  const int p0 = (blockIdx.x - head * tiles_p) * PT;
  const int b = head / H, h = head - b * H;
  const int nc = (S + Q - 1) / Q;
  const float a = A[h];
  const T* xb = x + b * d.sxb + h * d.sxh + p0;
  const float* dtb = dt + b * d.sdb + h * d.sdh;
  const T* Bb = Bm + b * d.sbb;
  const T* Cb = Cm + b * d.scb;
  const float* cbb = cb + (long long)b * nc * Q * Q;
  T* yb = y + ((long long)b * S * H + h) * P + p0;
  const long long ys = (long long)H * P;           // y's stride between rows
  const bool even_p = (P & 1) == 0;                // pairs of y stay aligned
  const long long hoff = (long long)head * P * N;

  using M = Smem<T, PT, NP, ST>;
  float* Hs = reinterpret_cast<float*>(smem + M::H_OFF);
  float* Lw = reinterpret_cast<float*>(smem + M::SCAN_OFF) + (ST == 2 ? warp * 3 * Q : 0);
  float* eLw = Lw + Q;
  float* ww = eLw + Q;
  const uint32_t bar0 = smem_addr(smem + M::BAR_OFF);

  if (tid == 0) {
    mbar_init(bar0, THREADS);
    mbar_init(bar0 + 8, THREADS);
  }
  // the state slice, zero in its padding (columns past N, rows past P)
  for (int i = tid; i < PT * NP; i += THREADS) {
    const int p = i / NP, n = i - p * NP;
    Hs[p * L::LDH + n] =
        (h0 != nullptr && p0 + p < P && n < N) ? h0[hoff + (long long)(p0 + p) * N + n] : 0.f;
  }
  __syncthreads();
  load_chunk<T, PT, NP>(smem, bar0, xb, P - p0, Bb, Cb, cbb, dtb, 0, d);

  const int mt = warp & 3;            // this warp's rows of y: 16 mt .. + 15
  const int ra = 16 * mt + g, rb = ra + 8;
  const int y0 = (warp >> 2) * 8 * NT;  // ... and its first column
  const int wn = warp % WN, wm = warp / WN;
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q;
    const int stage = ST == 2 ? c & 1 : 0;
    if (c > 0) __syncthreads();  // chunk c - 1 is done with its stage and the state
    if constexpr (ST == 2) {     // chunk c + 1 loads while chunk c computes
      if (c + 1 < nc)
        load_chunk<T, PT, NP>(smem + (stage ^ 1) * L::STAGE, bar0 + 8 * (stage ^ 1), xb,
                              P - p0, Bb, Cb, cbb + (long long)(c + 1) * Q * Q, dtb, c0 + Q,
                              d);
      mbar_wait(bar0 + 8 * stage, (c >> 1) & 1);
    } else {                     // another block on the SM computes meanwhile
      if (c > 0)
        load_chunk<T, PT, NP>(smem, bar0, xb, P - p0, Bb, Cb, cbb + (long long)c * Q * Q, dtb,
                              c0, d);
      mbar_wait(bar0, c & 1);
    }
    const unsigned char* st = smem + stage * L::STAGE;
    const T* Xs = reinterpret_cast<const T*>(st + L::X_OFF);
    const T* Bs = reinterpret_cast<const T*>(st + L::B_OFF);
    const T* Cs = reinterpret_cast<const T*>(st + L::C_OFF);
    float* CBs = reinterpret_cast<float*>(smem + stage * L::STAGE + L::CB_OFF);
    const float* dts = reinterpret_cast<const float*>(st + L::DT_OFF);

    // y = exp(L) (C h^T) + M x on the warp's 16 rows and 8 NT columns:
    // C h^T first, as it needs neither L nor M
    float acc[NT][4], acx[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = acx[j][i] = 0.f;
    {
#pragma unroll
      for (int k0 = 0; k0 < NP; k0 += 8) {    // zero past N
        uint32_t ah[4], al[4];
        split(to_f32(Cs[ra * L::LDC + k0 + t]), ah[0], al[0]);
        split(to_f32(Cs[rb * L::LDC + k0 + t]), ah[1], al[1]);
        split(to_f32(Cs[ra * L::LDC + k0 + t + 4]), ah[2], al[2]);
        split(to_f32(Cs[rb * L::LDC + k0 + t + 4]), ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* hr = Hs + (y0 + 8 * j + g) * L::LDH + k0 + t;
          uint32_t bh[2], bl[2];
          split(hr[0], bh[0], bl[0]);
          split(hr[4], bh[1], bl[1]);
          mma3(acc[j], acx[j], ah, al, bh, bl);
        }
      }
    }

    if (ST == 2 || warp == 0) {  // inclusive scan of dt * A: lane l holds rows l, l + 32
      const float d0 = dts[lane], d1 = dts[lane + 32];
      float v0 = d0 * a, v1 = d1 * a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, off);
        if (lane >= off) { v0 += u0; v1 += u1; }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      const float last = __shfl_sync(0xffffffffu, v1, 31);
      Lw[lane] = v0;
      Lw[lane + 32] = v1;
      eLw[lane] = expf(v0);
      eLw[lane + 32] = expf(v1);
      ww[lane] = expf(last - v0) * d0;
      ww[lane + 32] = expf(last - v1) * d1;
    }
    if constexpr (ST == 2) {
      __syncwarp();
    } else {
      __syncthreads();
    }

    // M = C B^T * exp(L_t - L_s) * dt_s in place of C B^T, once for the
    // block: thread i takes row i / TPR, Q / TPR columns from
    // (i % TPR) Q / TPR (C B^T is zero above the diagonal; the exponent is
    // masked before exp)
    {
      constexpr int CPT = Q / TPR;   // a multiple of 4: whole float4s
      const int t_row = tid / TPR, s_col = CPT * (tid % TPR);
      float4* Mrow = reinterpret_cast<float4*>(CBs + t_row * LDQ + s_col);
      const float4* Ls4 = reinterpret_cast<const float4*>(Lw + s_col);
      const float4* ds4 = reinterpret_cast<const float4*>(dts + s_col);
      const float Lt = Lw[t_row];
      float m[CPT], Ls[CPT], ds[CPT];   // all loads before any store
#pragma unroll
      for (int k = 0; k < CPT / 4; ++k) {
        *reinterpret_cast<float4*>(m + 4 * k) = Mrow[k];
        *reinterpret_cast<float4*>(Ls + 4 * k) = Ls4[k];
        *reinterpret_cast<float4*>(ds + 4 * k) = ds4[k];
      }
      if (s_col <= t_row) {   // else the C B^T loaded is zero already
#pragma unroll
        for (int k = 0; k < CPT; ++k)
          m[k] = s_col + k <= t_row ? m[k] * expf(Lt - Ls[k]) * ds[k] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < CPT / 4; ++k) Mrow[k] = *reinterpret_cast<const float4*>(m + 4 * k);
    }

    {  // the state's part of y scales by exp(L) of its row
      const float ea = eLw[ra], eb = eLw[rb];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[j][i] *= i < 2 ? ea : eb;
          acx[j][i] *= i < 2 ? ea : eb;
        }
    }
    __syncthreads();  // M is formed, and every warp has read the old state

    {  // M x over the causal columns s <= 16 mt + 15: 2 mt + 2 steps of 8
#pragma unroll
      for (int ks = 0; ks < Q / 8; ++ks) {
        if (ks > 2 * mt + 1) break;
        const int s0 = 8 * ks + t, s1 = s0 + 4;
        uint32_t ah[4], al[4];
        split(CBs[ra * LDQ + s0], ah[0], al[0]);
        split(CBs[rb * LDQ + s0], ah[1], al[1]);
        split(CBs[ra * LDQ + s1], ah[2], al[2]);
        split(CBs[rb * LDQ + s1], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bh[2], bl[2];
          split(to_f32(Xs[s0 * L::LDX + y0 + 8 * j + g]), bh[0], bl[0]);
          split(to_f32(Xs[s1 * L::LDX + y0 + 8 * j + g]), bh[1], bl[1]);
          mma3(acc[j], acx[j], ah, al, bh, bl);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int p = y0 + 8 * j + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = c0 + (half ? rb : ra);
        if (s < S) {
          T* yr = yb + s * ys + p;
          const float v0 = acc[j][2 * half] + acx[j][2 * half];
          const float v1 = acc[j][2 * half + 1] + acx[j][2 * half + 1];
          if (even_p && p0 + p + 1 < P) {
            store2(yr, v0, v1);   // a warp writes 32 whole bytes a row
          } else {
            if (p0 + p < P) store(yr, v0);
            if (p0 + p + 1 < P) store(yr + 1, v1);
          }
        }
      }
    }

    // h <- exp(L_end) h + (x w)^T B on the warp's MI x NI tiles of the
    // state: rows 16 (wm + WM i), columns 8 (wn + WN j)
    float hacc[MI][NI][4], hacx[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) hacc[i][j][k] = hacx[i][j][k] = 0.f;
#pragma unroll
    for (int ks = 0; ks < Q / 8; ++ks) {
      const int s0 = 8 * ks + t, s1 = s0 + 4;
      const float w0 = ww[s0], w1 = ww[s1];
      uint32_t bh[NI][2], bl[NI][2];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = 8 * (wn + WN * j) + g;
        split(to_f32(Bs[s0 * L::LDB + n]), bh[j][0], bl[j][0]);
        split(to_f32(Bs[s1 * L::LDB + n]), bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int mi = wm + WM * i;
        if (MT % WM == 0 || mi < MT) {
          const int pa = 16 * mi + g;
          uint32_t ah[4], al[4];
          split(to_f32(Xs[s0 * L::LDX + pa]) * w0, ah[0], al[0]);
          split(to_f32(Xs[s0 * L::LDX + pa + 8]) * w0, ah[1], al[1]);
          split(to_f32(Xs[s1 * L::LDX + pa]) * w1, ah[2], al[2]);
          split(to_f32(Xs[s1 * L::LDX + pa + 8]) * w1, ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < NI; ++j) mma3(hacc[i][j], hacx[i][j], ah, al, bh[j], bl[j]);
        }
      }
    }
    const float decay = eLw[Q - 1];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int mi = wm + WM * i;
      if (MT % WM == 0 || mi < MT) {
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          float* h_a = Hs + (16 * mi + g) * L::LDH + 8 * (wn + WN * j) + 2 * t;
          float* h_b = h_a + 8 * L::LDH;
          h_a[0] = decay * h_a[0] + (hacc[i][j][0] + hacx[i][j][0]);
          h_a[1] = decay * h_a[1] + (hacc[i][j][1] + hacx[i][j][1]);
          h_b[0] = decay * h_b[0] + (hacc[i][j][2] + hacx[i][j][2]);
          h_b[1] = decay * h_b[1] + (hacc[i][j][3] + hacx[i][j][3]);
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < PT * N; i += THREADS) {
    const int p = i / N, n = i - p * N;
    if (p0 + p < P) hf[hoff + (long long)(p0 + p) * N + n] = Hs[p * L::LDH + n];
  }
}

struct Args {
  const void *x, *dt, *A, *Bm, *Cm, *h0;
  void *cb, *y, *hf;
  int B;
  cudaStream_t stream;
};

// How a call runs: rows of P a block, stages, blocks per SM, blocks,
// shared memory.
struct Plan {
  int pt, stages, per_sm, grid, smem;
};

template <typename T, int PT, int NP, int ST>
constexpr bool fits() {
  return Smem<T, PT, NP, ST>::BYTES <= MAX_SMEM && PT >= 8 * YW;
}

// blocks of this instantiation an SM holds (0 if it does not fit); the
// shared-memory attribute is set once per instantiation, not every launch
// (the port drives one card)
template <typename T, int PT, int NP, int ST>
int blocks_per_sm() {
  if constexpr (!fits<T, PT, NP, ST>()) {
    return 0;
  } else {
    static const int per_sm = [] {
      constexpr int smem = Smem<T, PT, NP, ST>::BYTES;
      int n = 0;
      if (cudaFuncSetAttribute(ssd_scan_tf32_kernel<T, PT, NP, ST>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem) != cudaSuccess ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &n, ssd_scan_tf32_kernel<T, PT, NP, ST>, THREADS, smem) != cudaSuccess)
        return 0;
      return n;
    }();
    return per_sm;
  }
}

template <typename T, int NP, int ST>
Plan plan_st(int pt, int B, int H, int P) {
  Plan pl{pt, ST, 0, B * H * ((P + pt - 1) / pt), 0};
  switch (pt) {
    case 16:
      pl.per_sm = blocks_per_sm<T, 16, NP, ST>();
      pl.smem = Smem<T, 16, NP, ST>::BYTES;
      break;
    case 32:
      pl.per_sm = blocks_per_sm<T, 32, NP, ST>();
      pl.smem = Smem<T, 32, NP, ST>::BYTES;
      break;
    case 64:
      pl.per_sm = blocks_per_sm<T, 64, NP, ST>();
      pl.smem = Smem<T, 64, NP, ST>::BYTES;
      break;
    default:
      break;
  }
  return pl;
}

// Two stages keep the next chunk's loads under this chunk's products; one
// stage leaves them to another block on the SM.  So a tile takes two
// stages if two blocks an SM fit so, one stage if only then two fit, and
// else two stages if one block fits, else one.
template <typename T, int NP>
Plan plan_for(int pt, int B, int H, int P) {
  const Plan two = plan_st<T, NP, 2>(pt, B, H, P);
  if (two.per_sm >= 2) return two;
  const Plan one = plan_st<T, NP, 1>(pt, B, H, P);
  return one.per_sm >= 2 || two.per_sm == 0 ? one : two;
}

// The widest tile that holds two blocks an SM and is less than twice P,
// else the widest that fits, else the narrowest.  A block's time is mostly
// its chunks' fixed cost (the loads of B, C and C B^T, the dependent chain
// of each product), which a wider tile shares over more rows, and a second
// block on the SM hides; on the H100 this pick ran fastest at both serving
// shapes, though it leaves the last wave partly empty (PERF.md,
// tools/ssd_scan_ablation.py)
template <typename T, int NP>
Plan choose(int B, int H, int P) {
  const int widths[3] = {64, 32, 16};
  Plan fitting{0, 0, 0, 0, 0}, narrowest{0, 0, 0, 0, 0};
  for (int pt : widths) {
    const Plan pl = plan_for<T, NP>(pt, B, H, P);
    if (pl.per_sm == 0) continue;
    if (pt >= 2 * P) {
      narrowest = pl;
    } else if (pl.per_sm >= 2) {
      return pl;
    } else if (fitting.per_sm == 0) {
      fitting = pl;
    }
  }
  return fitting.per_sm > 0 ? fitting : narrowest;
}

template <typename T, int PT, int NP, int ST>
cudaError_t launch_scan(const Args& a, const Dims& d, const Plan& pl) {
  if constexpr (!fits<T, PT, NP, ST>()) {
    return cudaErrorInvalidValue;
  } else {
    ssd_scan_tf32_kernel<T, PT, NP, ST><<<pl.grid, THREADS, pl.smem, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const float*>(a.dt),
        static_cast<const float*>(a.A), static_cast<const T*>(a.Bm),
        static_cast<const T*>(a.Cm), static_cast<const float*>(a.cb),
        static_cast<const float*>(a.h0), static_cast<T*>(a.y), static_cast<float*>(a.hf), d);
    return cudaGetLastError();
  }
}

template <typename T, int PT, int NP>
cudaError_t launch_st(const Args& a, const Dims& d, const Plan& pl) {
  return pl.stages == 2 ? launch_scan<T, PT, NP, 2>(a, d, pl)
                        : launch_scan<T, PT, NP, 1>(a, d, pl);
}

template <typename T, int NP>
cudaError_t run(const Args& a, const Dims& d) {
  const Plan pl = choose<T, NP>(a.B, d.H, d.P);
  if (pl.per_sm == 0) return cudaErrorInvalidValue;
  const dim3 cb_grid((d.S + Q - 1) / Q, a.B);
  ssd_cb_kernel<T><<<cb_grid, CB_THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.Bm), static_cast<const T*>(a.Cm), static_cast<float*>(a.cb), d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (pl.pt) {
    case 16: return launch_st<T, 16, NP>(a, d, pl);
    case 32: return launch_st<T, 32, NP>(a, d, pl);
    default: return launch_st<T, 64, NP>(a, d, pl);
  }
}

// N rounded up to 16, 32, 64 or 128
int padded(int n) {
  int np = 16;
  while (np < n) np *= 2;
  return np;
}

template <typename T>
cudaError_t run_np(const Args& a, const Dims& d) {
  switch (padded(d.N)) {
    case 16: return run<T, 16>(a, d);
    case 32: return run<T, 32>(a, d);
    case 64: return run<T, 64>(a, d);
    default: return run<T, 128>(a, d);
  }
}

template <typename T>
Plan plan_np(int B, int H, int P, int N) {
  switch (padded(N)) {
    case 16: return choose<T, 16>(B, H, P);
    case 32: return choose<T, 32>(B, H, P);
    case 64: return choose<T, 64>(B, H, P);
    default: return choose<T, 128>(B, H, P);
  }
}

bool valid(int P, int N, int dtype) {
  return P >= 1 && P <= MAX_DIM && N >= 1 && N <= MAX_DIM && (dtype == 0 || dtype == 1);
}

}  // namespace

// Fills out[5] with the plan a call with these sizes would run: rows of P
// a block, stages, blocks per SM (0: the tile does not fit), blocks of the
// scan kernel, its shared memory in bytes.  dtype as for ssd_scan_fwd.
extern "C" int ssd_scan_plan(int B, int H, int P, int N, int dtype, int* out) {
  if (!valid(P, N, dtype)) return (int)cudaErrorInvalidValue;
  const Plan pl = dtype == 0 ? plan_np<float>(B, H, P, N) : plan_np<__nv_bfloat16>(B, H, P, N);
  out[0] = pl.pt;
  out[1] = pl.stages;
  out[2] = pl.per_sm;
  out[3] = pl.grid;
  out[4] = pl.smem;
  return 0;
}

// Returns the cudaError_t of the launches (0 on success).  dtype (of x, Bm,
// Cm and y): 0 = f32, 1 = bf16.  h0 may be null (zero initial state).  cb
// is f32 scratch of B * ceil(S / 64) * 64 * 64 floats.  Strides are in
// elements.  The caller checks shapes, dtypes, the last-dim
// strides, 16-byte alignment, P <= 128 and N <= 128.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* h0, void* cb,
                            void* y, void* hf, int B, int S, int H, int P, int N,
                            long long sxb, long long sxs, long long sxh,
                            long long sdb, long long sds, long long sdh,
                            long long sbb, long long sbs, long long scb,
                            long long scs, int dtype, void* stream) {
  if (!valid(P, N, dtype)) return (int)cudaErrorInvalidValue;
  const Dims d{S, H, P, N, sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, scb, scs};
  const Args a{x, dt, A, Bm, Cm, h0, cb, y, hf, B, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return run_np<float>(a, d);
  return run_np<__nv_bfloat16>(a, d);
}
