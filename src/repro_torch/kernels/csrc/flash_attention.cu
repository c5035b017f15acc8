// Flash-attention forward in f32 for Hopper (sm_90a), its two products on
// the tensor cores in 3xTF32, plain C interface for ctypes.
//
// Replaces, for f32 inputs, the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py (driven by `flash_attention_bhsd`,
// wrapped by `repro.kernels.ops.flash_attention`); bf16 inputs, the
// serving path's, go to the wgmma kernel in flash_attention_sm90.cu.  It
// computes the same function: causal, optionally sliding-window softmax
// attention with an online softmax whose running max `m`, sum `l` and
// accumulator `acc` stay in f32; q is scaled by D**-0.5 (with log2(e)
// folded in, for exp2) before Q K^T; masked scores are -1e30; the output
// is acc / max(l, 1e-30).
//
// Layout.  q is (B, S, H, D) and k, v are (B, S, KH, D), all contiguous,
// exactly as the model holds them, so no transpose happens around the call.
// GQA is native: query head h reads KV head h / (H / KH), with no repeated
// copy of K and V.  Any S works: rows and keys past S are masked, where the
// TPU kernel asserted S % block == 0.  D is 64, 128 or 256.
//
// Precision.  Q K^T and P V run as mma.sync.m16n8k8 in 3xTF32: each f32
// operand is split into hi, cut to TF32, and lo = x - hi, exact in f32;
// hi*hi + hi*lo + lo*hi keeps about 2^-20 of each product, far inside the
// f32 tolerance (2e-4) the kernel is held to, where single-pass TF32
// (2^-11 of each operand) misses it.  P is split like the other operands;
// the row sum l adds the unsplit f32 P.
//
// Bound on the H100 (SXM, 3.35 TB/s; 495 TFLOP/s TF32 dense, so 165 for
// the three passes of 3xTF32, against 67 TFLOP/s f32 on the CUDA cores).
// The causal work, 4 * D * S (S + 1) / 2 per (batch, head), bounds it: at
// B*H = 16, S = 512, D = 64 that is 0.54 GFLOP, 3.3 us at 165 TFLOP/s and
// 8.0 us at 67, against 8.4 MB, 2.5 us.  The splits, the softmax and the
// shared-memory fragment loads run on the CUDA cores beside the products.
//
// Design.  A block is RW x DS x KS warps over one (batch*head, tile of
// 16 RW query rows).  Each warp owns 16 query rows, the M of the mma; at
// D = 256 two warps share them (DS = 2), each with half the head dim, of
// Q K^T's reduction and of the output, so that the accumulator is 64 f32
// registers a thread, not 128; they add their partial scores through
// shared memory in the same order behind a named barrier, so both hold the
// same scores, maxima and sums.  The KS groups of RW x DS warps split the
// block's KV tiles between them (group j takes tiles j, j + KS, ...), so
// the longest causal row's chain of tiles is 1/KS as long; at the end the
// groups' (m, l, acc) are merged through shared memory.  The grid puts
// batch*head on x and the query tile on y, counted from the last, so the
// heaviest causal tiles of every head start first.  The block walks KV
// tiles from the window's edge to the causal frontier only, and a warp
// skips any tile none of its rows attends, so fully masked tiles cost
// nothing; masking runs only on tiles that straddle a boundary.
//   K and V tiles of BK keys come in on a two-slot ring of 16-byte
// cp.async copies (zero-filled past S), each slot one tile per group: the
// next step's tiles load while this step's multiply.  K rows are strided
// D + 8 floats, so each lane's B fragment of Q K^T is one conflict-free
// 8-byte load; V rows D + 4.
//   Scores.  The reduction index of Q K^T (d) is permuted within each
// k-step so that a lane's two K values (and two Q values) are adjacent:
// A/B fragment slot t holds d = 2t, slot t + 4 holds d = 2t + 1.  Two
// accumulators per 8-key n-tile (hi*hi, and the small terms) keep two
// chains of dependent mma a step instead of one of three.  The online
// softmax runs on the accumulator fragments in registers: a lane holds
// rows g = lane / 4 and g + 8, each reduced over the 4 lanes that share it
// with two shfl_xor; l stays a per-lane partial sum until the end, since
// the rescale is uniform across a row, and the rescale is skipped when no
// row's maximum moved.
//   P V without a shared-memory round trip: an m16n8k8 C fragment holds
// keys (2t, 2t + 1) of its n-tile, an A fragment keys (t, t + 4).  Instead
// of shuffling P, the key index of P V is permuted the same way: A slot t
// is key 2t and slot t + 4 key 2t + 1, so P's C fragment {c0, c1, c2, c3}
// is the A fragment {c0, c2, c1, c3} as it stands, and the B fragment
// reads V rows 2t and 2t + 1 (conflict-free at stride D + 4).  The
// reduction index is the key, so the product is unchanged.
//   Q is scaled once per block.  At D = 64 each lane holds its Q split
// into hi and lo in registers (D of them); at D = 128 and 256 Q lives in
// shared memory in f32 (stride D + 8), split at each use, two
// instructions a value, since split it would take twice the shared
// memory.  K and V are split in registers after their shared-memory
// loads.
//   Sizes (RW, DS, KS, BK; threads; shared memory; registers a thread, as
// ptxas reports them, no spills; blocks an SM), each picked by
// tools/flash_f32_tuning.py: D = 64: 2, 1, 2, 32; 128 threads; 70 KB;
// 191; two, by registers.  D = 128: 2, 1, 2, 16; 128; 84 KB; 147; two.
// D = 256: 2, 2, 2, 16; 256; 172 KB; 149; one.  The grid at the phase 8b
// cohorts (B*H = 16-64, S = 512, D = 64) is 256-1024 blocks.
//   What holds it back: the heaviest query tile streams its whole KV prefix
// through one SM, with one or two warps a sub-core to hide the mma and
// shared-memory latencies; splitting a tile's KV range across blocks is
// the next step (ROADMAP Queue 2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// RW row warps of 16 query rows; DS warps splitting the head dim of each
// 16 rows, the Q K^T reduction and the output columns alike; KS groups of
// RW x DS warps over the KV tiles; BK keys a tile; Q split in registers
// (or f32 in shared memory); MIN_BLOCKS asked of ptxas
template <int D>
struct Config;
template <>
struct Config<64> {
  static constexpr int RW = 2, DS = 1, KS = 2, BK = 32, MIN_BLOCKS = 2;
  static constexpr bool Q_REGS = true;
};
template <>
struct Config<128> {
  static constexpr int RW = 2, DS = 1, KS = 2, BK = 16, MIN_BLOCKS = 2;
  static constexpr bool Q_REGS = false;
};
template <>
struct Config<256> {
  static constexpr int RW = 2, DS = 2, KS = 2, BK = 16, MIN_BLOCKS = 1;
  static constexpr bool Q_REGS = false;
};

template <int D>
struct Layout {
  using C = Config<D>;
  static constexpr int THREADS = 32 * C::RW * C::DS * C::KS;
  static constexpr int BQ = 16 * C::RW;       // query rows a block
  static constexpr int DW = D / C::DS;        // head-dim columns a warp owns
  static constexpr int LDK = D + 8;           // floats between K rows
  static constexpr int LDV = D + 4;           // floats between V rows
  static constexpr int LDQ = D + 8;           // floats between Q rows
  static constexpr int TILE = C::BK * (LDK + LDV);   // one K and one V tile
  static constexpr int SLOT = C::KS * TILE;          // one tile per group
  // the merge: each warp of groups 1.. leaves acc (DW/2 a lane), m and l,
  // in the ring's place
  static constexpr int MERGE = DW / 2 + 4;
  static constexpr int MERGE_FLOATS = (C::KS - 1) * C::RW * C::DS * 32 * MERGE;
  static constexpr int Q_OFF = 2 * SLOT > MERGE_FLOATS ? 2 * SLOT : MERGE_FLOATS;
  // the DS warps of 16 rows swap their partial scores (BK/2 a lane)
  static constexpr int X_OFF = Q_OFF + (C::Q_REGS ? 0 : BQ * LDQ);
  static constexpr int X_FLOATS = C::DS > 1 ? C::KS * C::RW * C::DS * 32 * (C::BK / 2) : 0;
  static constexpr int FLOATS = X_OFF + X_FLOATS;
  static constexpr size_t BYTES = (size_t)FLOATS * sizeof(float);
  static_assert(C::BK % 8 == 0 && DW % 8 == 0, "whole mma tiles");
  static_assert(SLOT % 4 == 0 && Q_OFF % 4 == 0, "16-byte copies");
  static_assert(C::DS == 1 || C::KS * C::RW <= 15, "a named barrier a warp set");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copies `bytes` (0 or 16) and zero-fills the rest of the 16
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest `N` has landed (for this thread's copies)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo: hi is x cut to TF32 (its low 13 bits cleared, one integer
// op), lo = x - hi exactly (one f32 op), which the tensor core reads at
// TF32 precision, losing at most 2^-21 of x; hi*hi + hi*lo + lo*hi then
// keeps about 2^-20 of each f32 product.  (The same split as ssd_scan.cu;
// copied, since the build hashes each source alone.)
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

// Fragments of m16n8k8 with g = lane / 4, t = lane % 4, as (row, column):
// a = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b = (t, g), (t + 4, g);
// c = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).

// one step's tiles (one a group, fewer at the end) into `slot`, rows past S
// zero-filled
template <int D>
__device__ __forceinline__ void load_step(float* slot, const float* kb, const float* vb,
                                          long long kv_stride, int tile0, int tiles, int S) {
  using C = Config<D>;
  using L = Layout<D>;
  constexpr int CH = D / 4;   // 16-byte copies a row
  const uint32_t base = smem_addr(slot);
  for (int i = threadIdx.x; i < tiles * C::BK * CH; i += L::THREADS) {
    const int tile = i / (C::BK * CH);
    const int rem = i - tile * (C::BK * CH);
    const int r = rem / CH, c = (rem - r * CH) * 4;
    const int s = (tile0 + tile) * C::BK + r;
    const bool in = s < S;
    const long long off = in ? s * kv_stride + c : 0;
    const uint32_t dst = base + (uint32_t)(tile * L::TILE) * 4u;
    cp_async16(dst + (uint32_t)(r * L::LDK + c) * 4u, kb + off, in ? 16 : 0);
    cp_async16(dst + (uint32_t)(C::BK * L::LDK + r * L::LDV + c) * 4u, vb + off,
               in ? 16 : 0);
  }
}

// bar.sync on one of the named barriers 1-15, for `threads` threads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int D>
__global__ void __launch_bounds__(Layout<D>::THREADS, Config<D>::MIN_BLOCKS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int S, int H, int KH, int causal, int window, float scale_log2) {
  using C = Config<D>;
  using L = Layout<D>;
  constexpr int BK = C::BK;
  constexpr int NT = BK / 8;      // n-tiles of Q K^T, k-steps of P V
  constexpr int DT = L::DW / 8;   // the warp's k-steps of Q K^T, n-tiles of P V
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rw = warp % C::RW;                 // the warp's 16 rows in the block
  const int ds = (warp / C::RW) % C::DS;       // its share of the head dim
  const int grp = warp / (C::RW * C::DS);      // its group of KV tiles
  const int d0 = ds * L::DW;                   // its first head-dim column
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kh = h / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::BQ;   // heaviest first
  const long long q_stride = (long long)H * D;     // between sequence positions
  const long long kv_stride = (long long)KH * D;
  const float* qb = q + ((long long)b * S * H + h) * D;
  const float* kb = k + ((long long)b * S * KH + kh) * D;
  const float* vb = v + ((long long)b * S * KH + kh) * D;
  float* ob = o + ((long long)b * S * H + h) * D;
  const int r0 = q0 + 16 * rw;    // the warp's first row
  const int ra = r0 + g;          // the lane's rows: ra and ra + 8

  // KV tiles the block needs: [kt0, kt0 + n_tiles), in steps of KS
  const int q_last = min(q0 + L::BQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt0 = kv_begin / BK;
  const int n_tiles = (kv_end + BK - 1) / BK - kt0;
  const int n_steps = (n_tiles + C::KS - 1) / C::KS;

  load_step<D>(smem, kb, vb, kv_stride, kt0, min(C::KS, n_tiles), S);
  cp_async_commit();

  // Q, scaled: split in A-fragment order, qh/ql[ks] = rows (ra, ra + 8) at
  // d = d0 + ks*8 + 2t and + 1; or all of the block's Q in shared memory
  uint32_t qh[C::Q_REGS ? DT : 1][4], ql[C::Q_REGS ? DT : 1][4];
  float* Qs = smem + L::Q_OFF;
  if constexpr (C::Q_REGS) {
#pragma unroll
    for (int ks = 0; ks < DT; ++ks) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = ra + 8 * half;
        float2 x = make_float2(0.f, 0.f);
        if (row < S)
          x = *reinterpret_cast<const float2*>(qb + row * q_stride + d0 + ks * 8 + 2 * t);
        split(x.x * scale_log2, qh[ks][half], ql[ks][half]);
        split(x.y * scale_log2, qh[ks][2 + half], ql[ks][2 + half]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < L::BQ * D / 4; i += L::THREADS) {
      const int r = i / (D / 4), c = (i - r * (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < S) x = *reinterpret_cast<const float4*>(qb + (q0 + r) * q_stride + c);
      x.x *= scale_log2;
      x.y *= scale_log2;
      x.z *= scale_log2;
      x.w *= scale_log2;
      *reinterpret_cast<float4*>(Qs + r * L::LDQ + c) = x;
    }
  }

  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};   // this lane's part of each row's sum
  float acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dn][i] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      const int next = (step + 1) * C::KS;
      load_step<D>(smem + ((step + 1) & 1) * L::SLOT, kb, vb, kv_stride, kt0 + next,
                   min(C::KS, n_tiles - next), S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // this step's tiles (and Q) are in shared memory

    const int tile = step * C::KS + grp;
    const int k0 = (kt0 + tile) * BK;
    // the warp's rows attend some key of the tile (the same for its DS
    // warps, which meet at a named barrier below)
    const bool needed = tile < n_tiles && r0 < S && (!causal || k0 <= r0 + 15) &&
                        (window <= 0 || k0 + BK - 1 > r0 - window);
    if (needed) {
      const float* Ks = smem + (step & 1) * L::SLOT + grp * L::TILE;
      const float* Vs = Ks + BK * L::LDK;

      // S = Q K^T (log2 units) over the warp's head-dim columns: sd the
      // hi*hi terms, se the small ones, two chains of dependent mma a
      // k-step instead of one of three
      float sd[NT][4], se[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sd[nt][i] = se[nt][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DT; ++ks) {
        const int d = d0 + ks * 8 + 2 * t;
        uint32_t ah[4], al[4];
        if constexpr (C::Q_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah[i] = qh[ks][i];
            al[i] = ql[ks][i];
          }
        } else {
          const float* qr = Qs + (16 * rw + g) * L::LDQ + d;
          const float2 x = *reinterpret_cast<const float2*>(qr);
          const float2 y = *reinterpret_cast<const float2*>(qr + 8 * L::LDQ);
          split(x.x, ah[0], al[0]);
          split(y.x, ah[1], al[1]);
          split(x.y, ah[2], al[2]);
          split(y.y, ah[3], al[3]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 kv = *reinterpret_cast<const float2*>(Ks + (nt * 8 + g) * L::LDK + d);
          uint32_t bh[2], bl[2];
          split(kv.x, bh[0], bl[0]);
          split(kv.y, bh[1], bl[1]);
          mma_tf32(se[nt], al, bh);
          mma_tf32(sd[nt], ah, bh);
          mma_tf32(se[nt], ah, bl);
        }
      }

      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = sd[nt][i] + se[nt][i];
      if constexpr (C::DS > 1) {
        // the DS partial sums, added in the same order by each of the DS
        // warps, so that all hold the same scores, maxima and sums
        float* xs = smem + L::X_OFF + (grp * C::RW + rw) * C::DS * 32 * (BK / 2);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) xs[(ds * (BK / 2) + nt * 4 + i) * 32 + lane] = s[nt][i];
        named_sync(1 + grp * C::RW + rw, 32 * C::DS);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float sum = xs[(nt * 4 + i) * 32 + lane];
#pragma unroll
            for (int j = 1; j < C::DS; ++j) sum += xs[(j * (BK / 2) + nt * 4 + i) * 32 + lane];
            s[nt][i] = sum;
          }
      }

      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > r0) ||
                        (window > 0 && k0 <= r0 + 15 - window);
      if (edge) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = ra + 8 * (i >> 1);
            const int key = k0 + nt * 8 + 2 * t + (i & 1);
            bool keep = key < S;
            if (causal) keep = keep && key <= row;
            if (window > 0) keep = keep && key > row - window;
            if (!keep) s[nt][i] = NEG_INF;
          }
      }

      // online softmax over the rows ra (c0, c1) and ra + 8 (c2, c3)
      float alpha[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = NEG_INF;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mx = fmaxf(mx, fmaxf(s[nt][2 * half], s[nt][2 * half + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[half], mx);
        alpha[half] = exp2f(m[half] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float p = exp2f(s[nt][2 * half + j] - m_new);
            s[nt][2 * half + j] = p;
            rs += p;
          }
        l[half] = alpha[half] * l[half] + rs;
        m[half] = m_new;
      }
      // (exp2(0) is exactly 1: once the row maxima settle, nothing changes)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int dn = 0; dn < DT; ++dn) {
          acc[dn][0] *= alpha[0];
          acc[dn][1] *= alpha[0];
          acc[dn][2] *= alpha[1];
          acc[dn][3] *= alpha[1];
        }
      }

      // acc += P V over the warp's columns, k-step nt over the keys of P's
      // n-tile nt, permuted: A slot t is key 2t, slot t + 4 key 2t + 1
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t ph[4], pl[4];
        split(s[nt][0], ph[0], pl[0]);
        split(s[nt][2], ph[1], pl[1]);
        split(s[nt][1], ph[2], pl[2]);
        split(s[nt][3], ph[3], pl[3]);
        const float* vr = Vs + (nt * 8 + 2 * t) * L::LDV + d0 + g;
#pragma unroll
        for (int dn = 0; dn < DT; ++dn) {
          uint32_t bh[2], bl[2];
          split(vr[dn * 8], bh[0], bl[0]);
          split(vr[L::LDV + dn * 8], bh[1], bl[1]);
          mma_tf32(acc[dn], pl, bh);
          mma_tf32(acc[dn], ph, bl);
          mma_tf32(acc[dn], ph, bh);
        }
      }
    }
    __syncthreads();   // this slot is free for the step after next
  }

  // the groups' (m, l, acc) merged into group 0's, through the free ring
  if constexpr (C::KS > 1) {
    if (grp > 0) {
      float* mine = smem + (((grp - 1) * C::DS + ds) * C::RW + rw) * 32 * L::MERGE;
#pragma unroll
      for (int dn = 0; dn < DT; ++dn)
#pragma unroll
        for (int i = 0; i < 4; ++i) mine[(dn * 4 + i) * 32 + lane] = acc[dn][i];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mine[(L::DW / 2 + half) * 32 + lane] = m[half];
        mine[(L::DW / 2 + 2 + half) * 32 + lane] = l[half];
      }
    }
    __syncthreads();
    if (grp > 0) return;
#pragma unroll 1
    for (int j = 1; j < C::KS; ++j) {
      const float* other = smem + (((j - 1) * C::DS + ds) * C::RW + rw) * 32 * L::MERGE;
      float sa[2], sb[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float mo = other[(L::DW / 2 + half) * 32 + lane];
        const float lo = other[(L::DW / 2 + 2 + half) * 32 + lane];
        const float m_new = fmaxf(m[half], mo);
        sa[half] = exp2f(m[half] - m_new);
        sb[half] = exp2f(mo - m_new);
        l[half] = sa[half] * l[half] + sb[half] * lo;
        m[half] = m_new;
      }
#pragma unroll
      for (int dn = 0; dn < DT; ++dn)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[dn][i] = sa[i >> 1] * acc[dn][i] + sb[i >> 1] * other[(dn * 4 + i) * 32 + lane];
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    const int row = ra + 8 * half;
    if (row < S) {
      const float denom = fmaxf(l[half], 1e-30f);
#pragma unroll
      for (int dn = 0; dn < DT; ++dn)
        *reinterpret_cast<float2*>(ob + row * q_stride + d0 + dn * 8 + 2 * t) =
            make_float2(acc[dn][2 * half] / denom, acc[dn][2 * half + 1] / denom);
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, int B,
                   int S, int H, int KH, int causal, int window, float scale_log2,
                   cudaStream_t stream) {
  using L = Layout<D>;
  // set once per instantiation, not on every launch (the port drives one card)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (S + L::BQ - 1) / L::BQ);
  flash_fwd_kernel<D><<<grid, L::THREADS, L::BYTES, stream>>>(q, k, v, o, S, H, KH, causal,
                                                               window, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  f32 only.  window
// <= 0 means no window.  The caller checks shapes, dtypes, contiguity,
// 16-byte aligned pointers and that H % KH == 0.
extern "C" int flash_attention_fwd(const float* q, const float* k, const float* v,
                                   float* o, int B, int S, int H, int KH, int D,
                                   int causal, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * LOG2E;
  if (D == 64) return launch<64>(q, k, v, o, B, S, H, KH, causal, window, scale_log2, st);
  if (D == 128) return launch<128>(q, k, v, o, B, S, H, KH, causal, window, scale_log2, st);
  if (D == 256) return launch<256>(q, k, v, o, B, S, H, KH, causal, window, scale_log2, st);
  return (int)cudaErrorInvalidValue;
}
