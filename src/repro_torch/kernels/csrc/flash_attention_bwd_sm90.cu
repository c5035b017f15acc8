// Flash-attention backward for Hopper (sm_90a) in bf16 on the tensor cores,
// plain C interface for ctypes.
//
// Replaces no TPU kernel: the JAX package's flash kernel has no backward,
// and its training stages differentiate `_online_attention`
// (src/repro/models/layers.py:125-176) with autograd.  This computes the
// gradient of that function for causal, optionally sliding-window
// self-attention, from the forward of flash_attention_sm90.cu run with its
// log-sum-exp (`flash_attention_fwd_lse`):
//   P = exp(S * scale - lse)            S = Q K^T, f32 from bf16 operands
//   dV = P^T dO                         P rounded to bf16, as the forward
//                                       (and the reference) round it
//   dP = dO V^T,  dS = P * (dP - D)     f32; D = rowsum(dO * O)
//   dQ = scale * dS K,  dK = scale * dS^T Q
// dS enters its two products split into three bf16 terms, hi + mid + lo,
// whose sum is its f32 value exactly; each product of a term with the bf16
// Q or K is exact in the f32 accumulator.  So dQ and dK take the f32 dS that
// autograd of the reference takes, and only the order of the sums differs.
//
// Layout.  q, o, dO, dQ are (B, S, H, D) and k, v, dK, dV (B, S, KH, D),
// contiguous bf16, each a TMA tensor map {D, heads, S, B} with box
// {64, 1, 64, 1} and 128-byte swizzle, as in the forward.  lse and D are
// f32 (B, H, S_pad), S_pad = S rounded up to 64, so that every 64-row tile
// of them is one 256-byte bulk copy.  Any S: TMA fills rows past S with
// zeros and drops them on store, and tiles that straddle S, the diagonal
// or the window's edge are masked.  D is 64 or 128.  GQA is native.
//
// Bound on the H100 (989 TFLOP/s bf16 dense).  At the GPT-like training
// shape, B = 8, S = 1,024, 16 heads of 64, the causal pairs are 8 * 16 *
// 1,024 * 1,025 / 2 = 67 M, and the backward runs 11 products of 2 * 64
// flops a pair (S and dP twice, dV, dS K and dS^T Q three times each):
// 94 GFLOP, ~95 us.  Its bytes (q, k, v, o, dO in; dQ, dK, dV out) are
// ~134 MB, ~40 us.  Operations bound it.
//
// Design.  Three kernels, none with atomics, so every gradient is summed
// in one fixed order and two runs are bit-equal:
//  * flash_bwd_delta_kernel: D = rowsum(dO * O) in f32, a row per D/8
//    threads reading 16 bytes each; rows past S get 0.
//  * flash_bwd_dkv_kernel: one warpgroup per (64-key tile, batch * KV
//    head), key tiles of most work first.  K and V stay in shared memory;
//    a two-stage TMA ring brings the Q and dO tiles (and lse and D with
//    them, by bulk copy) of every query head of the GQA group, from the
//    causal frontier to the window's end.  S^T = K Q^T and dP^T = V dO^T
//    are wgmma m64n64k16 with both operands K-major in shared memory, so the
//    accumulators' rows are keys; P^T and dS^T then feed dV += P^T dO and
//    dK += dS^T Q straight from registers as the A operand, with dO and Q
//    the MN-major B operand (transpose bit set), as the forward feeds P V.
//    dK and dV sum in registers over the whole group; the epilogue scales
//    dK, writes both as bf16 over K's and V's buffers and stores them by TMA.
//  * flash_bwd_dq_kernel: one warpgroup per (64-query tile, batch * head),
//    the forward's grid and ring: Q and dO stay, K and V tiles stream from
//    the window's edge to the causal frontier; S = Q K^T and dP = dO V^T,
//    then dQ += dS K with K the MN-major B operand.
// At D = 128 the dK/dV kernel holds 128 f32 accumulator registers a thread
// for dK and dV beside S and dP (64): it is the tighter of the two.

#include "sm90_flash_common.cuh"

namespace {

constexpr int BM = 64;            // rows of every tile: 64 queries or 64 keys
constexpr int THREADS = 128;      // one warpgroup
constexpr int ROW_BYTES = BM * 4; // one tile's f32 lse (or D) values
constexpr float LOG2E = 1.4426950408889634f;

// six tiles (K, V and two stages of Q and dO; or Q, dO and two stages of K
// and V), then two stages of lse and D; 1 KB to align the base to the
// 1024 bytes the swizzle repeats over
template <int D>
constexpr size_t smem_bytes() {
  return (size_t)6 * (D / 64) * BOX + 4 * ROW_BYTES + 1024;
}

// `bytes` contiguous bytes from global memory, 16-byte aligned both sides
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// byte offset of the 16-deep slice kk of a K-major tile
__device__ __forceinline__ uint32_t k_slice(int kk) {
  return (kk / 4) * BOX + (kk % 4) * 32;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) = hi + mid + lo exactly: three bf16 pairs of 8 significant bits
// each hold the 24 of an f32 (each remainder is exact in f32)
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  a -= hf.x;
  b -= hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(a, b);
  const float2 mf = __bfloat1622float2(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = pack_bf16(a - mf.x, b - mf.y);
}

// The A operand, 64 x 64 in registers as four 16-deep slices, from an
// accumulator: columns 16 kk .. 16 kk + 15 are its 8-column blocks 2 kk
// and 2 kk + 1
__device__ __forceinline__ void pack_operand(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

__device__ __forceinline__ void split_operand(const float (&x)[32], uint32_t (&hi)[4][4],
                                              uint32_t (&mid)[4][4], uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split3(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1], hi[kk][i], mid[kk][i], lo[kk][i]);
}

// acc[nb] += A B over the four 16-deep slices, for the split operand's
// three terms, smallest first; B MN-major at b_tile (NB boxes)
template <int NB>
__device__ __forceinline__ void mma_split(float (&acc)[NB][32], uint32_t (&hi)[4][4],
                                          uint32_t (&mid)[4][4], uint32_t (&lo)[4][4],
                                          uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_regs(hi[kk]);
    fence_regs(mid[kk]);
    fence_regs(lo[kk]);
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const uint64_t db = desc_mn_major(b_tile + nb * BOX + kk * 16 * 128);
      wgmma_rs(acc[nb], lo[kk], db);
      wgmma_rs(acc[nb], mid[kk], db);
      wgmma_rs(acc[nb], hi[kk], db);
    }
  wgmma_commit();
}

// d = A B^T over D, both K-major tiles in shared memory; committed as a group
template <int D>
__device__ __forceinline__ void mma_scores(float (&d)[32], uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(d, desc_k_major(a_tile + k_slice(kk)), desc_k_major(b_tile + k_slice(kk)), kk > 0);
  wgmma_commit();
}

// one accumulator (NB boxes) times scale, as bf16, into a swizzled tile of
// shared memory; rows r0 and r0 + 8 of this thread, first column c0
template <int NB>
__device__ __forceinline__ void stage_out(const float (&acc)[NB][32], float scale,
                                          uint8_t* tile, int r0, int c0, int lane) {
  const int sw = lane >> 2;  // row % 8 of both rows: the 16-byte chunk swizzle
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int chunk = ((j ^ sw) << 4) + 2 * c0;
      uint8_t* box = tile + nb * BOX;
      *reinterpret_cast<uint32_t*>(box + r0 * 128 + chunk) =
          pack_bf16(acc[nb][4 * j] * scale, acc[nb][4 * j + 1] * scale);
      *reinterpret_cast<uint32_t*>(box + (r0 + 8) * 128 + chunk) =
          pack_bf16(acc[nb][4 * j + 2] * scale, acc[nb][4 * j + 3] * scale);
    }
}

// D = rowsum(dO * O), f32 (B, H, S_pad); D / 8 threads a row, 16 bytes each
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
                       int S, int S_pad, int H, long long rows) {
  constexpr int LANES = D / 8;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t / LANES;  // over (b, s, h), s < S_pad
  const int part = (int)(t % LANES);
  const bool valid = row < rows;
  const int h = (int)(row % H);
  const long long bs = row / H;
  const int s = (int)(bs % S_pad);
  const int b = (int)(bs / S_pad);
  float acc = 0.f;
  if (valid && s < S) {
    const size_t off = (((size_t)b * S + s) * H + h) * D + part * 8;
    const uint4 ov = *reinterpret_cast<const uint4*>(o + off);
    const uint4 gv = *reinterpret_cast<const uint4*>(dout + off);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(op[i]);
      const float2 gf = __bfloat1622float2(gp[i]);
      acc = fmaf(of.x, gf.x, acc);
      acc = fmaf(of.y, gf.y, acc);
    }
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (valid && part == 0) delta[((size_t)b * H + h) * S_pad + s] = acc;
}

// dK and dV of one 64-key tile of one (batch, KV head), over every query
// head of its group and every query tile that attends to it
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap dk_map,
                     const __grid_constant__ CUtensorMap dv_map, const float* lse,
                     const float* delta, int S, int S_pad, int H, int KH, int window,
                     float scale_log2, float scale) {
  constexpr int NB = D / 64;
  constexpr int TILE = NB * BOX;
  __shared__ __align__(8) uint64_t full[3];  // K and V; then one per ring stage
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  // K, V, then stage s: Q at TILE (2 + 2 s), dO after it; lse and D of
  // stage s at 6 TILE + 2 ROW_BYTES s
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - raw);
  const uint32_t k_s = base;
  const uint32_t v_s = base + TILE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x / KH;
  const int kh = blockIdx.x - b * KH;
  const int kt = blockIdx.y;  // the first key tiles attend the most queries
  const int k0 = kt * BM;
  const int rep = H / KH;

  // query tiles that attend to these keys: from the causal frontier to the
  // window's end (queries q < k + window), for each of the group's heads
  int qt_last = S_pad / BM - 1;
  if (window > 0) qt_last = min(qt_last, (k0 + BM - 2 + window) / BM);
  const int per_head = qt_last - kt + 1;
  const int n_it = rep * per_head;

  const uint32_t bar_kv = smem_addr(&full[0]);  // stage s's barrier: bar_kv + 8 (1 + s)
  auto load_q = [&](int it, int stage) {
    const int h = kh * rep + it / per_head;
    const int q0 = (kt + it % per_head) * BM;
    const uint32_t bar = bar_kv + 8 * (1 + stage);
    const uint32_t q_dst = base + TILE * (2 + 2 * stage);
    const uint32_t row_dst = base + 6 * TILE + 2 * ROW_BYTES * stage;
    const size_t row = ((size_t)b * H + h) * S_pad + q0;
    mbar_expect_tx(bar, 2 * TILE + 2 * ROW_BYTES);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load(q_dst + nb * BOX, &q_map, bar, nb * 64, h, q0, b);
      tma_load(q_dst + TILE + nb * BOX, &do_map, bar, nb * 64, h, q0, b);
    }
    bulk_load(row_dst, lse + row, ROW_BYTES, bar);
    bulk_load(row_dst + ROW_BYTES, delta + row, ROW_BYTES, bar);
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_kv + 8, 1);
    mbar_init(bar_kv + 16, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_kv, 2 * TILE);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load(k_s + nb * BOX, &k_map, bar_kv, nb * 64, kh, k0, b);
      tma_load(v_s + nb * BOX, &v_map, bar_kv, nb * 64, kh, k0, b);
    }
    load_q(0, 0);
    if (n_it > 1) load_q(1, 1);
  }
  __syncthreads();

  // this thread's accumulator rows (keys) and first column in each
  // 8-column block (queries)
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const int kpos0 = k0 + r0;
  const int kpos1 = kpos0 + 8;

  float dk[NB][32], dv[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[nb][i] = dv[nb][i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    const int q0 = (kt + it % per_head) * BM;
    const uint32_t q_s = base + TILE * (2 + 2 * stage);
    const uint32_t do_s = q_s + TILE;
    const float* lse_t = reinterpret_cast<const float*>(base_ptr + 6 * TILE +
                                                        2 * ROW_BYTES * stage);
    const float* delta_t = lse_t + BM;
    mbar_wait(bar_kv + 8 * (1 + stage), (it >> 1) & 1);

    // S^T = K Q^T and dP^T = V dO^T, rows keys and columns queries
    float s[32], dp[32];
    mma_scores<D>(s, k_s, q_s);
    mma_scores<D>(dp, v_s, do_s);
    wgmma_wait<1>();
    fence_regs(s);

    // P^T = exp(S^T scale - lse), 0 where masked; masks only on tiles that
    // straddle the diagonal, the window's edge or S
    const bool edge = k0 + BM - 1 > q0 || q0 + BM > S ||
                      (window > 0 && k0 <= q0 + BM - 1 - window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse_t + 8 * j + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp2(s[4 * j + e] * scale_log2 - ((e & 1) ? l.y : l.x) * LOG2E);
        if (edge) {
          const int qp = q0 + 8 * j + c0 + (e & 1);
          const int kp = (e & 2) ? kpos1 : kpos0;
          bool keep = qp < S && kp <= qp;
          if (window > 0) keep = keep && kp > qp - window;
          if (!keep) p = 0.f;
        }
        s[4 * j + e] = p;
      }
    }

    // dV += P^T dO, P in bf16
    uint32_t pa[4][4];
    pack_operand(s, pa);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(dv[nb]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        wgmma_rs(dv[nb], pa[kk], desc_mn_major(do_s + nb * BOX + kk * 16 * 128));
    wgmma_commit();

    // dS^T = P^T (dP^T - D), f32
    wgmma_wait<1>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(delta_t + 8 * j + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d.y : d.x));
    }

    // dK += dS^T Q, dS split three ways
    uint32_t hi[4][4], mid[4][4], lo[4][4];
    split_operand(dp, hi, mid, lo);
    mma_split<NB>(dk, hi, mid, lo, q_s);
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      fence_regs(dk[nb]);
      fence_regs(dv[nb]);
    }

    // every warp is done with this stage: refill it with the tile two ahead
    __syncthreads();
    if (tid == 0 && it + 2 < n_it) load_q(it + 2, stage);
  }

  // epilogue: dK (times the softmax scale) and dV as bf16 over K's and V's
  // buffers, stored with TMA (rows past S dropped)
  stage_out<NB>(dk, scale, base_ptr, r0, c0, lane);
  stage_out<NB>(dv, 1.f, base_ptr + TILE, r0, c0, lane);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_store(&dk_map, k_s + nb * BOX, nb * 64, kh, k0, b);
      tma_store(&dv_map, v_s + nb * BOX, nb * 64, kh, k0, b);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// dQ of one 64-query tile of one (batch, head), over the key tiles it
// attends to
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap dq_map, const float* lse,
                    const float* delta, int S, int S_pad, int H, int KH, int window,
                    float scale_log2, float scale) {
  constexpr int NB = D / 64;
  constexpr int TILE = NB * BOX;
  __shared__ __align__(8) uint64_t full[2];  // one mbarrier per ring stage
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  // Q, dO, then stage s: K at TILE (2 + 2 s), V after it
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t do_s = base + TILE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / KH);
  const int q0 = qt * BM;

  // key tiles this query tile attends to: [kt_begin, kt_begin + n_tiles)
  const int q_last = min(q0 + BM, S) - 1;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = kv_begin / BM;
  const int n_tiles = q_last / BM + 1 - kt_begin;

  const uint32_t bar0 = smem_addr(&full[0]);  // stage s's barrier is bar0 + 8 s
  auto load_kv = [&](int it, int stage, uint32_t extra) {
    const int kv0 = (kt_begin + it) * BM;
    const uint32_t bar = bar0 + 8 * stage;
    const uint32_t dst = base + TILE * (2 + 2 * stage);
    mbar_expect_tx(bar, 2 * TILE + extra);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load(dst + nb * BOX, &k_map, bar, nb * 64, kh, kv0, b);
      tma_load(dst + TILE + nb * BOX, &v_map, bar, nb * 64, kh, kv0, b);
    }
  };

  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // Q and dO land on stage 0's barrier with the first K/V tile
    load_kv(0, 0, 2 * TILE);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load(q_s + nb * BOX, &q_map, bar0, nb * 64, h, q0, b);
      tma_load(do_s + nb * BOX, &do_map, bar0, nb * 64, h, q0, b);
    }
    if (n_tiles > 1) load_kv(1, 1, 0);
  }

  // this thread's rows (queries) and first column in each 8-column block
  // (keys); their lse (log2 units) and D
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const int qpos0 = q0 + r0;
  const int qpos1 = qpos0 + 8;
  const size_t row = ((size_t)b * H + h) * S_pad;
  const float lse0 = lse[row + qpos0] * LOG2E;
  const float lse1 = lse[row + qpos1] * LOG2E;
  const float d0 = delta[row + qpos0];
  const float d1 = delta[row + qpos1];
  __syncthreads();

  float dq[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[nb][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int kv0 = (kt_begin + it) * BM;
    const uint32_t k_s = base + TILE * (2 + 2 * stage);
    const uint32_t v_s = k_s + TILE;
    mbar_wait(bar0 + 8 * stage, (it >> 1) & 1);

    // S = Q K^T and dP = dO V^T
    float s[32], dp[32];
    mma_scores<D>(s, q_s, k_s);
    mma_scores<D>(dp, do_s, v_s);
    wgmma_wait<1>();
    fence_regs(s);

    // P = exp(S scale - lse), 0 where masked
    const bool edge = kv0 + BM > S || kv0 + BM - 1 > q0 ||
                      (window > 0 && kv0 <= q0 + BM - 1 - window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp2(s[4 * j + e] * scale_log2 - ((e & 2) ? lse1 : lse0));
        if (edge) {
          const int kp = kv0 + 8 * j + c0 + (e & 1);
          const int qp = (e & 2) ? qpos1 : qpos0;
          bool keep = kp < S && kp <= qp;
          if (window > 0) keep = keep && kp > qp - window;
          if (!keep) p = 0.f;
        }
        s[4 * j + e] = p;
      }

    // dS = P (dP - D), f32
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 2) ? d1 : d0));

    // dQ += dS K, dS split three ways
    uint32_t hi[4][4], mid[4][4], lo[4][4];
    split_operand(dp, hi, mid, lo);
    mma_split<NB>(dq, hi, mid, lo, k_s);
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(dq[nb]);

    // every warp is done with this stage: refill it with the tile two ahead
    __syncthreads();
    if (tid == 0 && it + 2 < n_tiles) load_kv(it + 2, stage, 0);
  }

  // epilogue: dQ times the softmax scale, as bf16 over Q's buffer, stored
  // with TMA (rows past S dropped)
  stage_out<NB>(dq, scale, base_ptr, r0, c0, lane);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) tma_store(&dq_map, q_s + nb * BOX, nb * 64, h, q0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// the seven maps: q, k, v, dO, dQ, dK, dV
enum { MQ, MK, MV, MDO, MDQ, MDK, MDV, NMAPS };

template <int D>
cudaError_t launch(const CUtensorMap (&m)[NMAPS], const void* o, const void* dout,
                   const float* lse, float* delta, int B, int S, int H, int KH, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // set once per instantiation, not on every launch (the port drives one card)
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr_dkv != cudaSuccess) return attr_dkv;
  if (attr_dq != cudaSuccess) return attr_dq;
  const int tiles = (S + BM - 1) / BM;
  const int S_pad = tiles * BM;
  const float scale_log2 = scale * LOG2E;

  const long long rows = (long long)B * S_pad * H;
  const long long threads = rows * (D / 8);
  flash_bwd_delta_kernel<D><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), delta, S,
      S_pad, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D><<<dim3(B * KH, tiles), THREADS, smem, stream>>>(
      m[MQ], m[MK], m[MV], m[MDO], m[MDK], m[MDV], lse, delta, S, S_pad, H, KH, window,
      scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<dim3(B * H, tiles), THREADS, smem, stream>>>(
      m[MQ], m[MK], m[MV], m[MDO], m[MDQ], lse, delta, S, S_pad, H, KH, window, scale_log2,
      scale);
  return cudaGetLastError();
}

}  // namespace

// The gradients of causal attention (window <= 0: none) with respect to q,
// k and v, from the forward's output o and log-sum-exp lse (f32 (B, H,
// S_pad), S_pad = S rounded up to 64, as flash_attention_fwd_lse writes
// it) and the output's gradient dout.  delta is f32 (B, H, S_pad) scratch.
// Three launches on `stream`.  Returns 0 on success, the cudaError_t of a
// refused launch, or minus the CUresult of a tensor map that could not be
// encoded.  The caller checks shapes, dtypes (bf16; lse, delta f32),
// contiguity, 16-byte aligned pointers and that H % KH == 0.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int B, int S, int H, int KH, int D,
                                   int window, float scale, void* stream) {
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  const cudaError_t bind = bind_context();
  if (bind != cudaSuccess) return (int)bind;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap maps[NMAPS];
  const void* ptrs[NMAPS] = {q, k, v, dout, dq, dk, dv};
  const int heads[NMAPS] = {H, KH, KH, H, H, KH, KH};
  for (int i = 0; i < NMAPS; ++i) {
    const CUresult res = make_map(encode, &maps[i], ptrs[i], B, S, heads[i], D);
    if (res != CUDA_SUCCESS) return -(int)res;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  if (D == 64) return launch<64>(maps, o, dout, l, d, B, S, H, KH, window, scale, st);
  return launch<128>(maps, o, dout, l, d, B, S, H, KH, window, scale, st);
}
