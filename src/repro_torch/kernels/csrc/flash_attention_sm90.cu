// Flash-attention forward for Hopper (sm_90a) in bf16 on the tensor cores,
// plain C interface for ctypes.
//
// Replaces, for bf16 inputs, the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py (driven by `flash_attention_bhsd`,
// wrapped by `repro.kernels.ops.flash_attention`); f32 inputs go to the
// CUDA-core kernel in flash_attention.cu.  It computes the same function:
// causal, optionally sliding-window softmax attention with an online
// softmax whose running max `m`, sum `l` and accumulator `acc` stay in
// f32; masked scores are -1e30; the output is acc / max(l, 1e-30) in bf16.
//
// Layout.  q is (B, S, H, D) and k, v are (B, S, KH, D), contiguous bf16,
// as the model holds them.  Each is described to the Tensor Memory
// Accelerator (TMA) as a 4-D tensor map with dims {D, heads, S, B}, box
// {64, 1, 64, 1} and 128-byte swizzle, so no transpose happens around the
// call; a tile at D = 128 or 256 is two or four 64-column boxes.  GQA is
// native: query head h reads KV head h / (H / KH).  Any S: TMA fills rows
// past S with zeros, keys at or past S are masked (a zero K row scores 0,
// not -inf), and the TMA store of the output drops rows past S.  D is 64,
// 128 or 256.
//
// Bound on the H100 (SXM, 3.35 TB/s, 989 TFLOP/s bf16 dense).  At the
// serving shape B*H = 128, S = 512, D = 64, q, k, v and o are
// 4 * 128 * 512 * 64 * 2 B = 33.6 MB, about 10 us at 3.35 TB/s; the causal
// work is 4 * D * S (S + 1) / 2 * B*H = 4.3 GFLOP, about 4.4 us at
// 989 TFLOP/s.  Bytes bound it, at ~10 us.
//
// Design.  One warpgroup (128 threads) per (batch*head, 64 query rows);
// the grid puts batch*head on x and the query tile on y, counted from the
// last, so the heaviest causal tiles of every head start first.  Shared
// memory holds Q (8 KB at D = 64) and a two-stage ring of K and V tiles
// (2 x 16 KB), about 41 KB, so several blocks share an SM; at D = 256 the
// five 32 KB tiles take 161 KB, and one block fills an SM.  Thread 0 loads
// Q and the first two K/V tiles with TMA onto one mbarrier per stage, and
// refills a stage with the tile two ahead as soon as the warpgroup is done
// with it, so the next tile's copy overlaps this tile's products.  The
// block walks KV tiles from the window's edge to the causal frontier only;
// masking (causal, window, ragged) runs only on tiles that straddle a
// boundary.
//   S = Q K^T is wgmma m64n64k16 with both operands K-major in shared
// memory (D/16 steps).  The scale D^-0.5, with log2(e) folded in for
// exp2, multiplies the f32 scores; at D = 64 and 256 it is 2^-3 and 2^-4,
// so this equals the reference's scaling of q.  m, l and the rescale stay in registers in
// the accumulator's row layout (rows warp*16 + lane/4 and +8, each reduced
// over the 4 lanes that share it).  P is rounded to bf16 in registers and
// fed to O += P V as the A operand of wgmma m64n64k16 straight from the
// score accumulator's layout, without going through shared memory; V is
// the B operand, MN-major (D contiguous), transpose bit set, one n64
// product per 64-column box of V.  At D = 256 the accumulator O is 128 f32
// registers a thread, beside the 32 of the scores and the 16 of P in bf16,
// under the 255 that __launch_bounds__(128) allows.  The epilogue
// writes acc / max(l, 1e-30) as bf16 into Q's swizzled buffer and stores
// it with TMA.
//   Rounding: the JAX kernel multiplies P in f32 (flash_attention.py:76-77);
// rounding P to bf16 before P V is the one new rounding point here.
//   Training (flash_attention_fwd_lse, D = 64 and 128) runs the same body
// with a compile-time flag that also stores each row's log-sum-exp, from
// which the backward (flash_attention_bwd_sm90.cu) recomputes P; the
// serving kernel is the body without it, instruction for instruction.
// The building blocks both files use are in sm90_flash_common.cuh.

#include "sm90_flash_common.cuh"

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per KV tile
constexpr int THREADS = 128;      // one warpgroup
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Q, then K and V of stage 0, then K and V of stage 1, each D/64 boxes;
// 1 KB more to align the base to the 1024 bytes the swizzle repeats over
template <int D>
constexpr size_t smem_bytes() {
  return (size_t)5 * (D / 64) * BOX + 1024;
}

// K and V tile kt into the ring stage at k_dst (V follows K), completing
// on bar, which is armed for them and `extra` more bytes
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* k_map, const CUtensorMap* v_map,
                                        uint32_t k_dst, uint32_t bar, int kt, int kh, int b,
                                        uint32_t extra) {
  constexpr int NB = D / 64;
  mbar_expect_tx(bar, 2 * NB * BOX + extra);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    tma_load(k_dst + nb * BOX, k_map, bar, nb * 64, kh, kt * BK, b);
    tma_load(k_dst + NB * BOX + nb * BOX, v_map, bar, nb * 64, kh, kt * BK, b);
  }
}

// The kernel's body.  With LSE it also writes each row's natural log-sum-exp
// of the scaled, masked scores, f32, to lse[(b * H + h) * S_pad + row] for
// every row of its tile (S_pad: S rounded up to the tile; rows past S score
// zero-filled queries, so their values are finite), which the backward
// (flash_attention_bwd_sm90.cu) recomputes P from.  Without it the body is
// the serving kernel's, unchanged.
template <int D, bool LSE>
__device__ __forceinline__ void flash_fwd_body(const CUtensorMap& q_map,
                                               const CUtensorMap& k_map,
                                               const CUtensorMap& v_map,
                                               const CUtensorMap& o_map, int S, int H,
                                               int KH, int causal, int window,
                                               float scale_log2, float* lse, int S_pad) {
  constexpr int NB = D / 64;      // 64-column boxes per tile
  constexpr int TILE = NB * BOX;  // bytes of one 64-row tile of q, k, v or o
  __shared__ __align__(8) uint64_t full[2];  // one mbarrier per ring stage
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // Q; stage s: K at +TILE (1 + 2s), V after it
  uint8_t* base_ptr = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / KH);
  const int q0 = qt * BQ;

  // KV range this tile needs: [kv_begin, kv_end)
  const int q_last = min(q0 + BQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = kv_begin / BK;
  const int n_tiles = (kv_end + BK - 1) / BK - kt_begin;

  const uint32_t bar0 = smem_addr(&full[0]);  // stage s's barrier is bar0 + 8 s
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // Q lands on stage 0's barrier with the first K/V tile: one arrival
    // armed for both
    load_kv<D>(&k_map, &v_map, base + TILE, bar0, kt_begin, kh, b, TILE);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) tma_load(base + nb * BOX, &q_map, bar0, nb * 64, h, q0, b);
    if (n_tiles > 1) load_kv<D>(&k_map, &v_map, base + 3 * TILE, bar0 + 8, kt_begin + 1, kh, b, 0);
  }
  __syncthreads();

  // this thread's rows of the tile, and its first column in each 8-column block
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const int qpos0 = q0 + r0;
  const int qpos1 = qpos0 + 8;

  float o[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max of rows r0, r0 + 8 (log2 units)
  float l0 = 0.f, l1 = 0.f;          // this lane's share of their running sums

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int k0 = (kt_begin + it) * BK;
    const uint32_t k_s = base + TILE * (1 + 2 * stage);
    const uint32_t v_s = k_s + TILE;
    mbar_wait(bar0 + 8 * stage, (it >> 1) & 1);

    // S = Q K^T
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
      wgmma_ss(s, desc_k_major(base + off), desc_k_major(k_s + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // scale into log2 units; mask only on tiles that straddle a boundary
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale_log2;
        if (edge) {
          const int kp = k0 + 8 * j + c0 + (e & 1);
          const int qp = (e & 2) ? qpos1 : qpos0;
          bool keep = kp < S;
          if (causal) keep = keep && kp <= qp;
          if (window > 0) keep = keep && kp > qp - window;
          if (!keep) x = NEG_INF;
        }
        s[4 * j + e] = x;
      }

    // online softmax; a row fully masked so far keeps m = -1e30 and p = 1,
    // which the first valid key's alpha = 0 wipes out, as in the reference
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = fast_exp2(m0 - mn0);
    const float alpha1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = fast_exp2(s[4 * j] - mn0);
      s[4 * j + 1] = fast_exp2(s[4 * j + 1] - mn0);
      s[4 * j + 2] = fast_exp2(s[4 * j + 2] - mn1);
      s[4 * j + 3] = fast_exp2(s[4 * j + 3] - mn1);
      rs0 += s[4 * j] + s[4 * j + 1];
      rs1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[nb][4 * j] *= alpha0;
        o[nb][4 * j + 1] *= alpha0;
        o[nb][4 * j + 2] *= alpha1;
        o[nb][4 * j + 3] *= alpha1;
      }

    // P in bf16 as the A operand: keys 16 kk .. 16 kk + 15 are the score
    // accumulator's 8-column blocks 2 kk and 2 kk + 1
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(p[kk]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        wgmma_rs(o[nb], p[kk], desc_mn_major(v_s + nb * BOX + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);

    // every warp is done with this stage: refill it with the tile two ahead
    __syncthreads();
    if (tid == 0 && it + 2 < n_tiles)
      load_kv<D>(&k_map, &v_map, k_s, bar0 + 8 * stage, kt_begin + it + 2, kh, b, 0);
  }

  // epilogue: full row sums, then acc / max(l, 1e-30) as bf16 into Q's
  // buffer in the same swizzled layout, stored with TMA (rows past S dropped)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if constexpr (LSE) {
    if ((lane & 3) == 0) {
      float* row = lse + (size_t)(b * H + h) * S_pad;
      row[qpos0] = (m0 + log2f(fmaxf(l0, 1e-30f))) * LN2;
      row[qpos1] = (m1 + log2f(fmaxf(l1, 1e-30f))) * LN2;
    }
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int sw = lane >> 2;  // row % 8 of both rows: the 16-byte chunk swizzle
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int chunk = ((j ^ sw) << 4) + 2 * c0;
      uint8_t* box = base_ptr + nb * BOX;
      *reinterpret_cast<uint32_t*>(box + r0 * 128 + chunk) =
          pack_bf16(o[nb][4 * j] * inv0, o[nb][4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(box + (r0 + 8) * 128 + chunk) =
          pack_bf16(o[nb][4 * j + 2] * inv1, o[nb][4 * j + 3] * inv1);
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) tma_store(&o_map, base + nb * BOX, nb * 64, h, q0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// the serving kernel
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap o_map, int S, int H, int KH,
                      int causal, int window, float scale_log2) {
  flash_fwd_body<D, false>(q_map, k_map, v_map, o_map, S, H, KH, causal, window, scale_log2,
                           nullptr, 0);
}

// the training forward: the same, and the rows' log-sum-exp for the backward
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_lse_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap o_map, int S, int H, int KH,
                          int causal, int window, float scale_log2, float* lse, int S_pad) {
  flash_fwd_body<D, true>(q_map, k_map, v_map, o_map, S, H, KH, causal, window, scale_log2,
                          lse, S_pad);
}

template <int D>
cudaError_t launch(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v,
                   const CUtensorMap& o, int B, int S, int H, int KH, int causal, int window,
                   float scale_log2, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // set once per instantiation, not on every launch (the port drives one card)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd_sm90_kernel<D><<<grid, THREADS, smem, stream>>>(q, k, v, o, S, H, KH, causal,
                                                            window, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_lse(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v,
                       const CUtensorMap& o, float* lse, int B, int S, int H, int KH,
                       int causal, int window, float scale_log2, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_lse_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd_lse_sm90_kernel<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, S, H, KH, causal, window, scale_log2, lse, (int)grid.y * BQ);
  return cudaGetLastError();
}

// q, o over H heads and k, v over KH as tensor maps; 0 or minus the CUresult
int encode_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
                const void* o, int B, int S, int H, int KH, int D) {
  const cudaError_t bind = bind_context();
  if (bind != cudaSuccess) return (int)bind;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const void* ptrs[4] = {q, k, v, o};
  const int heads[4] = {H, KH, KH, H};
  for (int i = 0; i < 4; ++i) {
    const CUresult res = make_map(encode, &maps[i], ptrs[i], B, S, heads[i], D);
    if (res != CUDA_SUCCESS) return -(int)res;
  }
  return 0;
}

}  // namespace

// Returns 0 on success, the cudaError_t of a refused launch, or minus the
// CUresult of a tensor map that could not be encoded.  window <= 0 means
// no window.  The caller checks shapes, dtypes (bf16 only), contiguity,
// 16-byte aligned pointers and that H % KH == 0.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int H, int KH, int D, int causal,
                                   int window, float scale, void* stream) {
  if (D != 64 && D != 128 && D != 256) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const int err = encode_maps(maps, q, k, v, o, B, S, H, KH, D);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * LOG2E;
  if (D == 64)
    return launch<64>(maps[0], maps[1], maps[2], maps[3], B, S, H, KH, causal, window,
                      scale_log2, st);
  if (D == 128)
    return launch<128>(maps[0], maps[1], maps[2], maps[3], B, S, H, KH, causal, window,
                       scale_log2, st);
  return launch<256>(maps[0], maps[1], maps[2], maps[3], B, S, H, KH, causal, window,
                     scale_log2, st);
}

// The training forward: flash_attention_fwd's output, and the rows'
// log-sum-exp into lse, f32 (B, H, S_pad) with S_pad = S rounded up to a
// multiple of 64, every row written.  D is 64 or 128.
extern "C" int flash_attention_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int S, int H, int KH, int D,
                                       int causal, int window, float scale, void* stream) {
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const int err = encode_maps(maps, q, k, v, o, B, S, H, KH, D);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const float scale_log2 = scale * LOG2E;
  if (D == 64)
    return launch_lse<64>(maps[0], maps[1], maps[2], maps[3], l, B, S, H, KH, causal, window,
                          scale_log2, st);
  return launch_lse<128>(maps[0], maps[1], maps[2], maps[3], l, B, S, H, KH, causal, window,
                         scale_log2, st);
}
