// Decode attention of one query token a row against the KV cache, split
// over the cache's slots (flash-decoding), for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces no TPU kernel.  The JAX package decodes with plain jnp code
// (src/repro/models/layers.py::_decode_attention), which XLA fuses under
// jit; run eagerly, the same code in PyTorch (kernels/ops.py::
// decode_attention_plain) repeats each K/V head for its query heads, a
// copy of the cache, copies the result again into the layout of its
// batched product, and reads the masked slots past the live ones: some
// 29 launches and two f32 copies of the cache a layer and a step, 40-75
// times the time the bytes need.  This file reads each live byte of the
// cache once, in place.
//
// What it computes, for row b and query head h over the live slots
// [0, kv_valid) (the slots after them are masked to exp(-inf) = 0 in the
// plain version, so leaving them out changes nothing), at the plain
// version's points of rounding:
//   q'  = round_to_q_dtype(q * scale)               scale rounded to q's dtype
//   s_j = sum_d q'_d k_jd                             f32, FMA on the CUDA cores
//   online softmax over the slots in f32: m, l = sum exp(s_j - m)
//   o   = sum_j round_to_cache_dtype(exp(s_j - m)) v_j / max(l, 1e-30)
//   out = round_to_q_dtype(o)
// The sums run in another order than the plain version's (slots in tiles
// of kTile and in splits, the splits merged in a fixed order), so the
// result is deterministic and uses no atomics.
//
// Bound on the H100 (SXM, 3.35 TB/s).  A layer reads the live K and V
// once: rows x K/V heads x kv_valid x hd x 2 x the cache's element size
// (StarCoder2-7B, 64 rows at 1,056 live f32 slots: 277 MB, 83 us), and
// does ~4.5 FLOP a byte in f32 (a dot product and a product-sum a query
// head, 9 query heads a K/V head), far below the CUDA cores' f32 ridge
// (67 TFLOP/s over 3.35 TB/s, 20 FLOP a byte).  Bytes bound it.
//
// Design.
//   1. decode_attention_split_kernel, grid (split, K/V head, row), 128
//      threads.  A block finds the query heads that read its K/V head (h
//      / (H / KH), or the device map `kv_heads`, which it reads itself)
//      and serves them all, up to kMaxGroup at a time, from each tile it
//      loads: each byte of the cache crosses HBM once, not once a query
//      head.  It streams its split's slots in tiles of kTile slots of K
//      and V, cp.async 16-byte copies into a ring of kStages tiles in
//      shared memory, so that the next tile's loads are in flight during
//      this tile's arithmetic.  Scores: lane j of warp w takes slot j
//      against the query heads w, w + 4, ... (q, scaled and widened, in
//      shared memory, read as broadcasts), then the warp's online softmax
//      over its heads by shuffles; then the same warp's P V for those
//      heads, lane l taking columns 4l..4l+3 (and 4(l + 32).. past 128),
//      each slot's p passed from its lane by a shuffle.  The split's (m,
//      l, acc) go to f32 scratch the wrapper allocates.
//   2. decode_attention_merge_kernel, grid (query head, row): the splits
//      merged in order, divided, rounded to q's dtype.  A map entry out of
//      [0, KH) writes NaN: no block served that head.
// The wrapper (kernels/decode_attention.py::plan) picks the number of
// splits from rows x K/V heads and kv_valid alone: about TARGET_BLOCKS
// blocks, several waves over the 132 SMs (three blocks fit an SM at
// head_dim 128 with an f32 cache: 76 KB of shared memory each).  On the
// H100 this reads the StarCoder2 serve cells' caches at 46-52 % of the
// byte bound; its loads alone, the arithmetic left out, at 75-82 %.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;           // slots a tile: kernels/decode_attention.py TILE
constexpr int kStages = 2;          // tiles in the shared-memory ring
constexpr int kRowPad = 16;         // bytes after each slot's row: no bank conflicts
constexpr int kMaxGroup = 16;       // query heads a pass over the slots
constexpr int kMaxHd = 256;         // kernels/decode_attention.py MAX_HD
constexpr int kMaxHeads = 1024;     // kernels/decode_attention.py MAX_HEADS
constexpr int kHeadsPerWarp = kMaxGroup / kWarps;   // query heads a warp owns
constexpr int kGroupsPerLane = kMaxHd / (4 * 32);    // 4-column groups a lane takes
static_assert(kTile == 32, "a lane takes a slot of the tile");
static_assert(kStages >= 2, "a tile in flight while another is computed");

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  // 8 values from 32 bytes of shared memory
  __device__ static void load8(const unsigned char* p, float* x) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
  // 4 values from 16 bytes of shared memory
  __device__ static void load4(const unsigned char* p, float* x) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  }
  __device__ static float load1(const float* p, long long e) { return p[e]; }
  __device__ static void store1(float* p, long long e, float x) { p[e] = x; }
  __device__ static float round(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  // 8 values from 16 bytes of shared memory
  __device__ static void load8(const unsigned char* p, float* x) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      memcpy(&h, &w[i], sizeof(h));
      const float2 f = __bfloat1622float2(h);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  // 4 values from 8 bytes of shared memory
  __device__ static void load4(const unsigned char* p, float* x) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {u.x, u.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      __nv_bfloat162 h;
      memcpy(&h, &w[i], sizeof(h));
      const float2 f = __bfloat1622float2(h);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ static float load1(const __nv_bfloat16* p, long long e) {
    return __bfloat162float(p[e]);
  }
  __device__ static void store1(__nv_bfloat16* p, long long e, float x) {
    p[e] = __float2bfloat16_rn(x);
  }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Args {
  const void* q;            // (B, 1, H, hd), strides q_sb, q_sh, 1
  const void* k;            // (B, C, KH * hd), strides kv_sb, kv_sc, 1
  const void* v;            // as k
  const int* kv_heads;      // (H,) K/V head of each query head, or null
  float* part_ml;           // (B, H, splits, 2): each split's m and l
  float* part_acc;          // (B, H, splits, hd): each split's unnormalised output
  long long q_sb, q_sh, kv_sb, kv_sc;
  int H, KH, hd, kv_valid, splits, chunk;
  float scale;
};

// A warp's running softmax and output of its heads over a split.
struct WarpState {
  float m[kHeadsPerWarp], l[kHeadsPerWarp];
  float acc[kHeadsPerWarp][kGroupsPerLane][4];
};

// One tile in shared memory as a warp sees it: K and V rows of row_bytes,
// q of its first head and the stride to its next, and the live slots.
struct Tile {
  const unsigned char* k;
  const unsigned char* v;
  const float* q;
  int q_stride, row_bytes, hd, valid, lane;
};

__device__ __forceinline__ float dot8(const float* q, const float* k, float x) {
  const float4 qa = *reinterpret_cast<const float4*>(q);
  const float4 qb = *reinterpret_cast<const float4*>(q + 4);
  x = fmaf(qa.x, k[0], x); x = fmaf(qa.y, k[1], x);
  x = fmaf(qa.z, k[2], x); x = fmaf(qa.w, k[3], x);
  x = fmaf(qb.x, k[4], x); x = fmaf(qb.y, k[5], x);
  x = fmaf(qb.z, k[6], x); x = fmaf(qb.w, k[7], x);
  return x;
}

// A warp's NK heads over one tile: scores of slot `lane` (two partial sums
// a head, over alternate 8-column chunks), the online softmax, then P V.
// NK is a constant so that the heads' chains of dependent operations
// interleave.
template <int NK, typename KV>
__device__ __forceinline__ void tile_step(const Tile& t, WarpState& st) {
  constexpr int kv = (int)sizeof(KV);
  float s0[NK], s1[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) s0[k] = s1[k] = 0.0f;
  if (t.lane < t.valid) {
    const unsigned char* krow = t.k + t.lane * t.row_bytes;
    int d = 0;
    for (; d + 16 <= t.hd; d += 16) {
      float ka[8], kb[8];
      Elem<KV>::load8(krow + d * kv, ka);
      Elem<KV>::load8(krow + (d + 8) * kv, kb);
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        s0[k] = dot8(t.q + k * t.q_stride + d, ka, s0[k]);
        s1[k] = dot8(t.q + k * t.q_stride + d + 8, kb, s1[k]);
      }
    }
    if (d < t.hd) {
      float ka[8];
      Elem<KV>::load8(krow + d * kv, ka);
#pragma unroll
      for (int k = 0; k < NK; ++k) s0[k] = dot8(t.q + k * t.q_stride + d, ka, s0[k]);
    }
  }
  float x[NK], mx[NK], e[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) mx[k] = x[k] = t.lane < t.valid ? s0[k] + s1[k] : -INFINITY;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < NK; ++k) mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], o));
  float p[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const float m_new = fmaxf(st.m[k], mx[k]);
    e[k] = expf(x[k] - m_new);
    p[k] = Elem<KV>::round(e[k]);
    const float alpha = expf(st.m[k] - m_new);
    st.m[k] = m_new;
    st.l[k] *= alpha;
#pragma unroll
    for (int u = 0; u < kGroupsPerLane; ++u)
#pragma unroll
      for (int f = 0; f < 4; ++f) st.acc[k][u][f] *= alpha;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < NK; ++k) e[k] += __shfl_xor_sync(0xffffffffu, e[k], o);
#pragma unroll
  for (int k = 0; k < NK; ++k) st.l[k] += e[k];

#pragma unroll 4
  for (int j = 0; j < t.valid; ++j) {
    const unsigned char* vrow = t.v + j * t.row_bytes;
    float pj[NK];
#pragma unroll
    for (int k = 0; k < NK; ++k) pj[k] = __shfl_sync(0xffffffffu, p[k], j);
#pragma unroll
    for (int u = 0; u < kGroupsPerLane; ++u) {
      const int col = 4 * (t.lane + 32 * u);
      if (col < t.hd) {
        float vf[4];
        Elem<KV>::load4(vrow + col * kv, vf);
#pragma unroll
        for (int k = 0; k < NK; ++k)
#pragma unroll
          for (int f = 0; f < 4; ++f) st.acc[k][u][f] = fmaf(pj[k], vf[f], st.acc[k][u][f]);
      }
    }
  }
}

// Shared memory a split block takes: the tile ring, then q (f32) and the
// list of the block's query heads.
__host__ __device__ inline size_t split_smem_bytes(int hd, int kv_bytes, int H) {
  const size_t row = (size_t)hd * kv_bytes + kRowPad;
  return (size_t)kStages * 2 * kTile * row + sizeof(float) * (size_t)kMaxGroup * hd
       + sizeof(int) * (size_t)H;
}

template <typename Q, typename KV>
__global__ void __launch_bounds__(kThreads)
decode_attention_split_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_heads_s;
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row_bytes = a.hd * (int)sizeof(KV) + kRowPad;
  const int stage_bytes = 2 * kTile * row_bytes;
  float* q_s = reinterpret_cast<float*>(smem + (size_t)kStages * stage_bytes);
  int* heads_s = reinterpret_cast<int*>(q_s + kMaxGroup * a.hd);

  // the query heads that read K/V head g, in order
  if (warp == 0) {
    int n = 0;
    if (a.kv_heads != nullptr) {
      for (int h0 = 0; h0 < a.H; h0 += 32) {
        const int h = h0 + lane;
        const bool mine = h < a.H && a.kv_heads[h] == g;
        const unsigned ballot = __ballot_sync(0xffffffffu, mine);
        if (mine) heads_s[n + __popc(ballot & ((1u << lane) - 1u))] = h;
        n += __popc(ballot);
      }
    } else {
      n = a.H / a.KH;
      for (int i = lane; i < n; i += 32) heads_s[i] = g * n + i;
    }
    if (lane == 0) n_heads_s = n;
  }
  __syncthreads();
  const int n_heads = n_heads_s;
  if (n_heads == 0) return;

  const int start = split * a.chunk;
  const int end = min(start + a.chunk, a.kv_valid);
  const int n_tiles = (end - start + kTile - 1) / kTile;
  const unsigned char* kbase = reinterpret_cast<const unsigned char*>(
      static_cast<const KV*>(a.k) + b * a.kv_sb + (long long)g * a.hd);
  const unsigned char* vbase = reinterpret_cast<const unsigned char*>(
      static_cast<const KV*>(a.v) + b * a.kv_sb + (long long)g * a.hd);
  const long long slot_bytes = a.kv_sc * (long long)sizeof(KV);
  // a tile is 2 * kTile rows (K's, then V's) of row_chunks 16-byte copies;
  // thread tid takes copies tid, tid + kThreads, ...: row r0, chunk c0,
  // then steps of (step_r, step_c) with a carry
  const int row_chunks = a.hd * (int)sizeof(KV) / 16;
  const int r0 = tid / row_chunks, c0 = tid - r0 * row_chunks;
  const int step_r = kThreads / row_chunks, step_c = kThreads - step_r * row_chunks;

  auto load_tile = [&](int t) {
    const int slot0 = start + t * kTile;
    const int valid = min(kTile, end - slot0);
    unsigned char* stage = smem + (size_t)(t % kStages) * stage_bytes;
    for (int r = r0, c = c0; r < 2 * kTile;) {
      const int slot = r < kTile ? r : r - kTile;
      if (slot < valid)
        cp_async16(stage + r * row_bytes + c * 16,
                   (r < kTile ? kbase : vbase) + (slot0 + slot) * slot_bytes + c * 16);
      r += step_r;
      c += step_c;
      if (c >= row_chunks) {
        c -= row_chunks;
        ++r;
      }
    }
  };

  // warp w owns query heads w, w + kWarps, ... of a pass: their scores
  // (lane j: slot j), their softmax, and their P V (lane l: columns
  // 4l..4l+3, then 4(l + 32).. where hd > 128)
  for (int h0 = 0; h0 < n_heads; h0 += kMaxGroup) {
    const int nq = min(kMaxGroup, n_heads - h0);
    const int nk = nq > warp ? (nq - warp + kWarps - 1) / kWarps : 0;
    for (int x = tid; x < nq * a.hd; x += kThreads) {
      const int i = x / a.hd, d = x - i * a.hd;
      const int h = heads_s[h0 + i];
      const float qv = Elem<Q>::load1(static_cast<const Q*>(a.q), b * a.q_sb + h * a.q_sh + d);
      q_s[x] = Elem<Q>::round(__fmul_rn(qv, a.scale));
    }
    WarpState st;
#pragma unroll
    for (int k = 0; k < kHeadsPerWarp; ++k) {
      st.m[k] = -INFINITY;
      st.l[k] = 0.0f;
#pragma unroll
      for (int u = 0; u < kGroupsPerLane; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) st.acc[k][u][e] = 0.0f;
    }

#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < n_tiles) load_tile(t);
      cp_async_commit();
    }
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<kStages - 2>();
      // tile t is in for every thread, q_s is written, and every warp is
      // done with the stage the next load overwrites (tile t - 1's)
      __syncthreads();
      if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
      cp_async_commit();
      const unsigned char* ks = smem + (size_t)(t % kStages) * stage_bytes;
      const Tile tile{ks, ks + kTile * row_bytes, q_s + warp * a.hd, kWarps * a.hd,
                      row_bytes, a.hd, min(kTile, end - (start + t * kTile)), lane};
      switch (nk) {      // the warp's heads as a constant: no test a head, no idle lanes
        case 0: break;
        case 1: tile_step<1, KV>(tile, st); break;
        case 2: tile_step<2, KV>(tile, st); break;
        case 3: tile_step<3, KV>(tile, st); break;
        default: tile_step<4, KV>(tile, st); break;
      }
    }

    // this split's partials of the warp's heads
#pragma unroll
    for (int k = 0; k < kHeadsPerWarp; ++k) {
      if (k < nk) {
        const long long at =
            ((long long)b * a.H + heads_s[h0 + warp + kWarps * k]) * a.splits + split;
        if (lane == 0) {
          a.part_ml[2 * at] = st.m[k];
          a.part_ml[2 * at + 1] = st.l[k];
        }
#pragma unroll
        for (int u = 0; u < kGroupsPerLane; ++u) {
          const int col = 4 * (lane + 32 * u);
          if (col < a.hd)
            *reinterpret_cast<float4*>(a.part_acc + at * a.hd + col) = make_float4(
                st.acc[k][u][0], st.acc[k][u][1], st.acc[k][u][2], st.acc[k][u][3]);
        }
      }
    }
    __syncthreads();            // q_s and the ring are rewritten by the next pass
  }
}

template <typename Q>
__global__ void __launch_bounds__(kThreads)
decode_attention_merge_kernel(const float* part_ml, const float* part_acc,
                              const int* kv_heads, Q* out, int H, int KH, int hd,
                              int splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const long long base = ((long long)b * H + h) * splits;
  const bool served = kv_heads == nullptr || (kv_heads[h] >= 0 && kv_heads[h] < KH);
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, part_ml[2 * (base + s)]);
  float L = 0.0f;
  for (int s = 0; s < splits; ++s)
    L = fmaf(expf(part_ml[2 * (base + s)] - M), part_ml[2 * (base + s) + 1], L);
  const float denom = fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float o = 0.0f;
    for (int s = 0; s < splits; ++s)
      o = fmaf(expf(part_ml[2 * (base + s)] - M), part_acc[(base + s) * hd + d], o);
    Elem<Q>::store1(out, ((long long)b * H + h) * hd + d, served ? o / denom : NAN);
  }
}

template <typename Q, typename KV>
cudaError_t launch_split(const Args& a, int B, cudaStream_t stream) {
  // set at every launch: the attribute belongs to the current device
  const size_t bytes = split_smem_bytes(a.hd, (int)sizeof(KV), a.H);
  const cudaError_t err = cudaFuncSetAttribute(
      decode_attention_split_kernel<Q, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  decode_attention_split_kernel<Q, KV><<<dim3(a.splits, a.KH, B), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The split pass: each (split, K/V head, row) block's partials into
// `part_ml` and `part_acc`.  Strides are in elements; `q_bf16` and
// `kv_bf16` pick bf16 over f32.
extern "C" int decode_attention_split(const void* q, const void* k, const void* v,
                                      const void* kv_heads, void* part_ml, void* part_acc,
                                      int B, int H, int KH, int hd, int q_bf16, int kv_bf16,
                                      long long q_sb, long long q_sh, long long kv_sb,
                                      long long kv_sc, int kv_valid, int splits, int chunk,
                                      float scale, void* stream) {
  if (B < 1 || H < 1 || H > kMaxHeads || KH < 1 || hd < 8 || hd > kMaxHd || hd % 8 != 0
      || kv_valid < 1 || splits < 1 || chunk % kTile != 0
      || (long long)(splits - 1) * chunk >= kv_valid || (long long)splits * chunk < kv_valid
      || (kv_heads == nullptr && H % KH != 0))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int*>(kv_heads), static_cast<float*>(part_ml),
               static_cast<float*>(part_acc), q_sb, q_sh, kv_sb, kv_sc, H, KH, hd, kv_valid,
               splits, chunk, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16)
    err = kv_bf16 ? launch_split<__nv_bfloat16, __nv_bfloat16>(a, B, s)
                  : launch_split<__nv_bfloat16, float>(a, B, s);
  else
    err = kv_bf16 ? launch_split<float, __nv_bfloat16>(a, B, s)
                  : launch_split<float, float>(a, B, s);
  return (int)err;
}

// The merge pass: the splits of each (query head, row) in order, into
// `out` (B, 1, H, hd), contiguous, in q's dtype.
extern "C" int decode_attention_merge(const void* part_ml, const void* part_acc,
                                      const void* kv_heads, void* out, int B, int H, int KH,
                                      int hd, int q_bf16, int splits, void* stream) {
  if (B < 1 || H < 1 || hd < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const float* ml = static_cast<const float*>(part_ml);
  const float* acc = static_cast<const float*>(part_acc);
  const int* map = static_cast<const int*>(kv_heads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    decode_attention_merge_kernel<__nv_bfloat16><<<dim3(H, B), kThreads, 0, s>>>(
        ml, acc, map, static_cast<__nv_bfloat16*>(out), H, KH, hd, splits);
  else
    decode_attention_merge_kernel<float><<<dim3(H, B), kThreads, 0, s>>>(
        ml, acc, map, static_cast<float*>(out), H, KH, hd, splits);
  return (int)cudaGetLastError();
}
