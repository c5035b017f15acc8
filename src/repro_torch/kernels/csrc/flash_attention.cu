// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py (driven by `flash_attention_bhsd`,
// wrapped by `repro.kernels.ops.flash_attention`).  It computes the same
// function: causal, optionally sliding-window softmax attention with an
// online softmax whose running max `m`, sum `l` and accumulator `acc` stay
// in f32; q is scaled by D**-0.5 before Q K^T; masked scores are -1e30; the
// output is acc / max(l, 1e-30) in the input dtype.
//
// Layout.  q is (B, S, H, D) and k, v are (B, S, KH, D), all contiguous,
// exactly as the model holds them, so no transpose happens around the call.
// GQA is native: query head h reads KV head h / (H / KH), with no repeated
// copy of K and V.  Any S works: rows and keys past S are masked, where the
// TPU kernel asserted S % block == 0.  D is 64 or 128; inputs are f32 or
// bf16.
//
// Design.  One thread block of 256 threads per (batch*head, tile of 64
// query rows).  Tiles are launched heaviest first, so the long causal rows
// start early.  The block loops over 64-row KV tiles from the window's edge
// (if any) to the causal frontier only, so fully masked tiles cost nothing.
// Q, K, V and the probabilities P live in shared memory as f32 (row stride
// D + 1 to spread the banks); each thread owns a 4 x 4 tile of the 64 x 64
// scores (rows tr + 16 i, columns tc + 16 j) and 4 x D/16 of the output
// accumulator, so every value loaded from shared memory feeds two FMAs or
// more.  Row max and row sum are reduced over the 16 threads of a row with
// warp shuffles.
//
// Bound on the H100 (SXM, 3.35 TB/s, 989 TFLOP/s bf16 dense).  At the
// serving shape B*H = 128, S = 512, D = 64 in bf16, q, k, v and o are
// 4 * 128 * 512 * 64 * 2 B = 33.6 MB, about 10 us at 3.35 TB/s; the causal
// work is 4 * D * S (S + 1) / 2 * B*H = 4.3 GFLOP, about 4.3 us at
// 989 TFLOP/s.  The work is bound by memory at ~10 us.  The design keeps
// the S x S scores out of device memory (they live only as a 64 x 64 tile
// in shared memory) and reads each K/V tile once per query tile that needs
// it; at this shape q, k and v (25 MB) fit in the 50 MB L2, so those
// re-reads need not reach HBM.  This first version multiplies on the CUDA
// cores in f32, not on the tensor cores, so its arithmetic, not the memory,
// limits it today (0.31-0.35 ms on an H100 at 700 W, chip_smoke.py): moving
// QK^T and PV to wgmma with TMA-fed tiles is the later step that brings it
// towards the memory bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int THREADS = 256;  // 16 x 16 threads over the 64 x 64 score tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(3 * BQ * (D + 1) + BQ * (BK + 1)) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int H, int KH, int causal, int window, float scale) {
  constexpr int LD = D + 1;   // padded row stride of the f32 tiles
  constexpr int LP = BK + 1;  // padded row stride of P
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;           // BQ x LD, already scaled
  float* Ks = Qs + BQ * LD;   // BK x LD
  float* Vs = Ks + BK * LD;   // BK x LD
  float* Ps = Vs + BK * LD;   // BQ x LP

  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / KH);
  const int q0 = qt * BQ;
  const long long q_stride = (long long)H * D;    // between sequence positions
  const long long kv_stride = (long long)KH * D;
  const T* qb = q + ((long long)b * S * H + h) * D;
  const T* kb = k + ((long long)b * S * KH + kh) * D;
  const T* vb = v + ((long long)b * S * KH + kh) * D;
  T* ob = o + ((long long)b * S * H + h) * D;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int s = q0 + r;
    Qs[r * LD + d] = s < S ? to_f32(qb[s * q_stride + d]) * scale : 0.f;
  }

  // KV range this tile needs: [kv_begin, kv_end)
  const int q_last = min(q0 + BQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = kv_begin / BK;
  const int kt_end = (kv_end + BK - 1) / BK;

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, d = idx - (idx / D) * D;
      const int s = k0 + r;
      const bool in = s < S;
      Ks[r * LD + d] = in ? to_f32(kb[s * kv_stride + d]) : 0.f;
      Vs[r * LD + d] = in ? to_f32(vb[s * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + tr + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tc + 16 * j;
        bool keep = kp < S;
        if (causal) keep = keep && kp <= qp;
        if (window > 0) keep = keep && kp > qp - window;
        if (!keep) sc[i][j] = NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        Ps[(tr + 16 * i) * LP + tc + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 16
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr + 16 * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * LD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + tr + 16 * i;
    if (s < S) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j) store(&ob[s * q_stride + tc + 16 * j], acc[i][j] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int H, int KH, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, KH, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  dtype: 0 = f32,
// 1 = bf16.  window <= 0 means no window.  The caller checks shapes,
// dtypes, contiguity and that H % KH == 0.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int H, int KH, int D,
                                   int dtype, int causal, int window,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64 && dtype == 0)
    return launch<float, 64>(q, k, v, o, B, S, H, KH, causal, window, scale, st);
  if (D == 64 && dtype == 1)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, S, H, KH, causal, window, scale, st);
  if (D == 128 && dtype == 0)
    return launch<float, 128>(q, k, v, o, B, S, H, KH, causal, window, scale, st);
  if (D == 128 && dtype == 1)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, S, H, KH, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
