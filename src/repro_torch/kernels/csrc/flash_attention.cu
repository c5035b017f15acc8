// Flash-attention forward in f32 on the CUDA cores (sm_90a), plain C
// interface for ctypes.
//
// Replaces, for f32 inputs, the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py (driven by `flash_attention_bhsd`,
// wrapped by `repro.kernels.ops.flash_attention`); bf16 inputs, the
// serving path's, go to the tensor-core kernel in flash_attention_sm90.cu.
// It computes the same function: causal, optionally sliding-window
// softmax attention with an online softmax whose running max `m`, sum `l`
// and accumulator `acc` stay in f32; q is scaled by D**-0.5 before Q K^T;
// masked scores are -1e30; the output is acc / max(l, 1e-30).  Every
// product is a full-f32 FMA: TF32 tensor-core products would miss the f32
// tolerance (2e-4) this kernel is held to.
//
// Layout.  q is (B, S, H, D) and k, v are (B, S, KH, D), all contiguous,
// exactly as the model holds them, so no transpose happens around the call.
// GQA is native: query head h reads KV head h / (H / KH), with no repeated
// copy of K and V.  Any S works: rows and keys past S are masked, where the
// TPU kernel asserted S % block == 0.  D is 64, 128 or 256.
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
// warp shuffles.  Shared memory is 66 KB at D = 64 and 209 KB at D = 256,
// where one block fills an SM and the accumulator is 64 floats a thread.
//
// Bound on the H100 (SXM, 3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores).  In f32 the causal work, 4 * D * S (S + 1) / 2 per (batch, head),
// bounds it: at B*H = 16, S = 256, D = 128 that is 0.27 GFLOP, about 4 us,
// against 8.4 MB, 2.5 us.  The kernel keeps the S x S scores out of device
// memory (only a 64 x 64 tile lives in shared memory) and reads each K/V
// tile once per query tile that needs it.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int THREADS = 256;  // 16 x 16 threads over the 64 x 64 score tile
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(3 * BQ * (D + 1) + BQ * (BK + 1)) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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
  const float* qb = q + ((long long)b * S * H + h) * D;
  const float* kb = k + ((long long)b * S * KH + kh) * D;
  const float* vb = v + ((long long)b * S * KH + kh) * D;
  float* ob = o + ((long long)b * S * H + h) * D;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int s = q0 + r;
    Qs[r * LD + d] = s < S ? qb[s * q_stride + d] * scale : 0.f;
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
      Ks[r * LD + d] = in ? kb[s * kv_stride + d] : 0.f;
      Vs[r * LD + d] = in ? vb[s * kv_stride + d] : 0.f;
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
      for (int j = 0; j < DJ; ++j) ob[s * q_stride + tc + 16 * j] = acc[i][j] / denom;
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, int B,
                   int S, int H, int KH, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // set once per instantiation, not on every launch (the port drives one card)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(q, k, v, o, S, H, KH, causal,
                                                       window, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  f32 only.  window
// <= 0 means no window.  The caller checks shapes, dtypes, contiguity and
// that H % KH == 0.
extern "C" int flash_attention_fwd(const float* q, const float* k, const float* v,
                                   float* o, int B, int S, int H, int KH, int D,
                                   int causal, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, o, B, S, H, KH, causal, window, scale, st);
  if (D == 128) return launch<128>(q, k, v, o, B, S, H, KH, causal, window, scale, st);
  if (D == 256) return launch<256>(q, k, v, o, B, S, H, KH, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
