// Chunked Mamba2/SSD scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` in
// src/repro/kernels/ssd_scan.py (driven by `ssd_scan_bhsp`, wrapped by
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
// in f32 throughout; y is written in x's dtype and the final h in f32.
//
// Layout.  x is (B, S, H, P), dt (B, S, H), Bm and Cm (B, S, N), read in
// place with the strides the caller passes (the last dimension of x, Bm and
// Cm is contiguous): in the model x, Bm and Cm are strided slices of the
// causal conv's output, so nothing is transposed or copied around the
// call.  Bm and Cm are shared across heads.  y is (B, S, H, P) contiguous;
// h0 (or null, for zeros) and h_final are (B, H, P, N) contiguous f32.  Any
// S works: rows of the last chunk past S are loaded as x = B = C = dt = 0,
// which leaves L flat and adds nothing to h (the TPU kernel asserted
// S % chunk == 0).  P <= 128 and N <= 128; x, Bm, Cm in f32 or bf16, dt and
// A in f32.
//
// Design.  The TPU kernel carries h in VMEM across an "arbitrary" grid axis
// over chunks.  Blocks on the GPU run in no order, so the chunk loop moves
// inside the block: one block of 256 threads per (b, h), the P x N state in
// shared memory for the whole sequence, beside the chunk's x (Q x P), B and
// C (Q x N) and M (Q x Q), all f32.  Per chunk: load; one warp scans dt * A
// with shuffles; each thread forms a 4 x 4 tile of M; each thread forms 4
// rows x PJ columns of y; each thread updates PJ x NJ entries of h in
// place.  The 16 x 16 thread grid owns rows r + 16 i and columns c + 16 j,
// so every value read from shared memory feeds several FMAs; rows read
// across threads have an odd stride (N + 1) to spread the banks.  PJ and
// NJ, P and N over 16 rounded up to 1, 2, 4 or 8, are template parameters
// (the tiles are zero-padded to 16 PJ and 16 NJ): with runtime bounds the
// per-thread loops execute their masked-off FMAs all the same.
//
// Bound on the H100 (SXM, 3.35 TB/s, 67 TFLOP/s f32 without the tensor
// cores).  At mamba2-130m's serving shape (B, S, H, P, N) = (8, 512, 24,
// 64, 128) in f32 the function moves x, y (2 x 25.2 MB), dt (0.4 MB), B and
// C (2 x 2.1 MB), h0 and h_final (2 x 6.3 MB): about 67.5 MB, 20 us.  Only
// the causal pairs s <= t of a chunk count, Q (Q + 1) / 2 = 2080 of them:
// C B^T once per (b, chunk), since B and C are shared across heads
// (2 N a pair, 34 MFLOP), and per (b, h) the intra-chunk product M x
// (2 P a pair), the state's output (2 S P N) and the state update
// (2 S P N): about 3.66 GFLOP, 55 us at 67 TFLOP/s.  So operations bound
// it, at about 0.055 ms.  At hymba-1.5b's (8, 512, 50, 64, 16): about
// 110 MB (33 us) and 1.70 GFLOP (25 us), so bytes bound it, at about
// 0.033 ms.  This first version multiplies on the CUDA cores in
// f32 and forms C B^T again for every head; sharing C B^T across heads,
// TF32 or bf16 wgmma, and a chunk-parallel state pass are later steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int Q = 64;          // rows per chunk
constexpr int THREADS = 256;   // a 16 x 16 grid of threads
constexpr int MAX_DIM = 128;   // largest P and N
constexpr int LDM = Q + 1;     // padded row stride of M

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Dims {
  int S, H, P, N;
  long long sxb, sxs, sxh;     // x strides (the last is 1)
  long long sdb, sds, sdh;     // dt strides
  long long sbb, sbs;          // Bm strides (the last is 1)
  long long scb, scs;          // Cm strides (the last is 1)
};

// Shared memory in floats: h (P16 x LDN), x (Q x P16), B and C (Q x LDN),
// M (Q x LDM), and dt, L, exp(L), w (Q each).
template <int PJ, int NJ>
constexpr int smem_floats() {
  return 16 * PJ * (16 * NJ + 1) + Q * 16 * PJ + 2 * Q * (16 * NJ + 1) + Q * LDM + 4 * Q;
}

template <typename T, int PJ, int NJ>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ hf, Dims d) {
  constexpr int P16 = 16 * PJ, LDN = 16 * NJ + 1;
  const int P = d.P, N = d.N, S = d.S, H = d.H;
  extern __shared__ float smem[];
  float* Hs = smem;                // P16 x LDN, the carried state
  float* Xs = Hs + P16 * LDN;      // Q x P16
  float* Bs = Xs + Q * P16;        // Q x LDN
  float* Cs = Bs + Q * LDN;        // Q x LDN
  float* Ms = Cs + Q * LDN;        // Q x LDM
  float* dts = Ms + Q * LDM;       // Q
  float* Ls = dts + Q;             // Q: inclusive cumsum of dt * A
  float* eL = Ls + Q;              // Q: exp(L)
  float* ws = eL + Q;              // Q: exp(L_end - L) * dt

  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const float a = A[h];
  const T* xb = x + b * d.sxb + h * d.sxh;
  const float* dtb = dt + b * d.sdb + h * d.sdh;
  const T* Bb = Bm + b * d.sbb;
  const T* Cb = Cm + b * d.scb;
  T* yb = y + ((long long)b * S * H + h) * P;
  const long long ys = (long long)H * P;          // y's stride between rows
  const long long hoff = (long long)bh * P * N;

  // the state, zero in its padding, which the loops below read but never use
  for (int idx = tid; idx < P16 * LDN; idx += THREADS) {
    const int p = idx / LDN, n = idx - p * LDN;
    Hs[idx] = (h0 != nullptr && p < P && n < N) ? h0[hoff + p * N + n] : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();  // the previous chunk's tiles and state are no longer read
#pragma unroll 4
    for (int idx = tid; idx < Q * P16; idx += THREADS) {
      const int r = idx / P16, p = idx - r * P16;
      const int s = c0 + r;
      Xs[idx] = (s < S && p < P) ? to_f32(xb[s * d.sxs + p]) : 0.f;
    }
#pragma unroll 4
    for (int idx = tid; idx < Q * LDN; idx += THREADS) {
      const int r = idx / LDN, n = idx - r * LDN;
      const int s = c0 + r;
      const bool in = s < S && n < N;
      Bs[idx] = in ? to_f32(Bb[s * d.sbs + n]) : 0.f;
      Cs[idx] = in ? to_f32(Cb[s * d.scs + n]) : 0.f;
    }
    if (tid < 32) {
      // inclusive scan of dt * A over the 64 rows: lane l holds rows l, l + 32
      const int s0 = c0 + tid, s1 = c0 + tid + 32;
      const float d0 = s0 < S ? dtb[s0 * d.sds] : 0.f;
      const float d1 = s1 < S ? dtb[s1 * d.sds] : 0.f;
      float v0 = d0 * a, v1 = d1 * a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, off);
        if (tid >= off) { v0 += u0; v1 += u1; }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      const float last = __shfl_sync(0xffffffffu, v1, 31);
      dts[tid] = d0;
      dts[tid + 32] = d1;
      Ls[tid] = v0;
      Ls[tid + 32] = v1;
      eL[tid] = expf(v0);
      eL[tid + 32] = expf(v1);
      ws[tid] = expf(last - v0) * d0;
      ws[tid + 32] = expf(last - v1) * d1;
    }
    __syncthreads();

    // M = (C B^T) * exp(L_t - L_s) * dt_s, causal: rows tr + 16 i, cols tc + 16 j
    {
      float cb[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cb[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(tr + 16 * i) * LDN + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tc + 16 * j) * LDN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cb[i][j] = fmaf(cv[i], bv[j], cb[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tr + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tc + 16 * j;
          Ms[t * LDM + s] = s <= t ? cb[i][j] * expf(Ls[t] - Ls[s]) * dts[s] : 0.f;
        }
      }
    }
    __syncthreads();

    // y = M x + exp(L) (C h^T): rows tr + 16 i, columns tc + 16 j of P
    {
      float yi[4][PJ], yst[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) { yi[i][j] = 0.f; yst[i][j] = 0.f; }
#pragma unroll 2
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(tr + 16 * i) * LDN + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) hv[j] = Hs[(tc + 16 * j) * LDN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) yst[i][j] = fmaf(cv[i], hv[j], yst[i][j]);
      }
      // M is zero above the diagonal: rows up to tr + 48 need s <= tr + 48
      const int s_end = tr + 49;
#pragma unroll 2
      for (int s = 0; s < s_end; ++s) {
        float mv[4], xv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = Ms[(tr + 16 * i) * LDM + s];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = Xs[s * P16 + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) yi[i][j] = fmaf(mv[i], xv[j], yi[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tr + 16 * i;
        const int s = c0 + t;
        if (s < S) {
#pragma unroll
          for (int j = 0; j < PJ; ++j) {
            const int p = tc + 16 * j;
            if (p < P) store(&yb[s * ys + p], yi[i][j] + yst[i][j] * eL[t]);
          }
        }
      }
    }
    __syncthreads();  // every thread has read the old state

    // h <- exp(L_end) h + sum_s w_s x_s (x) B_s: rows tr + 16 i of P,
    // columns tc + 16 j of N
    {
      float acc[PJ][NJ];
#pragma unroll
      for (int i = 0; i < PJ; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
      for (int s = 0; s < Q; ++s) {
        const float w = ws[s];
        float xv[PJ], bv[NJ];
#pragma unroll
        for (int i = 0; i < PJ; ++i) xv[i] = Xs[s * P16 + tr + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < NJ; ++j) bv[j] = Bs[s * LDN + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < PJ; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
      const float decay = eL[Q - 1];
#pragma unroll
      for (int i = 0; i < PJ; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float* hp = &Hs[(tr + 16 * i) * LDN + tc + 16 * j];
          *hp = decay * *hp + acc[i][j];
        }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += THREADS) {
    const int p = idx / N, n = idx - p * N;
    hf[hoff + idx] = Hs[p * LDN + n];
  }
}

struct Args {
  const void *x, *dt, *A, *Bm, *Cm, *h0;
  void *y, *hf;
  int B;
  cudaStream_t stream;
};

template <typename T, int PJ, int NJ>
cudaError_t launch(const Args& a, const Dims& d) {
  constexpr int smem = smem_floats<PJ, NJ>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, PJ, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T, PJ, NJ><<<a.B * d.H, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const T*>(a.Bm),
      static_cast<const T*>(a.Cm), static_cast<const float*>(a.h0),
      static_cast<T*>(a.y), static_cast<float*>(a.hf), d);
  return cudaGetLastError();
}

// 1, 2, 4 or 8 tiles of 16: the least that covers n <= 128
int tiles(int n) {
  int t = 1;
  while (16 * t < n) t *= 2;
  return t;
}

template <typename T, int PJ>
cudaError_t launch_nj(const Args& a, const Dims& d) {
  switch (tiles(d.N)) {
    case 1: return launch<T, PJ, 1>(a, d);
    case 2: return launch<T, PJ, 2>(a, d);
    case 4: return launch<T, PJ, 4>(a, d);
    default: return launch<T, PJ, 8>(a, d);
  }
}

template <typename T>
cudaError_t launch_pj(const Args& a, const Dims& d) {
  switch (tiles(d.P)) {
    case 1: return launch_nj<T, 1>(a, d);
    case 2: return launch_nj<T, 2>(a, d);
    case 4: return launch_nj<T, 4>(a, d);
    default: return launch_nj<T, 8>(a, d);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  dtype (of x, Bm,
// Cm and y): 0 = f32, 1 = bf16.  h0 may be null (zero initial state).
// Strides are in elements.  The caller checks shapes, dtypes, the last-dim
// strides, P <= 128 and N <= 128.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* h0,
                            void* y, void* hf, int B, int S, int H, int P, int N,
                            long long sxb, long long sxs, long long sxh,
                            long long sdb, long long sds, long long sdh,
                            long long sbb, long long sbs, long long scb,
                            long long scs, int dtype, void* stream) {
  if (P < 1 || P > MAX_DIM || N < 1 || N > MAX_DIM) return (int)cudaErrorInvalidValue;
  const Dims d{S, H, P, N, sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, scb, scs};
  const Args a{x, dt, A, Bm, Cm, h0, y, hf, B, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_pj<float>(a, d);
  if (dtype == 1) return launch_pj<__nv_bfloat16>(a, d);
  return (int)cudaErrorInvalidValue;
}
