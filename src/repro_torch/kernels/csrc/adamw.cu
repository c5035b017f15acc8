// Fused AdamW update of one parameter tree for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces no TPU kernel.  The JAX package's AdamW (src/repro/optim/
// adamw.py) is elementwise code that XLA fuses into a few passes under
// jit; run eagerly, the same arithmetic in PyTorch is some twenty-five
// elementwise kernels a leaf (casts, multiplies, adds, a divide, a square
// root), each a pass over device memory.  This file does the clip and the
// step in two passes over each parameter, in kernels written by hand
// because no single PyTorch call computes it (`torch.optim.AdamW` decays
// every leaf; here only leaves with ndim >= 2 decay).
//
// What it computes, for the leaves of one tree (the trainers clip and step
// each stage tree and each data-node head on its own), the same arithmetic
// at the same points of rounding as `kernels/ops.py::adamw_update_plain`:
//   g     = round_to_grad_dtype(g_raw * (1 / n))   the mean's divide, as
//           PyTorch's `a / n` by a host scalar computes it on the card
//   gnorm = sqrt(sum over the tree of g^2)          in f32
//   scale = min((1 / (gnorm + 1e-9)) * clip, 1)     absent without a clip
//   m' = b1 m + (1 - b1) g scale,  v' = b2 v + (1 - b2) (g scale)^2
//   delta = (m' / b1t) / (sqrt(v' / b2t) + eps) [+ wd p, ndim >= 2 only]
//   p' = round_to_param_dtype(p - lr delta)
// with b1t = 1 - b1^t, b2t = 1 - b2^t at t = step + 1 read from the device.
// Every product, sum, quotient and root is IEEE round-to-nearest (the
// __f*_rn intrinsics, so nvcc contracts nothing into an FMA), as the
// separate PyTorch kernels round each.  Only the norm's sum is taken in
// another order: in f64 per thread and block, then rounded to f32.
//
// Bound on the H100 (SXM, 3.35 TB/s).  For a bf16 parameter with a bf16
// gradient and f32 moments the update reads g, p, m, v and writes p', m',
// v' once, 2 + 2 + 4 + 4 + 2 + 4 + 4 = 22 B, and the norm reads g once
// more, 2 B: 24 B a parameter (32 for an f32 leaf).  At the 2.19 B
// parameters of the 7B cell's three trees that is 52.5 GB, 15.7 ms.
// Bytes bound it; the arithmetic (a divide and a root an element) is far
// below the card's rate.
//
// Design.  A launch takes a table of up to kMaxLeaves leaves by value in
// its arguments (pointers, element count, flags; __grid_constant__, so it
// is read in place from the constant bank), so nothing is copied to the
// device and nothing waits for the host.  Each leaf is cut into chunks of
// kChunk elements; chunk c belongs to the leaf whose cumulative chunk end
// first exceeds c.  A block walks chunks c = blockIdx.x, + gridDim.x, ...;
// each of its 256 threads takes two packs of 8 elements of a chunk, read
// with 16-byte loads (one for 8 bf16 values, two for 8 floats) when all of
// the leaf's pointers are 16-byte aligned and the pack is whole, else one
// element at a time.  A thread issues all its loads of a chunk before it
// computes: at about 100 registers two blocks fit an SM, and each thread
// keeps 192 bytes of a bf16 leaf in flight.  On the H100, loading and
// updating one pack at a time (80 registers, three blocks an SM) moved
// the 7B stage tree's bytes at 65 % of 3.35 TB/s, the two packs at 80-86 %;
// more blocks at fewer registers, or cache-streaming loads, were slower.
//   1. adamw_norm_kernel: each block sums the squares of its chunks'
//      gradients (after the divide) in f32 over a pack and in f64 across
//      packs, reduces over the block in a fixed order and writes one f64
//      partial.
//   2. adamw_step_kernel: each block first sums all the partials in a
//      fixed order, so every block gets the same norm, with no atomics and
//      bit-equal from call to call; then updates its chunks and writes
//      p', m' and v' into new tensors.  Block 0 writes t into the new step.
// A tree is one launch of each: the largest tree any configuration updates
// (a VLM's whole model in the sharded step) has 24 leaves.  A tree of
// DTensor leaves updates its local shards; kernels/adamw.py sums the
// partials over the mesh between the two launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPack = 8;            // elements a thread takes at a time
constexpr int kChunk = 4096;        // elements of a chunk: kernels/adamw.py CHUNK
constexpr int kMaxLeaves = 48;      // leaves of a launch: kernels/adamw.py MAX_LEAVES
constexpr int kPacks = kChunk / (kThreads * kPack);   // packs a thread takes of a chunk
static_assert(kPacks * kThreads * kPack == kChunk, "a chunk is whole packs of every thread");

enum : int { kDecay = 1, kGradBf16 = 2, kParamBf16 = 4 };

// One leaf of the table; kernels/adamw.py::Leaf mirrors this layout.
struct Leaf {
  const void* g;
  const void* p;
  const float* m;
  const float* v;
  void* p_out;
  float* m_out;
  float* v_out;
  long long numel;
  int chunk_end;      // chunks of this leaf and of the leaves before it
  int flags;
};
static_assert(sizeof(Leaf) == 72, "kernels/adamw.py::Leaf mirrors this layout");

struct Table {
  Leaf leaf[kMaxLeaves];
  int n;
};

struct Hyper {
  float lr, b1, b2, c1, c2, eps, wd, clip;   // c1 = 1 - b1, c2 = 1 - b2
  int clip_on;
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ static void load8(const void* base, long long e, float* x) {
    const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(base) + e);
    const float4 a = q[0], b = q[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
  __device__ static void store8(void* base, long long e, const float* x) {
    float4* q = reinterpret_cast<float4*>(static_cast<float*>(base) + e);
    q[0] = make_float4(x[0], x[1], x[2], x[3]);
    q[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
  __device__ static float load1(const void* base, long long e) {
    return static_cast<const float*>(base)[e];
  }
  __device__ static void store1(void* base, long long e, float x) {
    static_cast<float*>(base)[e] = x;
  }
  __device__ static float round(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  __device__ static void load8(const void* base, long long e, float* x) {
    const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(base) + e);
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
  __device__ static void store8(void* base, long long e, const float* x) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      memcpy(&w[i], &h, sizeof(h));
    }
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(base) + e) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float load1(const void* base, long long e) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[e]);
  }
  __device__ static void store1(void* base, long long e, float x) {
    static_cast<__nv_bfloat16*>(base)[e] = __float2bfloat16_rn(x);
  }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

// The leaf that holds chunk c, searching on from leaf j (a block's chunks
// rise, so its search never goes back).
__device__ __forceinline__ int locate(const Table& t, int c, int j) {
  while (c >= t.leaf[j].chunk_end) ++j;
  return j;
}

// The sum over the block, in a fixed order, returned to every thread.
__device__ double block_sum(double x) {
  __shared__ double warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  double s = 0.0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
  __syncthreads();
  return s;
}

// A thread's packs of a chunk [lo, hi): pack u starts at pack_start(lo, u)
// and holds pack_size(e, hi) of the leaf's elements (0 past its end).
__device__ __forceinline__ long long pack_start(long long lo, int u) {
  return lo + (long long)(threadIdx.x + u * kThreads) * kPack;
}

__device__ __forceinline__ int pack_size(long long e, long long hi) {
  return e >= hi ? 0 : (hi - e < kPack ? (int)(hi - e) : kPack);
}

// A pack of k elements: one or two 16-byte loads or stores when `whole`
// (k == kPack and the leaf aligned), else element by element; zeros past k.
template <typename T>
__device__ __forceinline__ void load_pack(const void* base, long long e, int k, bool whole,
                                          float* x) {
  if (whole) {
    Elem<T>::load8(base, e, x);
    return;
  }
#pragma unroll
  for (int i = 0; i < kPack; ++i) x[i] = i < k ? Elem<T>::load1(base, e + i) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store_pack(void* base, long long e, int k, bool whole,
                                           const float* x) {
  if (whole) {
    Elem<T>::store8(base, e, x);
    return;
  }
#pragma unroll
  for (int i = 0; i < kPack; ++i)
    if (i < k) Elem<T>::store1(base, e + i, x[i]);
}

// Sum of squares of a chunk's gradients after the divide: f32 over a
// pack, f64 across packs.  All of a thread's loads are issued first.
template <typename GT>
__device__ double chunk_sumsq(const Leaf& L, long long lo, long long hi, float inv_n) {
  const bool vec = aligned16(L.g);
  float g[kPacks][kPack];
#pragma unroll
  for (int u = 0; u < kPacks; ++u) {
    const long long e = pack_start(lo, u);
    const int k = pack_size(e, hi);
    load_pack<GT>(L.g, e, k, vec && k == kPack, g[u]);
  }
  double acc = 0.0;
#pragma unroll
  for (int u = 0; u < kPacks; ++u) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kPack; ++i) {
      const float gq = Elem<GT>::round(__fmul_rn(g[u][i], inv_n));
      s = __fadd_rn(s, __fmul_rn(gq, gq));
    }
    acc += (double)s;
  }
  return acc;
}

// The update of a chunk: all the thread's loads first (12 of 16 bytes for a
// bf16 leaf), then each pack's arithmetic and stores.
template <typename GT, typename PT>
__device__ void chunk_step(const Leaf& L, long long lo, long long hi, const Hyper& h,
                           float inv_n, float scale, float b1t, float b2t) {
  const bool decay = L.flags & kDecay;
  const bool vec = aligned16(L.g) && aligned16(L.p) && aligned16(L.m) && aligned16(L.v) &&
                   aligned16(L.p_out) && aligned16(L.m_out) && aligned16(L.v_out);
  float g[kPacks][kPack], p[kPacks][kPack], m[kPacks][kPack], v[kPacks][kPack];
#pragma unroll
  for (int u = 0; u < kPacks; ++u) {
    const long long e = pack_start(lo, u);
    const int k = pack_size(e, hi);
    const bool whole = vec && k == kPack;
    load_pack<GT>(L.g, e, k, whole, g[u]);
    load_pack<PT>(L.p, e, k, whole, p[u]);
    load_pack<float>(L.m, e, k, whole, m[u]);
    load_pack<float>(L.v, e, k, whole, v[u]);
  }
#pragma unroll
  for (int u = 0; u < kPacks; ++u) {
#pragma unroll
    for (int i = 0; i < kPack; ++i) {
      float gs = Elem<GT>::round(__fmul_rn(g[u][i], inv_n));
      if (h.clip_on) gs = __fmul_rn(gs, scale);
      m[u][i] = __fadd_rn(__fmul_rn(h.b1, m[u][i]), __fmul_rn(h.c1, gs));
      v[u][i] = __fadd_rn(__fmul_rn(h.b2, v[u][i]), __fmul_rn(h.c2, __fmul_rn(gs, gs)));
      float delta = __fdiv_rn(__fdiv_rn(m[u][i], b1t),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(v[u][i], b2t)), h.eps));
      if (decay) delta = __fadd_rn(delta, __fmul_rn(h.wd, p[u][i]));
      p[u][i] = __fsub_rn(p[u][i], __fmul_rn(h.lr, delta));
    }
    const long long e = pack_start(lo, u);
    const int k = pack_size(e, hi);
    const bool whole = vec && k == kPack;
    store_pack<PT>(L.p_out, e, k, whole, p[u]);
    store_pack<float>(L.m_out, e, k, whole, m[u]);
    store_pack<float>(L.v_out, e, k, whole, v[u]);
  }
}

__global__ void __launch_bounds__(kThreads)
adamw_norm_kernel(const __grid_constant__ Table t, int chunks, float divisor,
                  double* partials) {
  const float inv_n = __frcp_rn(divisor);
  double acc = 0.0;
  int j = 0;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    j = locate(t, c, j);
    const Leaf& L = t.leaf[j];
    const long long lo = (long long)(c - (j ? t.leaf[j - 1].chunk_end : 0)) * kChunk;
    const long long hi = lo + kChunk < L.numel ? lo + kChunk : L.numel;
    acc += (L.flags & kGradBf16) ? chunk_sumsq<__nv_bfloat16>(L, lo, hi, inv_n)
                                 : chunk_sumsq<float>(L, lo, hi, inv_n);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
adamw_step_kernel(const __grid_constant__ Table t, int chunks, const double* partials,
                  int n_partials, Hyper h, float divisor, const int* step_in,
                  int* step_out) {
  const float inv_n = __frcp_rn(divisor);
  float scale = 1.f;
  if (h.clip_on) {
    double s = 0.0;
    for (int i = threadIdx.x; i < n_partials; i += kThreads) s += partials[i];
    s = block_sum(s);
    const float gnorm = __fsqrt_rn(__double2float_rn(s));
    const float r = __fmul_rn(__frcp_rn(__fadd_rn(gnorm, 1e-9f)), h.clip);
    scale = r > 1.f ? 1.f : r;   // a NaN norm stays NaN, as torch.clamp keeps it
  }
  const int step = *step_in + 1;
  if (blockIdx.x == 0 && threadIdx.x == 0) *step_out = step;
  const float b1t = __fsub_rn(1.f, powf(h.b1, (float)step));
  const float b2t = __fsub_rn(1.f, powf(h.b2, (float)step));
  int j = 0;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    j = locate(t, c, j);
    const Leaf& L = t.leaf[j];
    const long long lo = (long long)(c - (j ? t.leaf[j - 1].chunk_end : 0)) * kChunk;
    const long long hi = lo + kChunk < L.numel ? lo + kChunk : L.numel;
    switch (L.flags & (kGradBf16 | kParamBf16)) {
      case 0:
        chunk_step<float, float>(L, lo, hi, h, inv_n, scale, b1t, b2t);
        break;
      case kGradBf16:
        chunk_step<__nv_bfloat16, float>(L, lo, hi, h, inv_n, scale, b1t, b2t);
        break;
      case kParamBf16:
        chunk_step<float, __nv_bfloat16>(L, lo, hi, h, inv_n, scale, b1t, b2t);
        break;
      default:
        chunk_step<__nv_bfloat16, __nv_bfloat16>(L, lo, hi, h, inv_n, scale, b1t, b2t);
        break;
    }
  }
}

bool fill(Table* t, const void* leaves, int n_leaves) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves) return false;
  memcpy(t->leaf, leaves, sizeof(Leaf) * n_leaves);
  t->n = n_leaves;
  return true;
}

}  // namespace

// Blocks of the update pass: as many as fit on the card at once, and no
// more than there are chunks (at least one, which writes the step).
static cudaError_t step_blocks(int chunks, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adamw_step_kernel, kThreads, 0);
  const int fit = sms * (per_sm > 0 ? per_sm : 1);
  *blocks = chunks < 1 ? 1 : (chunks < fit ? chunks : fit);
  return err;
}

// The norm pass over a tree's leaves: `blocks` partial sums of squares
// (f64) into `partials`.
extern "C" int adamw_norm(const void* leaves, int n_leaves, int chunks, int blocks,
                          float divisor, void* partials, void* stream) {
  Table t;
  if (!fill(&t, leaves, n_leaves) || blocks < 1) return (int)cudaErrorInvalidValue;
  adamw_norm_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, chunks, divisor, static_cast<double*>(partials));
  return (int)cudaGetLastError();
}

// The update pass over a tree's leaves, clipped by the norm of all
// `n_partials` partials when `clip_on`; writes t = step + 1 into `step_out`.
extern "C" int adamw_step(const void* leaves, int n_leaves, int chunks, const void* partials,
                          int n_partials, int clip_on, float clip, float divisor, float lr,
                          float b1, float b2, float c1, float c2, float eps,
                          float weight_decay, const void* step_in, void* step_out,
                          void* stream) {
  Table t;
  if (!fill(&t, leaves, n_leaves)) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err = step_blocks(chunks, &blocks);
  if (err != cudaSuccess) return (int)err;
  const Hyper h{lr, b1, b2, c1, c2, eps, weight_decay, clip, clip_on};
  adamw_step_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, chunks, static_cast<const double*>(partials), n_partials, h, divisor,
      static_cast<const int*>(step_in), static_cast<int*>(step_out));
  return (int)cudaGetLastError();
}
