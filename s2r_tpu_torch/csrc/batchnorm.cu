// Train-mode BatchNorm over a channels-last [M, C] matrix, both
// directions, two launches each (three for large inputs):
//
//   forward   bn_sums<kForward>: per-channel (sum x, sum x^2) over slabs of
//             rows (x read once), the slabs folded in a fixed order by the
//             last block of each channel chunk (or, for inputs with many
//             slabs, by bn_fold, one launch more), then per channel mean, var
//             (E[x^2] - mean^2, as the JAX package computes it), rstd, inv =
//             rstd * weight, shift = bias - mean * inv, and the running mean
//             and unbiased running variance updated in place (momentum over
//             the count of the zero-padding ring);
//             bn_elementwise: y = x * inv + shift in float32, written in x's
//             type.
//   backward  bn_sums<kBackward>: (sum g, sum g*x), folded likewise, then
//             G = sum g + d(shift), t = sum gx - mean * G, dweight = rstd *
//             t, dbias = G, and the dx coefficients b = -inv * rstd^2 * t /
//             n and c0 = -inv * G / n - b * mean;
//             bn_elementwise<DX>: dx = g * inv + x * b + c0 in float32,
//             written in x's type.
//
// Replaces the TPU kernels s2r_tpu/ops/pallas/batchnorm.py::pair_sums and
// the composite batch_norm_train around it (with the ring's shift and its
// cotangent, which the port adds).  The Pallas kernel carries its sums
// across a sequential grid in VMEM scratch and leaves y and dx to XLA, which
// fuses them on the TPU; here blocks run in parallel and carry nothing, and
// nothing would fuse the per-channel math and the elementwise passes, so
// each is a kernel.  No atomics on the sums: the fold order is fixed and
// every output is the same bit for bit from run to run.  One float32 workspace a call holds
// the per-channel rows and the slab partials (ops/kernels/batchnorm.py);
// the last block of a chunk is found with an arrival counter, so on small
// inputs the fold and the per-channel epilogue cost no launch of their own.
//
// What bounds it on an H100: device-memory bytes.  The sums read x (or g
// and x) once at 2-3 flops an element; apply reads x and writes y; dx reads
// g and x and writes dx; the fold touches a few MB of partials.  Most of
// the step's 60 BatchNorms are small (16K rows), where the host's launch
// cost dominates: hence the fold in the sums' last block there.  On large
// inputs (hundreds of slabs) one block folding a chunk would be a long
// serial tail, so a fold kernel of 32 lanes a channel does it.  All read
// and write 16-byte channel vectors (8 bf16 or 4 f32), neighbouring threads
// on neighbouring vectors.  A C that is not a multiple of the vector, or an
// unaligned pointer, takes the same kernels one channel at a time.  Row
// indices are 64-bit in the sums; the elementwise kernels index in 32 bits
// while the size allows and in 64 bits beyond, so any M runs in one launch.
//
// Built by plain nvcc into a shared library with a C interface and loaded
// with ctypes (s2r_tpu_torch/ops/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "slab_fold.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = to_f32(*p);
  } else {
    static_assert(V * sizeof(T) == 16, "vector loads are 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_f32(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&in)[V]) {
  if constexpr (V == 1) {
    *p = from_f32<T>(in[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f32<T>(in[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// Rows of the per-channel block at the head of each workspace.
enum StatRow { kSumX, kSumXX, kMean, kVar, kRstd, kInv, kShift, kStatRows };
enum GradRow { kSumG, kSumGX, kDWeight, kDBias, kCoefB, kCoefC0, kGradRows };

struct FoldArgs {
  float* ws;               // [rows][c] per-channel block, then [slabs][2][c] partials
  float count, eps, keep, momentum, unbias;  // keep = 1 - momentum
  const float *weight, *bias;                // forward
  float *running_mean, *running_var;         // forward; null: not tracked
  const float *mean, *rstd, *inv, *gshift;   // backward; gshift may be null
};

enum FoldMode { kForward, kBackward };

// One arrival counter per channel chunk, shared by every call of this
// library: the last block of a chunk to finish resets its counter to 0, so
// each call finds them at 0.  Calls must therefore run one at a time (on one
// stream), as the port's do.
constexpr int kMaxChunks = 1024;
__device__ unsigned g_arrivals[kMaxChunks];

// The direction's per-channel epilogue for channel j from its two sums.
// The arithmetic is the plain versions', operation by operation.
template <FoldMode MODE>
__device__ __forceinline__ void epilogue(const FoldArgs& f, int c, int j, float sa, float sab) {
  float* ws = f.ws;
  if constexpr (MODE == kForward) {
    const float mean = __fdiv_rn(sa, f.count);
    const float var = __fsub_rn(__fdiv_rn(sab, f.count), __fmul_rn(mean, mean));
    const float rstd = rsqrtf(__fadd_rn(var, f.eps));
    const float inv = __fmul_rn(rstd, f.weight[j]);
    const float shift = __fsub_rn(f.bias[j], __fmul_rn(mean, inv));
    ws[kSumX * c + j] = sa;
    ws[kSumXX * c + j] = sab;
    ws[kMean * c + j] = mean;
    ws[kVar * c + j] = var;
    ws[kRstd * c + j] = rstd;
    ws[kInv * c + j] = inv;
    ws[kShift * c + j] = shift;
    if (f.running_mean != nullptr) {
      f.running_mean[j] = __fadd_rn(__fmul_rn(f.keep, f.running_mean[j]),
                                    __fmul_rn(f.momentum, mean));
      f.running_var[j] = __fadd_rn(__fmul_rn(f.keep, f.running_var[j]),
                                   __fmul_rn(f.momentum, __fmul_rn(var, f.unbias)));
    }
  } else {
    const float mean = f.mean[j], rstd = f.rstd[j], inv = f.inv[j];
    const float big_g = f.gshift != nullptr ? __fadd_rn(sa, f.gshift[j]) : sa;
    const float t = __fsub_rn(sab, __fmul_rn(mean, big_g));
    const float b = __fdiv_rn(__fmul_rn(__fmul_rn(__fmul_rn(-inv, rstd), rstd), t), f.count);
    const float c0 = __fsub_rn(__fdiv_rn(__fmul_rn(-inv, big_g), f.count), __fmul_rn(b, mean));
    ws[kSumG * c + j] = sa;
    ws[kSumGX * c + j] = sab;
    ws[kDWeight * c + j] = __fmul_rn(rstd, t);
    ws[kDBias * c + j] = big_g;
    ws[kCoefB * c + j] = b;
    ws[kCoefC0 * c + j] = c0;
  }
}

constexpr int kRowsInFlight = 4;   // loads a thread issues ahead of its sums
constexpr int kSlabsInFlight = 8;

// Channel j's two sums over slabs lane, lane + lanes, ... of the partials
// [slabs][2][c], added in slab order; kSlabsInFlight slabs' loads are
// issued before their sums.
__device__ __forceinline__ void fold_slabs(const float* part, int c, int j, int lane, int lanes,
                                           int slabs, float& sa, float& sab) {
  int i = lane;
  for (; i + (kSlabsInFlight - 1) * lanes < slabs; i += kSlabsInFlight * lanes) {
    float pa[kSlabsInFlight], pab[kSlabsInFlight];
#pragma unroll
    for (int u = 0; u < kSlabsInFlight; ++u) {
      pa[u] = __ldcg(part + (size_t)(i + u * lanes) * 2 * c + j);
      pab[u] = __ldcg(part + (size_t)(i + u * lanes) * 2 * c + c + j);
    }
#pragma unroll
    for (int u = 0; u < kSlabsInFlight; ++u) {
      sa += pa[u];
      sab += pab[u];
    }
  }
  for (; i < slabs; i += lanes) {
    sa += __ldcg(part + (size_t)i * 2 * c + j);
    sab += __ldcg(part + (size_t)i * 2 * c + c + j);
  }
}

// Per-channel (sum a, sum a*b) over the rows of [m, c], then the
// direction's epilogue, in one launch.  Block (chunk, slab) covers bx
// channel vectors of a slab of rows: each thread sums every by-th row in
// float32, the block folds its rows with a fixed tree and writes its
// partials [slab][2][c] into the workspace.  The last block of a chunk to
// arrive (a ticket counter, g_arrivals) then folds the chunk's slabs: L =
// by / V lanes a channel, lane l summing slabs l, l + L, ... in order,
// then a fixed tree over the lanes, and lane 0 runs the epilogue.  No
// atomics on the sums and a fixed order: the same bits on every call.
template <typename T, int V, bool SAME, FoldMode MODE, bool FUSED>
__global__ void bn_sums(const T* __restrict__ a, const T* __restrict__ b, FoldArgs f,
                        int64_t m, int c, int64_t rows_per_slab) {
  __shared__ float sh[kSlabThreads * 2 * V];
  __shared__ bool last;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nvec = c / V;
  const int vec = blockIdx.x * blockDim.x + tx;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_slab;
  const int64_t r1 = min(r0 + rows_per_slab, m);
  float* part = f.ws + (size_t)(MODE == kForward ? kStatRows : kGradRows) * c;
  float sa[V], sab[V];
#pragma unroll
  for (int v = 0; v < V; ++v) sa[v] = sab[v] = 0.0f;
  if (vec < nvec) {
    const T* pa = a + (size_t)vec * V;
    const T* pb = b + (size_t)vec * V;
    const int64_t step = blockDim.y;
    int64_t r = r0 + ty;
    // kRowsInFlight rows' loads are issued before their sums, which still
    // add in row order.
    for (; r + (kRowsInFlight - 1) * step < r1; r += kRowsInFlight * step) {
      float av[kRowsInFlight][V], bv[kRowsInFlight][V];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        load<T, V>(pa + (size_t)(r + u * step) * c, av[u]);
        if constexpr (!SAME) load<T, V>(pb + (size_t)(r + u * step) * c, bv[u]);
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          sa[v] += av[u][v];
          sab[v] += av[u][v] * (SAME ? av[u][v] : bv[u][v]);
        }
    }
    for (; r < r1; r += step) {
      float av[V], bv[V];
      load<T, V>(pa + (size_t)r * c, av);
      if constexpr (!SAME) load<T, V>(pb + (size_t)r * c, bv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        sa[v] += av[v];
        sab[v] += av[v] * (SAME ? av[v] : bv[v]);
      }
    }
  }
  float* mine = sh + (ty * blockDim.x + tx) * 2 * V;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    mine[v] = sa[v];
    mine[V + v] = sab[v];
  }
  __syncthreads();
  // blockDim.y is a power of two: a fixed tree over the rows of the block.
  for (int s = blockDim.y / 2; s > 0; s >>= 1) {
    if (ty < s) {
      const float* other = sh + ((ty + s) * blockDim.x + tx) * 2 * V;
#pragma unroll
      for (int v = 0; v < 2 * V; ++v) mine[v] += other[v];
    }
    __syncthreads();
  }
  if (ty == 0 && vec < nvec) {
    float* out_a = part + (size_t)blockIdx.y * 2 * c + (size_t)vec * V;
    float* out_ab = out_a + c;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      out_a[v] = mine[v];
      out_ab[v] = mine[V + v];
    }
  }

  if constexpr (!FUSED) return;  // bn_fold folds the slabs

  // Arrival: the partials are visible device-wide before the ticket.
  __threadfence();
  __syncthreads();
  if (tx == 0 && ty == 0) {
    const unsigned ticket = atomicAdd(&g_arrivals[blockIdx.x], 1u);
    last = ticket == gridDim.y - 1;
    if (last) g_arrivals[blockIdx.x] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // Fold the chunk's slabs: channel q of the chunk, lane l.
  const int nch = blockDim.x * V;          // channels a chunk
  const int lanes = blockDim.y / V;        // >= 1: by >= V (slab_plan)
  const int tid = ty * blockDim.x + tx;
  const int q = tid % nch, l = tid / nch;
  const int j = blockIdx.x * nch + q;
  const int slabs = (int)gridDim.y;
  float fa = 0.0f, fab = 0.0f;
  if (l < lanes && j < c) fold_slabs(part, c, j, l, lanes, slabs, fa, fab);
  float* fsh = sh;  // [lanes][2][nch]
  if (l < lanes) {
    fsh[(l * 2) * nch + q] = fa;
    fsh[(l * 2 + 1) * nch + q] = fab;
  }
  __syncthreads();
  for (int s = lanes / 2; s > 0; s >>= 1) {
    if (l < s) {
      fsh[(l * 2) * nch + q] += fsh[((l + s) * 2) * nch + q];
      fsh[(l * 2 + 1) * nch + q] += fsh[((l + s) * 2 + 1) * nch + q];
    }
    __syncthreads();
  }
  if (l == 0 && j < c) epilogue<MODE>(f, c, j, fsh[q], fsh[nch + q]);
}

// The fold as a kernel of its own, for inputs with many slabs, where one
// block folding a chunk would be a long serial tail: the fold of
// slab_fold.cuh for both sums of a channel (lane l sums slabs l, l +
// kFoldLanes, ... in order, then a fixed tree over the lanes), then the
// epilogue.
template <FoldMode MODE>
__global__ void bn_fold(FoldArgs f, int c, int slabs) {
  __shared__ float sh[2][kFoldLanes][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * 32 + tx;
  const float* part = f.ws + (size_t)(MODE == kForward ? kStatRows : kGradRows) * c;
  float sa = 0.0f, sab = 0.0f;
  if (j < c) fold_slabs(part, c, j, ty, kFoldLanes, slabs, sa, sab);
  sh[0][ty][tx] = sa;
  sh[1][ty][tx] = sab;
  __syncthreads();
  for (int step = kFoldLanes / 2; step > 0; step >>= 1) {
    if (ty < step) {
      sh[0][ty][tx] += sh[0][ty + step][tx];
      sh[1][ty][tx] += sh[1][ty + step][tx];
    }
    __syncthreads();
  }
  if (ty == 0 && j < c) epilogue<MODE>(f, c, j, sh[0][0][tx], sh[1][0][tx]);
}

// y = x * p[ch] + q[ch] (apply: p = inv, q = shift), or with DX, dx = g *
// p[ch] + x * r[ch] + q[ch] (p = inv, r = b, q = c0); float32 math, each
// product and sum rounded on its own as in the plain versions.  One thread
// a channel vector of one row; I indexes the vectors.
template <typename T, int V, typename I, bool DX>
__global__ void bn_elementwise(const T* __restrict__ g, const T* __restrict__ x,
                               const float* __restrict__ p, const float* __restrict__ r,
                               const float* __restrict__ q, T* __restrict__ out, I total,
                               int nvec) {
  const I i = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int ch = (int)(i % (I)nvec) * V;
  const size_t off = (size_t)i * V;
  float xv[V], o[V];
  load<T, V>(x + off, xv);
  if constexpr (DX) {
    float gv[V];
    load<T, V>(g + off, gv);
#pragma unroll
    for (int v = 0; v < V; ++v)
      o[v] = __fadd_rn(__fadd_rn(__fmul_rn(gv[v], __ldg(p + ch + v)),
                                 __fmul_rn(xv[v], __ldg(r + ch + v))),
                       __ldg(q + ch + v));
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      o[v] = __fadd_rn(__fmul_rn(xv[v], __ldg(p + ch + v)), __ldg(q + ch + v));
  }
  store<T, V>(out + off, o);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
bool vectorized(const void* a, const void* b, int64_t c) {
  constexpr int V = 16 / sizeof(T);
  return c % V == 0 && aligned16(a) && aligned16(b);
}

template <typename T>
SlabPlan plan(const void* a, const void* b, int64_t m, int64_t c) {
  constexpr int V = 16 / sizeof(T);
  return slab_plan(m, (int)(vectorized<T>(a, b, c) ? c / V : c));
}

// The last block of a chunk folds its slabs while that costs each of its
// threads at most this many loads; beyond, bn_fold does (one launch more).
constexpr int kFusedFoldLoads = 256;

template <typename T, int V, bool SAME, FoldMode MODE>
void sums_v(const T* a, const T* b, const FoldArgs& f, int64_t m, int64_t c, const SlabPlan& p,
            cudaStream_t stream) {
  const dim3 grid(p.chunks, (unsigned)p.slabs), block(p.bx, p.by);
  const int lanes = p.by / V;
  if (2 * p.slabs <= (int64_t)kFusedFoldLoads * lanes) {
    bn_sums<T, V, SAME, MODE, true><<<grid, block, 0, stream>>>(a, b, f, m, (int)c, p.per_slab);
  } else {
    bn_sums<T, V, SAME, MODE, false><<<grid, block, 0, stream>>>(a, b, f, m, (int)c, p.per_slab);
    bn_fold<MODE><<<(unsigned)((c + 31) / 32), dim3(32, kFoldLanes), 0, stream>>>(
        f, (int)c, (int)p.slabs);
  }
}

// The sums and their epilogue: one launch, two for many slabs.
template <typename T, FoldMode MODE>
int sums(const void* a, const void* b, const FoldArgs& f, int64_t m, int64_t c,
         cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const SlabPlan p = plan<T>(a, b, m, c);
  if (p.chunks > kMaxChunks) return (int)cudaErrorInvalidValue;
  const T *ta = (const T*)a, *tb = (const T*)b;
  if (vectorized<T>(a, b, c)) {
    if (a == b) sums_v<T, V, true, MODE>(ta, tb, f, m, c, p, stream);
    else sums_v<T, V, false, MODE>(ta, tb, f, m, c, p, stream);
  } else {
    if (a == b) sums_v<T, 1, true, MODE>(ta, tb, f, m, c, p, stream);
    else sums_v<T, 1, false, MODE>(ta, tb, f, m, c, p, stream);
  }
  return (int)cudaGetLastError();
}

template <typename T, int V, typename I, bool DX>
void elementwise_v(const T* g, const T* x, const float* p, const float* r, const float* q,
                   T* out, int64_t total, int nvec, cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  bn_elementwise<T, V, I, DX><<<(unsigned)blocks, threads, 0, stream>>>(
      g, x, p, r, q, out, (I)total, nvec);
}

template <typename T, bool DX>
int elementwise(const void* g, const void* x, const float* p, const float* r, const float* q,
                void* out, int64_t m, int64_t c, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = vectorized<T>(DX ? g : x, x, c) && aligned16(out);
  const int64_t nvec = vec ? c / V : c;
  const int64_t total = m * nvec;
  // 32-bit indices while every thread's index fits them (the last block's
  // padding threads included)
  const bool small = total <= ((int64_t)1 << 32) - 256;
  const T *tg = (const T*)g, *tx = (const T*)x;
  T* to = (T*)out;
  if (vec) {
    if (small) elementwise_v<T, V, unsigned, DX>(tg, tx, p, r, q, to, total, (int)nvec, stream);
    else elementwise_v<T, V, uint64_t, DX>(tg, tx, p, r, q, to, total, (int)nvec, stream);
  } else {
    if (small) elementwise_v<T, 1, unsigned, DX>(tg, tx, p, r, q, to, total, (int)nvec, stream);
    else elementwise_v<T, 1, uint64_t, DX>(tg, tx, p, r, q, to, total, (int)nvec, stream);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int stats(const void* x, const void* weight, const void* bias, void* running_mean,
          void* running_var, void* ws, int64_t m, int64_t c, double count, double eps,
          double momentum, void* stream) {
  FoldArgs f = {};
  f.ws = (float*)ws;
  f.count = (float)count;
  f.eps = (float)eps;
  f.keep = (float)(1.0 - momentum);
  f.momentum = (float)momentum;
  f.unbias = (float)(count / (count > 1.0 ? count - 1.0 : 1.0));
  f.weight = (const float*)weight;
  f.bias = (const float*)bias;
  f.running_mean = (float*)running_mean;
  f.running_var = (float*)running_var;
  return sums<T, kForward>(x, x, f, m, c, (cudaStream_t)stream);
}

template <typename T>
int grad_sums(const void* g, const void* x, const void* st, const void* gshift, void* ws,
              int64_t m, int64_t c, double count, void* stream) {
  const float* s = (const float*)st;
  FoldArgs f = {};
  f.ws = (float*)ws;
  f.count = (float)count;
  f.mean = s + kMean * c;
  f.rstd = s + kRstd * c;
  f.inv = s + kInv * c;
  f.gshift = (const float*)gshift;
  return sums<T, kBackward>(g, x, f, m, c, (cudaStream_t)stream);
}

}  // namespace

// Rows of the per-channel blocks at the head of the workspaces (the
// wrapper's views read these).
extern "C" int s2r_bn_stat_rows() { return kStatRows; }
extern "C" int s2r_bn_grad_rows() { return kGradRows; }

// Slabs of pass 1 over a, b [m, c] of `itemsize` bytes an element: a
// workspace holds (rows + 2 * slabs) * c floats.
extern "C" int64_t s2r_bn_slabs(const void* a, const void* b, int64_t m, int64_t c,
                                int64_t itemsize) {
  return itemsize == 2 ? plan<__nv_bfloat16>(a, b, m, c).slabs : plan<float>(a, b, m, c).slabs;
}

// All [m, c] matrices are channels-last and contiguous; per-channel vectors
// are float32 [c].  count is the number of positions the statistics
// average over (the zero-padding ring included).
//   s2r_bn_stats_*: ws rows kSumX..kShift; running_mean and running_var
//     updated in place unless both are null.  One launch (two for many
//     slabs).
//   s2r_bn_apply_*: y = x * inv + shift.  One launch.
//   s2r_bn_grad_sums_*: ws rows kSumG..kCoefC0 from the statistics
//     workspace `st` and the cotangent of shift (null: zero).  As many
//     launches as the statistics.
//   s2r_bn_dx_*: dx = g * inv + x * b + c0.  One launch.
#define S2R_BN_ENTRIES(SUFFIX, T)                                                            \
  extern "C" int s2r_bn_stats_##SUFFIX(const void* x, const void* weight, const void* bias,    \
                                       void* running_mean, void* running_var, void* ws,       \
                                       int64_t m, int64_t c, double count, double eps,        \
                                       double momentum, void* stream) {                       \
    return stats<T>(x, weight, bias, running_mean, running_var, ws, m, c, count, eps,         \
                    momentum, stream);                                                        \
  }                                                                                           \
  extern "C" int s2r_bn_apply_##SUFFIX(const void* x, const void* inv, const void* shift,      \
                                       void* y, int64_t m, int64_t c, void* stream) {         \
    return elementwise<T, false>(nullptr, x, (const float*)inv, nullptr, (const float*)shift, \
                                 y, m, c, (cudaStream_t)stream);                              \
  }                                                                                           \
  extern "C" int s2r_bn_grad_sums_##SUFFIX(const void* g, const void* x, const void* st,       \
                                           const void* gshift, void* ws, int64_t m,           \
                                           int64_t c, double count, void* stream) {           \
    return grad_sums<T>(g, x, st, gshift, ws, m, c, count, stream);                           \
  }                                                                                           \
  extern "C" int s2r_bn_dx_##SUFFIX(const void* g, const void* x, const void* inv,             \
                                    const void* b, const void* c0, void* dx, int64_t m,       \
                                    int64_t c, void* stream) {                                \
    return elementwise<T, true>(g, x, (const float*)inv, (const float*)b, (const float*)c0,   \
                                dx, m, c, (cudaStream_t)stream);                              \
  }
S2R_BN_ENTRIES(f32, float)
S2R_BN_ENTRIES(bf16, __nv_bfloat16)
