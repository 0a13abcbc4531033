// Per-channel (sum a, sum a*b) over the rows of a channels-last [M, C]
// pair, float32 accumulation: the statistics (a = b = x) and the backward
// sums (a = g, b = x) of every train-mode BatchNorm.
//
// Replaces the TPU kernel s2r_tpu/ops/pallas/batchnorm.py::pair_sums.  That
// kernel carries its sums across a sequential grid in VMEM scratch; here
// blocks run in parallel and carry nothing: the two-pass reduction of
// slab_fold.cuh, pass 1 here over channel vectors of 16 bytes (8 bf16 or 4
// f32) writing [slab][2][C] partials (sums of a, then of a*b), pass 2 the
// shared fold into [2][C].  No atomics: the result is the same bit for bit
// from run to run.  When a and b are the same tensor (the forward
// statistics) the kernel reads it once.
//
// What bounds it on an H100: device-memory bytes.  It does 2 flops per
// element read (one when a is b), far below the ~20 flop/byte at which the
// CUDA cores would limit it; each input is read once, the partials are a
// few MB.  A warp reads 512 contiguous bytes (32 vectors of one row, or
// whole short rows when C is small).  A C that is not a multiple of the
// vector, or an unaligned pointer, takes the same kernel one channel at a
// time.  Index arithmetic is 64-bit on rows only.
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

// part: [slabs][2][c] float32 (sums of a, then sums of a*b).
template <typename T, int V, bool SAME>
__global__ void pair_sums_partial(const T* __restrict__ a, const T* __restrict__ b,
                                  float* __restrict__ part, int64_t m, int c,
                                  int64_t rows_per_slab) {
  __shared__ float sh[kSlabThreads * 2 * V];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nvec = c / V;
  const int vec = blockIdx.x * blockDim.x + tx;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_slab;
  const int64_t r1 = min(r0 + rows_per_slab, m);
  float sa[V], sab[V];
#pragma unroll
  for (int v = 0; v < V; ++v) sa[v] = sab[v] = 0.0f;
  if (vec < nvec) {
    const T* pa = a + (size_t)vec * V;
    const T* pb = b + (size_t)vec * V;
    for (int64_t r = r0 + ty; r < r1; r += blockDim.y) {
      float av[V];
      load<T, V>(pa + (size_t)r * c, av);
      if constexpr (SAME) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          sa[v] += av[v];
          sab[v] += av[v] * av[v];
        }
      } else {
        float bv[V];
        load<T, V>(pb + (size_t)r * c, bv);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          sa[v] += av[v];
          sab[v] += av[v] * bv[v];
        }
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
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// out: [2][c] float32, sums of a then sums of a*b.
template <typename T, int V, bool SAME>
int launch_v(const void* a, const void* b, float* part, float* out, int64_t m, int64_t c,
             cudaStream_t stream) {
  const SlabPlan p = slab_plan(m, (int)(c / V));
  pair_sums_partial<T, V, SAME>
      <<<dim3(p.chunks, (unsigned)p.slabs), dim3(p.bx, p.by), 0, stream>>>(
          (const T*)a, (const T*)b, part, m, (int)c, p.per_slab);
  launch_slab_fold(part, out, 2 * c, p.slabs, stream);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* a, const void* b, void* part, void* out, int64_t m, int64_t c,
           void* stream) {
  constexpr int V = 16 / sizeof(T);
  const bool same = a == b;
  const bool vec = c % V == 0 && aligned16(a) && aligned16(b);
  cudaStream_t s = (cudaStream_t)stream;
  float* p = (float*)part;
  float* o = (float*)out;
  if (vec)
    return same ? launch_v<T, V, true>(a, b, p, o, m, c, s)
                : launch_v<T, V, false>(a, b, p, o, m, c, s);
  return same ? launch_v<T, 1, true>(a, b, p, o, m, c, s)
              : launch_v<T, 1, false>(a, b, p, o, m, c, s);
}

}  // namespace

// The scratch `part` holds 2 * s2r_pair_sums_max_slabs() * C floats; `out`
// is [2][C] float32: the sums of a, then the sums of a*b.
extern "C" int s2r_pair_sums_max_slabs() { return kMaxSlabs; }

extern "C" int s2r_pair_sums_f32(const void* a, const void* b, void* part, void* out,
                                 int64_t m, int64_t c, void* stream) {
  return launch<float>(a, b, part, out, m, c, stream);
}

extern "C" int s2r_pair_sums_bf16(const void* a, const void* b, void* part, void* out,
                                  int64_t m, int64_t c, void* stream) {
  return launch<__nv_bfloat16>(a, b, part, out, m, c, stream);
}
