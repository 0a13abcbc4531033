// 3x3 depthwise convolution, stride 1, zero padding = dilation, NHWC.
//
// Replaces the TPU kernel s2r_tpu/ops/pallas/depthwise.py::depthwise_conv3x3
// (_dw_forward) and its VJP (_dw_bwd).  Forward: y[n,h,w,c] = sum_{dy,dx}
// x[n, h+(dy-1)d, w+(dx-1)d, c] * k[dy,dx,c], taps outside the image read as
// zero, the sum kept in float32 and written in x's type.  The VJP's dx is the
// same kernel on the cotangent with the taps flipped (the wrapper flips
// them); its dk is the second kernel below, dw3x3_dk.
//
// What bounds it on an H100: device-memory bytes.  Each output costs 9
// multiply-adds against 2 * sizeof(T) bytes of compulsory traffic (read x
// once, write y once), ~2.25 flop/byte in f32 where the card balances at ~20
// on its CUDA cores.  Design: one thread per output pixel and 16-byte channel
// vector (8 bf16 or 4 f32), channel fastest, so a warp reads 512 contiguous
// bytes of one tap.  The nine taps of neighbouring pixels overlap and the
// re-reads are served by L1/L2, so device memory sees each input about
// once.  Index arithmetic is 32-bit: the wrapper launches the forward once
// per run of whole images of fewer than 2^31 elements (ops/kernels/
// depthwise.py over_batch).
// Unlike the TPU kernel (C % 128, W % 8) it takes any C, H, W and dilation:
// a C that is not a multiple of the vector, or an unaligned pointer, takes
// the same kernel one channel at a time.  Tiling the halo through shared
// memory with TMA is later work.
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

// V consecutive elements as float32: one 16-byte load when V > 1.
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

template <typename T, int V>
__global__ void dw3x3_kernel(const T* __restrict__ x, const T* __restrict__ k,
                             T* __restrict__ y, int h, int w, int c, int d,
                             unsigned total) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int nvec = c / V;
  const int ch = (int)(i % nvec) * V;
  const unsigned pix = i / nvec;  // over N*H*W
  const int col = (int)(pix % w);
  const int row = (int)(pix / w);  // over N*H
  const int r0 = row % h;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int off = (dy - 1) * d;
    if (r0 + off < 0 || r0 + off >= h) continue;
    const T* xr = x + (size_t)(row + off) * w * c + ch;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int cc = col + (dx - 1) * d;
      if (cc < 0 || cc >= w) continue;
      float xv[V], kv[V];
      load<T, V>(xr + (size_t)cc * c, xv);
      load<T, V>(k + (dy * 3 + dx) * c + ch, kv);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += xv[v] * kv[v];
    }
  }
  store<T, V>(y + (size_t)pix * c + ch, acc);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
int launch(const void* x, const void* k, void* y, int64_t n, int64_t h, int64_t w,
           int64_t c, int64_t d, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = c % V == 0 && aligned16(x) && aligned16(k) && aligned16(y);
  const unsigned total = (unsigned)(n * h * w * (vec ? c / V : c));
  const int threads = 256;
  const unsigned blocks = (total + threads - 1) / threads;
  if (vec)
    dw3x3_kernel<T, V><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)k, (T*)y, (int)h, (int)w, (int)c, (int)d, total);
  else
    dw3x3_kernel<T, 1><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)k, (T*)y, (int)h, (int)w, (int)c, (int)d, total);
  return (int)cudaGetLastError();
}

// dk[dy,dx,c] = sum_{n,h,w} x[n, h+(dy-1)d, w+(dx-1)d, c] * g[n,h,w,c]
// (zero outside the image), in float32.  The two-pass reduction of
// slab_fold.cuh, as the BatchNorm sums (batchnorm.cu): pass 1 here, block
// (channel chunk, pixel slab), each thread keeping the nine taps' sums of
// one channel vector over every by-th pixel of the slab, reading g once
// and the nine x taps through L1/L2; the block folds its rows tap by tap
// with a fixed tree in shared memory and writes [slab][9][C] partials.
// Pass 2 is the shared fold.  No atomics: deterministic.  Bound by
// device-memory bytes (x and g read once, 18 flops per element pair).
// Pixels are indexed in I: 32 bits while N*H*W fits them, 64 bits beyond
// (one launch takes any batch; memory offsets are 64-bit either way).
template <typename T, int V, typename I>
__global__ void dw3x3_dk_partial(const T* __restrict__ x, const T* __restrict__ g,
                                 float* __restrict__ part, int h, int w, int c, int d,
                                 I pixels, I pix_per_slab) {
  __shared__ float sh[kSlabThreads * V];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nvec = c / V;
  const int vec = blockIdx.x * blockDim.x + tx;
  const int ch = vec * V;
  const I p0 = (I)blockIdx.y * pix_per_slab;
  const I p1 = p0 + pix_per_slab < pixels ? p0 + pix_per_slab : pixels;
  float acc[9][V];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[t][v] = 0.0f;
  if (vec < nvec) {
    for (I p = p0 + ty; p < p1; p += blockDim.y) {
      const int col = (int)(p % (I)w);
      const I row = p / (I)w;  // over N*H
      const int r0 = (int)(row % (I)h);
      float gv[V];
      load<T, V>(g + (size_t)p * c + ch, gv);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int off = (dy - 1) * d;
        if (r0 + off < 0 || r0 + off >= h) continue;
        const T* xr = x + (size_t)(row + off) * w * c + ch;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int cc = col + (dx - 1) * d;
          if (cc < 0 || cc >= w) continue;
          float xv[V];
          load<T, V>(xr + (size_t)cc * c, xv);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[dy * 3 + dx][v] += xv[v] * gv[v];
        }
      }
    }
  }
  float* mine = sh + (ty * blockDim.x + tx) * V;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int v = 0; v < V; ++v) mine[v] = acc[t][v];
    __syncthreads();
    for (int s = blockDim.y / 2; s > 0; s >>= 1) {
      if (ty < s) {
        const float* other = sh + ((ty + s) * blockDim.x + tx) * V;
#pragma unroll
        for (int v = 0; v < V; ++v) mine[v] += other[v];
      }
      __syncthreads();
    }
    if (ty == 0 && vec < nvec) {
      float* out = part + ((size_t)blockIdx.y * 9 + t) * c + ch;
#pragma unroll
      for (int v = 0; v < V; ++v) out[v] = mine[v];
    }
    __syncthreads();
  }
}

template <typename T, int V>
int launch_dk_v(const void* x, const void* g, float* part, float* dk, int64_t n,
                int64_t h, int64_t w, int64_t c, int64_t d, cudaStream_t stream) {
  const int64_t pixels = n * h * w;
  const SlabPlan p = slab_plan(pixels, (int)(c / V));
  const dim3 grid(p.chunks, (unsigned)p.slabs), block(p.bx, p.by);
  if (pixels < ((int64_t)1 << 32))
    dw3x3_dk_partial<T, V, unsigned><<<grid, block, 0, stream>>>(
        (const T*)x, (const T*)g, part, (int)h, (int)w, (int)c, (int)d, (unsigned)pixels,
        (unsigned)p.per_slab);
  else
    dw3x3_dk_partial<T, V, uint64_t><<<grid, block, 0, stream>>>(
        (const T*)x, (const T*)g, part, (int)h, (int)w, (int)c, (int)d, (uint64_t)pixels,
        (uint64_t)p.per_slab);
  launch_slab_fold(part, dk, 9 * c, p.slabs, stream);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dk(const void* x, const void* g, void* part, void* dk, int64_t n, int64_t h,
              int64_t w, int64_t c, int64_t d, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = c % V == 0 && aligned16(x) && aligned16(g);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) return launch_dk_v<T, V>(x, g, (float*)part, (float*)dk, n, h, w, c, d, s);
  return launch_dk_v<T, 1>(x, g, (float*)part, (float*)dk, n, h, w, c, d, s);
}

}  // namespace

// The dk scratch `part` holds s2r_dw3x3_dk_max_slabs() * 9 * C floats.
extern "C" int s2r_dw3x3_dk_max_slabs() { return kMaxSlabs; }

// x, g [N,H,W,C] of one type; dk [3,3,C] float32.  Any size.
extern "C" int s2r_dw3x3_dk_f32(const void* x, const void* g, void* part, void* dk,
                                int64_t n, int64_t h, int64_t w, int64_t c, int64_t d,
                                void* stream) {
  return launch_dk<float>(x, g, part, dk, n, h, w, c, d, stream);
}

extern "C" int s2r_dw3x3_dk_bf16(const void* x, const void* g, void* part, void* dk,
                                 int64_t n, int64_t h, int64_t w, int64_t c, int64_t d,
                                 void* stream) {
  return launch_dk<__nv_bfloat16>(x, g, part, dk, n, h, w, c, d, stream);
}

// N*H*W*C must be below 2^31 (the wrapper splits the batch).
extern "C" int s2r_dw3x3_f32(const void* x, const void* k, void* y, int64_t n, int64_t h,
                             int64_t w, int64_t c, int64_t d, void* stream) {
  return launch<float>(x, k, y, n, h, w, c, d, stream);
}

extern "C" int s2r_dw3x3_bf16(const void* x, const void* k, void* y, int64_t n, int64_t h,
                              int64_t w, int64_t c, int64_t d, void* stream) {
  return launch<__nv_bfloat16>(x, k, y, n, h, w, c, d, stream);
}
