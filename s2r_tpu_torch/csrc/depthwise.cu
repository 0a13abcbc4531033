// 3x3 depthwise convolution, stride 1, zero padding = dilation, NHWC.
//
// Replaces the TPU kernel s2r_tpu/ops/pallas/depthwise.py::depthwise_conv3x3
// (_dw_forward), forward only.  y[n,h,w,c] = sum_{dy,dx} x[n, h+(dy-1)d,
// w+(dx-1)d, c] * k[dy,dx,c], taps outside the image read as zero, the sum
// kept in float32 and written in x's type.
//
// What bounds it on an H100: device-memory bytes.  Each output costs 9
// multiply-adds against 2 * sizeof(T) bytes of compulsory traffic (read x
// once, write y once), ~2.25 flop/byte in f32 where the card balances at ~20
// on its CUDA cores.  Design: one thread per output pixel and 16-byte channel
// vector (8 bf16 or 4 f32), channel fastest, so a warp reads 512 contiguous
// bytes of one tap.  The nine taps of neighbouring pixels overlap and the
// re-reads are served by L1/L2, so device memory sees each input about
// once.  Index arithmetic is 32-bit (the wrapper keeps N*H*W*C below 2^31).
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

}  // namespace

// N*H*W*C must be below 2^31 (the wrapper checks).
extern "C" int s2r_dw3x3_f32(const void* x, const void* k, void* y, int64_t n, int64_t h,
                             int64_t w, int64_t c, int64_t d, void* stream) {
  return launch<float>(x, k, y, n, h, w, c, d, stream);
}

extern "C" int s2r_dw3x3_bf16(const void* x, const void* k, void* y, int64_t n, int64_t h,
                              int64_t w, int64_t c, int64_t d, void* stream) {
  return launch<__nv_bfloat16>(x, k, y, n, h, w, c, d, stream);
}
