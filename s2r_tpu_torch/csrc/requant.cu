// Requantization of int32 conv accumulators to int8, per channel.
//
// Replaces the TPU kernel s2r_tpu/ops/pallas/requant.py::requant_s32_to_s8.
// y[i] = clamp(round_half_even(x[i] * m[c] + b[c]), 0, 127) as int8, with c
// the innermost index; the caller has already folded the next layer's
// activation scale into m and b, as the TPU kernel's wrapper does.
//
// Rounding: the multiply and the add are two separately rounded float32
// operations (__fmul_rn, __fadd_rn), which nvcc never contracts into an
// FMA, and rintf rounds half to even.  That is exactly the plain PyTorch
// chain x.float() * m + b -> torch.round -> clamp, so the two agree bit for
// bit, exact .5 ties included.
//
// What bounds it on an H100: device-memory bytes, 4 read + 1 written per
// element.  Design: one thread per 4 consecutive channels (a 16-byte load
// of x, one 4-byte store of y, m and b as float4 from L1), neighbouring
// threads on neighbouring elements, 32-bit index arithmetic (the wrapper
// keeps the size below 2^31).  A C that is not a multiple of 4, or an
// unaligned pointer, takes the same kernel one element at a time.
//
// Built by plain nvcc into a shared library with a C interface and loaded
// with ctypes (s2r_tpu_torch/ops/kernels/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int8_t requant1(int32_t x, float m, float b) {
  float z = rintf(__fadd_rn(__fmul_rn(__int2float_rn(x), m), b));
  return (int8_t)fminf(fmaxf(z, 0.0f), 127.0f);
}

template <int V>
__global__ void requant_kernel(const int32_t* __restrict__ x, const float* __restrict__ m,
                               const float* __restrict__ b, int8_t* __restrict__ y,
                               unsigned total, int c) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;  // V elements each
  if (i >= total) return;
  if constexpr (V == 1) {
    const int ch = (int)(i % c);
    y[i] = requant1(x[i], m[ch], b[ch]);
  } else {
    static_assert(V == 4, "4 channels per thread");
    const int ch = (int)(i % (c / 4)) * 4;
    const int4 xv = reinterpret_cast<const int4*>(x)[i];
    const float4 mv = *reinterpret_cast<const float4*>(m + ch);
    const float4 bv = *reinterpret_cast<const float4*>(b + ch);
    char4 out;
    out.x = requant1(xv.x, mv.x, bv.x);
    out.y = requant1(xv.y, mv.y, bv.y);
    out.z = requant1(xv.z, mv.z, bv.z);
    out.w = requant1(xv.w, mv.w, bv.w);
    reinterpret_cast<char4*>(y)[i] = out;
  }
}

bool aligned(const void* p, uintptr_t a) { return ((uintptr_t)p & (a - 1)) == 0; }

}  // namespace

// total = number of elements, below 2^31 (the wrapper checks).
extern "C" int s2r_requant_s32_s8(const void* x, const void* m, const void* b, void* y,
                                  int64_t total, int64_t c, void* stream) {
  const bool vec = c % 4 == 0 && aligned(x, 16) && aligned(m, 16) && aligned(b, 16) &&
                   aligned(y, 4);
  const unsigned items = (unsigned)(vec ? total / 4 : total);
  const int threads = 256;
  const unsigned blocks = (items + threads - 1) / threads;
  if (vec)
    requant_kernel<4><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, (const float*)m, (const float*)b, (int8_t*)y, items, (int)c);
  else
    requant_kernel<1><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, (const float*)m, (const float*)b, (int8_t*)y, items, (int)c);
  return (int)cudaGetLastError();
}
