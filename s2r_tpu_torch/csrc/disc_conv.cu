// The output-space discriminator's first conv: 4x4, stride 2, padding 1,
// plus bias, reading the softmax map in its W-minor layout.
//
// Replaces the TPU kernel s2r_tpu/ops/pallas/disc_conv.py::disc_conv1
// (_d1_forward, with pack_kernel's [ndf, 16C+1] operand).  x is the logical
// [N, H, C, W] view of the NCHW softmax map, taken through its strides (no
// relayout, as on the TPU); kernel HWIO [4, 4, C, ndf] and bias [ndf] in x's
// type; y = conv(x) + bias, accumulated in float32, written NHWC [N, H/2,
// W/2, ndf] in x's type, which is the channels-last memory the next conv
// (cuDNN) reads without a copy.
//
// What bounds it on an H100: operations.  At the train step's shape (8 x
// 19 x 512 x 1024 -> 8 x 64 x 256 x 512) it is 40.8 GFLOP against ~0.3 GB
// of compulsory traffic in bf16, so it is bound by the float32 FMA rate of
// the CUDA cores (67 TFLOP/s, >= 0.6 ms); the tensor cores are later work.
// Design: the 16*C*ndf weights and the bias sit in shared memory as float32
// (78 KB at C=19, ndf=64).  A block of 32 x ndf/8 threads covers 128 output
// columns of R output rows; each thread keeps 4 pixels (columns tx + 32i)
// x 8 output channels in registers, so every input value it loads feeds 8
// FMAs and every 2 16-byte weight loads (a broadcast across the warp, whose
// threads share their channels) feed 32.  A warp's 32 input loads of one
// tap are 32 stride-2 elements of one row: 128 contiguous bytes in bf16.
// Rows outside the image are skipped, columns outside it read as zero.
//
// Built by plain nvcc into a shared library with a C interface and loaded
// with ctypes (s2r_tpu_torch/ops/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPix = 4;        // output pixels per thread (columns tx + 32*i)
constexpr int kOc = 8;         // output channels per thread
constexpr int kCols = 32 * kPix;
constexpr int kTargetBlocks = 1056;  // 8 blocks' worth of rows per SM

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[kOc]) {
  if constexpr (sizeof(T) == 2) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < kOc; ++j) e[j] = from_f32<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// Shared memory: w[(kh*4 + kw)*c + ci][ndf] (HWIO flattened), then bias[ndf].
template <typename T>
__global__ void disc_conv1_kernel(const T* __restrict__ x, const T* __restrict__ k,
                                  const T* __restrict__ bias, T* __restrict__ y, int n,
                                  int h, int c, int w, int64_t sn, int64_t sh, int64_t sc,
                                  int64_t sw, int ndf, int oh, int ow, int rows_per_block) {
  extern __shared__ float4 smem4[];
  float* wsh = reinterpret_cast<float*>(smem4);
  const int kk = 16 * c;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < kk * ndf; i += nthreads) wsh[i] = to_f32(k[i]);
  for (int i = tid; i < ndf; i += nthreads) wsh[kk * ndf + i] = to_f32(bias[i]);
  __syncthreads();

  const int oc0 = threadIdx.y * kOc;
  const int col0 = blockIdx.x * kCols + threadIdx.x;
  float b[kOc];
#pragma unroll
  for (int j = 0; j < kOc; ++j) b[j] = wsh[kk * ndf + oc0 + j];
  bool live[kPix];
  int64_t xoff[kPix][4];  // column offsets of the four kw taps (-1: outside)
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int oc = col0 + 32 * i;
    live[i] = oc < ow;
#pragma unroll
    for (int kw = 0; kw < 4; ++kw) {
      const int iw = 2 * oc + kw - 1;
      xoff[i][kw] = (live[i] && iw >= 0 && iw < w) ? (int64_t)iw * sw : -1;
    }
  }

  const int rows = n * oh;
  for (int rr = 0; rr < rows_per_block; ++rr) {
    const int row = blockIdx.y * rows_per_block + rr;
    if (row >= rows) break;
    const int nn = row / oh, orow = row % oh;
    float acc[kPix][kOc];
#pragma unroll
    for (int i = 0; i < kPix; ++i)
#pragma unroll
      for (int j = 0; j < kOc; ++j) acc[i][j] = b[j];
    const T* xb = x + (int64_t)nn * sn;
    for (int kh = 0; kh < 4; ++kh) {
      const int ih = 2 * orow + kh - 1;
      if (ih < 0 || ih >= h) continue;
      const T* xr = xb + (int64_t)ih * sh;
      for (int ci = 0; ci < c; ++ci) {
        const T* xc = xr + (int64_t)ci * sc;
#pragma unroll
        for (int kw = 0; kw < 4; ++kw) {
          float xv[kPix];
#pragma unroll
          for (int i = 0; i < kPix; ++i)
            xv[i] = xoff[i][kw] >= 0 ? to_f32(xc[xoff[i][kw]]) : 0.0f;
          const float4* wr =
              reinterpret_cast<const float4*>(wsh + ((kh * 4 + kw) * c + ci) * ndf + oc0);
          const float4 w0 = wr[0], w1 = wr[1];
          const float wv[kOc] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int i = 0; i < kPix; ++i)
#pragma unroll
            for (int j = 0; j < kOc; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
        }
      }
    }
    T* yr = y + ((int64_t)row * ow) * ndf + oc0;
#pragma unroll
    for (int i = 0; i < kPix; ++i)
      if (live[i]) store8<T>(yr + (int64_t)(col0 + 32 * i) * ndf, acc[i]);
  }
}

template <typename T>
int launch(const void* x, const void* k, const void* bias, void* y, int64_t n, int64_t h,
           int64_t c, int64_t w, int64_t sn, int64_t sh, int64_t sc, int64_t sw,
           int64_t ndf, void* stream) {
  const int oh = (int)(h / 2), ow = (int)(w / 2);
  const size_t smem = (size_t)(16 * c * ndf + ndf) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      disc_conv1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int gx = (ow + kCols - 1) / kCols;
  const int64_t rows = n * oh;
  int64_t per = (rows * gx + kTargetBlocks - 1) / kTargetBlocks;
  if (per < 1) per = 1;
  const int64_t gy = (rows + per - 1) / per;
  disc_conv1_kernel<T><<<dim3(gx, (unsigned)gy), dim3(32, (unsigned)(ndf / kOc)), smem,
                         (cudaStream_t)stream>>>(
      (const T*)x, (const T*)k, (const T*)bias, (T*)y, (int)n, (int)h, (int)c, (int)w, sn,
      sh, sc, sw, (int)ndf, oh, ow, (int)per);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [N,H,C,W] with element strides (sn, sh, sc, sw); kernel HWIO contiguous;
// bias [ndf]; y NHWC [N, H/2, W/2, ndf] contiguous, 16-byte aligned.
// ndf % 8 == 0, ndf <= 256, (16*C*ndf + ndf) * 4 bytes of shared memory
// <= 227 KB, N*(H/2)*(W/2)*ndf below 2^31 (the wrapper checks).
extern "C" int s2r_disc_conv1_f32(const void* x, const void* k, const void* bias, void* y,
                                  int64_t n, int64_t h, int64_t c, int64_t w, int64_t sn,
                                  int64_t sh, int64_t sc, int64_t sw, int64_t ndf,
                                  void* stream) {
  return launch<float>(x, k, bias, y, n, h, c, w, sn, sh, sc, sw, ndf, stream);
}

extern "C" int s2r_disc_conv1_bf16(const void* x, const void* k, const void* bias, void* y,
                                   int64_t n, int64_t h, int64_t c, int64_t w, int64_t sn,
                                   int64_t sh, int64_t sc, int64_t sw, int64_t ndf,
                                   void* stream) {
  return launch<__nv_bfloat16>(x, k, bias, y, n, h, c, w, sn, sh, sc, sw, ndf, stream);
}
