// The output-space discriminator's first conv: 4x4, stride 2, padding 1,
// plus bias, reading the softmax map in its W-minor layout.
//
// Replaces the TPU kernel s2r_tpu/ops/pallas/disc_conv.py::disc_conv1
// (_d1_forward, with pack_kernel's [ndf, 16C+1] operand).  x is the logical
// [N, H, C, W] view of the NCHW softmax map, taken through its strides (no
// relayout, as on the TPU); bias [ndf] in x's type; y = conv(x) + bias,
// accumulated in float32, written NHWC [N, H/2, W/2, ndf] in x's type, which
// is the channels-last memory the next conv (cuDNN) reads without a copy.
// Index arithmetic on memory is 64-bit: one launch takes any batch.
//
// What bounds it on an H100: device-memory bytes.  At the train step's
// shape (8 x 19 x 512 x 1024 -> 8 x 64 x 256 x 512) it is 40.8 GFLOP
// against ~0.29 GB of compulsory traffic in bf16: 0.088 ms at 3.35 TB/s,
// 0.041 ms at the bf16 tensor-core peak.
//
// bfloat16: an implicit GEMM on the tensor cores (disc_conv1_tc).  M =
// output pixels, N = ndf = 64, K = 16*C ordered (kh, ci, kw), k = (kh*C +
// ci)*4 + kw, so K = 16*C is C k-steps of 16 with no padding; the wrapper
// packs the HWIO kernel into that [16C, 64] operand (ops/kernels/
// disc_conv.py pack_kernel).  mma.sync m16n8k16, bf16 in, float32
// accumulate.  A persistent block (two a SM) stages the packed weights once,
// in the B-fragment order of the mma (one 16-byte shared load feeds two
// n-tiles), then walks tiles of 2 output rows x 128 output columns: it
// stages the 6 input rows x C channels x 258 columns they read into shared
// memory, one column to the right, so that the two kw taps an A register
// holds, (0,1) or (2,3), are one aligned 32-bit load at staged columns 2*ow
// and 2*ow + 2 -- the stride-2 gather needs no shuffles.  The shift is made
// on the way in: 16-byte loads of x along W (its contiguous axis), realigned
// by one element in registers.  A staged row is 144 words (16 mod 32
// banks), so the two channel rows one A load touches fall on disjoint
// banks.  Each of 8 warps owns 32 pixels x 64 channels (64 float32
// accumulators a thread); the epilogue adds the bias and writes each
// pixel's 128 contiguous bytes of NHWC output through shared memory, so the
// stores are 16-byte and coalesced.  Loads and products overlap across the
// two blocks on a SM, not inside one (a cp.async pipeline is later work).
// A stride or width off the 16-byte grid stages element by element.
//
// float32: the CUDA-core loop (disc_conv1_kernel).  TF32 tensor cores keep
// ~3 decimal digits and would miss the 1e-5 float32 checks (the card
// against the CPU, chip_smoke.py phases 2e and 4a); float32 runs only in
// those checks.  The 16*C*ndf weights and the bias sit in shared memory as
// float32; a block of 32 x ndf/8 threads covers 128 output columns of R
// output rows; each thread keeps 4 pixels x 8 output channels in registers.
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

// ---------------------------------------------------------------------
// bfloat16 on the tensor cores.

constexpr int kTcRows = 2;                  // output rows a tile
constexpr int kTcCols = 128;                // output columns a tile
constexpr int kTcThreads = 256;             // 8 warps: 2 rows x 4 x 32 pixels
constexpr int kTcNdf = 64;                  // output channels (8 n-tiles)
constexpr int kInRows = 2 * kTcRows + 2;    // input rows a tile reads
constexpr int kInCols = 2 * kTcCols + 2;    // input columns a tile reads
constexpr int kGroups = (kInCols + 7) / 8;  // 16-byte groups a staged row
constexpr int kRowStride = 288;             // bf16 a staged row: 144 words
constexpr int kOutStride = kTcNdf + 8;      // bf16 a staged output pixel
constexpr int kOutStage = kTcRows * kTcCols * kOutStride * 2;  // bytes

static_assert(kRowStride >= 8 * kGroups && kRowStride % 64 == 32,
              "staged rows hold every group and sit 16 banks apart");

__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) {
  return (uint32_t)__bfloat16_as_ushort(v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory: the packed weights in fragment order, c*512 words:
// word ((s*4 + ntp)*32 + lane)*4 + j holds rows k, k+1 of column n of the
// [16C, 64] operand, k = 16s + 2(lane%4) + 8(j%2), n = (2ntp + j/2)*8 +
// lane/4; then the staged input tile [kInRows*c][kRowStride] bf16, whose
// column s holds input column 2*ow0 - 1 + s, reused as the output stage
// [kTcRows*kTcCols][kOutStride] once the products are done.
__global__ void __launch_bounds__(kTcThreads, 2)
    disc_conv1_tc(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ kp,
                  const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                  int n, int h, int c, int w, int64_t sn, int64_t sh, int64_t sc, int64_t sw,
                  int oh, int ow, bool vec) {
  extern __shared__ uint4 smem_tc[];
  uint32_t* wf = reinterpret_cast<uint32_t*>(smem_tc);
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(wf + c * 512);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  for (int i = tid; i < c * 512; i += kTcThreads) {
    const int j = i & 3, ln = (i >> 2) & 31, ntp = (i >> 7) & 3, s = i >> 9;
    const int k = 16 * s + 2 * (ln & 3) + 8 * (j & 1);
    const int col = (2 * ntp + (j >> 1)) * 8 + (ln >> 2);
    wf[i] = bits(kp[k * kTcNdf + col]) | (bits(kp[(k + 1) * kTcNdf + col]) << 16);
  }
  float bv[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    bv[nt][0] = __bfloat162float(bias[nt * 8 + 2 * t]);
    bv[nt][1] = __bfloat162float(bias[nt * 8 + 2 * t + 1]);
  }

  const int strips = (ow + kTcCols - 1) / kTcCols;
  const int pairs = (oh + kTcRows - 1) / kTcRows;
  const int64_t tiles = (int64_t)n * pairs * strips;
  const int orow_l = warp >> 2;       // the warp's output row in the tile
  const int pix0 = (warp & 3) * 32;   // its first pixel: two m16 tiles
  const int rc_rows = kInRows * c;

  for (int64_t ti = blockIdx.x; ti < tiles; ti += gridDim.x) {
    const int strip = (int)(ti % strips);
    const int64_t rest = ti / strips;
    const int o0 = (int)(rest % pairs) * kTcRows;
    const int64_t nn = rest / pairs;
    const int ow0 = strip * kTcCols;
    const int ih0 = 2 * o0 - 1;
    const __nv_bfloat16* xn = x + nn * sn;
    __syncthreads();  // the previous tile's output stage has been read
    if (vec) {
      // Staged columns 8q..8q+7 hold input columns cb-1..cb+6, cb = 2*ow0
      // + 8q: the last element before the group, then 7 of the group's 8.
      for (int i = tid; i < rc_rows * kGroups; i += kTcThreads) {
        const int q = i % kGroups, rc = i / kGroups;
        const int ih = ih0 + rc / c, ci = rc % c;
        uint4 out = make_uint4(0, 0, 0, 0);
        if (ih >= 0 && ih < h) {
          const __nv_bfloat16* xr = xn + ih * sh + ci * sc;
          const int cb = 2 * ow0 + 8 * q;
          const uint32_t prev = (cb >= 1 && cb - 1 < w) ? bits(xr[cb - 1]) : 0u;
          uint4 raw = make_uint4(0, 0, 0, 0);
          if (cb < w) raw = *reinterpret_cast<const uint4*>(xr + cb);
          out.x = prev | (raw.x << 16);
          out.y = (raw.x >> 16) | (raw.y << 16);
          out.z = (raw.y >> 16) | (raw.z << 16);
          out.w = (raw.z >> 16) | (raw.w << 16);
        }
        *reinterpret_cast<uint4*>(tile + rc * kRowStride + 8 * q) = out;
      }
    } else {
      for (int i = tid; i < rc_rows * kInCols; i += kTcThreads) {
        const int sc_ = i % kInCols, rc = i / kInCols;
        const int ih = ih0 + rc / c, ci = rc % c, iw = 2 * ow0 - 1 + sc_;
        __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
        if (ih >= 0 && ih < h && iw >= 0 && iw < w) v = xn[ih * sh + ci * sc + iw * sw];
        tile[rc * kRowStride + sc_] = v;
      }
    }
    __syncthreads();

    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    // Row p of the step's four (kh, ci) pairs is staged row 2*orow_l*c + p;
    // the thread's kw pair starts at staged column 2*pixel + 2*(t&1).
    const __nv_bfloat16* arow =
        tile + (2 * orow_l * c + (t >> 1)) * kRowStride + 2 * (pix0 + g) + 2 * (t & 1);
    const uint4* brow = reinterpret_cast<const uint4*>(wf) + lane;
    for (int s = 0; s < c; ++s) {
      const __nv_bfloat16* lo = arow + 4 * s * kRowStride;
      const __nv_bfloat16* hi = lo + 2 * kRowStride;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a[mt][0] = *reinterpret_cast<const uint32_t*>(lo + 32 * mt);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(lo + 32 * mt + 16);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(hi + 32 * mt);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(hi + 32 * mt + 16);
      }
#pragma unroll
      for (int ntp = 0; ntp < 4; ++ntp) {
        const uint4 b = brow[(s * 4 + ntp) * 32];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * ntp], a[mt], b.x, b.y);
          mma_bf16(acc[mt][2 * ntp + 1], a[mt], b.z, b.w);
        }
      }
    }
    __syncthreads();  // every warp is done with the input tile

    __nv_bfloat16* ost = tile;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int px = orow_l * kTcCols + pix0 + 16 * mt + g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int ch = nt * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(ost + px * kOutStride + ch) =
            __floats2bfloat162_rn(acc[mt][nt][0] + bv[nt][0], acc[mt][nt][1] + bv[nt][1]);
        *reinterpret_cast<__nv_bfloat162*>(ost + (px + 8) * kOutStride + ch) =
            __floats2bfloat162_rn(acc[mt][nt][2] + bv[nt][0], acc[mt][nt][3] + bv[nt][1]);
      }
    }
    __syncthreads();
    for (int i = tid; i < kTcRows * kTcCols * (kTcNdf / 8); i += kTcThreads) {
      const int q = i & 7, px = i >> 3;
      const int orow = o0 + px / kTcCols, ocol = ow0 + px % kTcCols;
      if (orow < oh && ocol < ow)
        *reinterpret_cast<uint4*>(y + ((nn * oh + orow) * ow + ocol) * kTcNdf + q * 8) =
            *reinterpret_cast<const uint4*>(ost + px * kOutStride + q * 8);
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

size_t tc_smem_bytes(int64_t c) {
  const size_t tile = (size_t)kInRows * c * kRowStride * 2;
  return (size_t)c * 512 * 4 + (tile > (size_t)kOutStage ? tile : (size_t)kOutStage);
}

int launch_tc(const void* x, const void* kp, const void* bias, void* y, int64_t n, int64_t h,
              int64_t c, int64_t w, int64_t sn, int64_t sh, int64_t sc, int64_t sw,
              void* stream) {
  const int oh = (int)(h / 2), ow = (int)(w / 2);
  const size_t smem = tc_smem_bytes(c);
  cudaError_t err = cudaFuncSetAttribute(
      disc_conv1_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, disc_conv1_tc, kTcThreads,
                                                           smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) per_sm = 1;
  const int64_t tiles =
      n * ((oh + kTcRows - 1) / kTcRows) * (int64_t)((ow + kTcCols - 1) / kTcCols);
  const int64_t grid = tiles < (int64_t)sms * per_sm ? tiles : (int64_t)sms * per_sm;
  const bool vec = sw == 1 && w % 8 == 0 && sn % 8 == 0 && sh % 8 == 0 && sc % 8 == 0 &&
                   aligned16(x);
  disc_conv1_tc<<<(unsigned)grid, kTcThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)kp, (const __nv_bfloat16*)bias,
      (__nv_bfloat16*)y, (int)n, (int)h, (int)c, (int)w, sn, sh, sc, sw, oh, ow, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// float32 on the CUDA cores.

int launch_f32(const void* x, const void* k, const void* bias, void* y, int64_t n, int64_t h,
               int64_t c, int64_t w, int64_t sn, int64_t sh, int64_t sc, int64_t sw,
               int64_t ndf, void* stream) {
  const int oh = (int)(h / 2), ow = (int)(w / 2);
  const size_t smem = (size_t)(16 * c * ndf + ndf) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      disc_conv1_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int gx = (ow + kCols - 1) / kCols;
  const int64_t rows = n * oh;
  int64_t per = (rows * gx + kTargetBlocks - 1) / kTargetBlocks;
  if (per < 1) per = 1;
  const int64_t gy = (rows + per - 1) / per;
  disc_conv1_kernel<float><<<dim3(gx, (unsigned)gy), dim3(32, (unsigned)(ndf / kOc)), smem,
                             (cudaStream_t)stream>>>(
      (const float*)x, (const float*)k, (const float*)bias, (float*)y, (int)n, (int)h, (int)c,
      (int)w, sn, sh, sc, sw, (int)ndf, oh, ow, (int)per);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the bfloat16 kernel asks for at C input channels (the
// wrapper checks it against the card's 227 KB a block).
extern "C" int64_t s2r_disc_conv1_bf16_smem(int64_t c) { return (int64_t)tc_smem_bytes(c); }

// x: [N,H,C,W] with element strides (sn, sh, sc, sw); kernel HWIO contiguous;
// bias [ndf]; y NHWC [N, H/2, W/2, ndf] contiguous, 16-byte aligned.
// ndf % 8 == 0, ndf <= 256, (16*C*ndf + ndf) * 4 bytes of shared memory
// <= 227 KB (the wrapper checks).
extern "C" int s2r_disc_conv1_f32(const void* x, const void* k, const void* bias, void* y,
                                  int64_t n, int64_t h, int64_t c, int64_t w, int64_t sn,
                                  int64_t sh, int64_t sc, int64_t sw, int64_t ndf,
                                  void* stream) {
  return launch_f32(x, k, bias, y, n, h, c, w, sn, sh, sc, sw, ndf, stream);
}

// As the float32 entry, but `kp` is the packed [16C, 64] operand, rows in
// (kh, ci, kw) order, and ndf must be 64 (the wrapper checks).
extern "C" int s2r_disc_conv1_bf16(const void* x, const void* kp, const void* bias, void* y,
                                   int64_t n, int64_t h, int64_t c, int64_t w, int64_t sn,
                                   int64_t sh, int64_t sc, int64_t sw, int64_t ndf,
                                   void* stream) {
  if (ndf != kTcNdf) return (int)cudaErrorInvalidValue;
  return launch_tc(x, kp, bias, y, n, h, c, w, sn, sh, sc, sw, stream);
}
