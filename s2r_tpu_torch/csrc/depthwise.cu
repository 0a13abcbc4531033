// 3x3 depthwise convolution, stride 1, zero padding = dilation, NHWC, and
// its kernel gradient.
//
// Replaces the TPU kernel s2r_tpu/ops/pallas/depthwise.py::depthwise_conv3x3
// (_dw_forward) and its VJP (_dw_bwd).  Forward: y[n,h,w,c] = sum_{dy,dx}
// x[n, h+(dy-1)d, w+(dx-1)d, c] * k[dy,dx,c], taps outside the image read as
// zero, the sum kept in float32 and written in x's type.  The VJP's dx is the
// same kernel on the cotangent with the taps flipped (the wrapper flips
// them).  dk[dy,dx,c] = sum_{n,h,w} x[n, h+(dy-1)d, w+(dx-1)d, c] * g[n,h,w,c]
// in float32 is the second kernel.
//
// What bounds both on an H100: device-memory bytes (9 multiply-adds an
// element pair against 2 * sizeof(T) bytes read or written).  Both are one
// design, a haloed tile sweep:
//
// - A block owns a channel chunk of nvb vectors of V channels (threadIdx.x),
//   a tile of tw output columns (threadIdx.y: thread column tc owns
//   columns tc, tc + tws, ... of the tile; one in the forward, two in
//   dk), a run of
//   rows and images n = blockIdx.y, blockIdx.y + gridDim.y, ...  Rows are
//   walked in classes of equal residue mod d: output row r needs input rows
//   r - d, r, r + d, all of its own class, so a class is a sequence with
//   unit steps whatever the dilation.
// - Input rows of the run, with their column halo, are staged into a ring
//   of ahead + 2 row slots in shared memory by cp.async copies of one
//   thread vector each (zero-filled where a tap leaves the image: the
//   conv's zero padding, as the Pallas kernel's zeroed halo strips),
//   `ahead` rows before they are used, so loads overlap arithmetic.  The
//   ring runs on from one of the block's images to the next, so the
//   pipeline fills once a block.  Each input row leaves device memory once
//   per (column tile, channel chunk, run); the overheads are the column
//   halo (tw + 2d) / tw and the two rows at each end of a run.  Staged
//   columns: [w0 - d, w0 + tw + d) when d <= tw, else the three tw-wide
//   segments at w0 - d, w0 and w0 + d, so a halo wider than the tile
//   costs no shared memory it does not use.  One __syncthreads a row.
// - Forward: a thread holds its vector's nine taps in registers, read once.
//   Each staged row is read from shared memory once (its three column taps)
//   and starts one output row (a product) and adds into the two above it,
//   each accumulator taking its taps in (dy, dx) order; the finished row is
//   written.  The row loop is unrolled by three so the three accumulators
//   rotate by renaming, with no moves.
// - dk: x and g rows are staged side by side (g without halo).  A thread
//   keeps the last three g rows of its columns in registers and adds each
//   staged x row's three column taps times them into its nine tap sums (its
//   columns share them: more work a row for the same registers).  The
//   block then sums its thread columns in order, every thread taking some
//   of the (vector, tap, element) outputs, into one [9][chunk] partial a
//   block.  The partials of a chunk are folded in slab order by the last
//   block of the chunk to arrive (an arrival counter) where that is short,
//   else by slab_fold.cuh's fold, one launch more.  No atomics on the sums:
//   a repeated call gives the same bits.
// - No integer division on the hot loop: coordinates come from blockIdx and
//   threadIdx, slots advance by compare.  Offsets are 64-bit, so dk takes
//   any batch in one launch; the wrapper still splits the forward's batch
//   below 2^31 elements a launch (ops/kernels/depthwise.py over_batch).
//
// Registers (ptxas, sm_90a; PERF.md): the forward's 16-byte bf16 instance
// holds 72 taps and 24 sums in 128 registers; dk is capped at 64 (4
// blocks of 256 threads, half the SM's threads) by __launch_bounds__.
//
// The launch plan (V, nvb, tw, rows a run, images a block, rows ahead, the
// fold) is worked out by the wrapper (ops/kernels/depthwise.py sweep_plan)
// and passed in, so it is tested on the CPU.  V is 16 bytes in the forward
// and 8 in dk (its sums fit 64 registers); a C that is not a multiple of
// the vector, or an unaligned pointer, takes V = 1, and two-byte pieces
// have no cp.async and are staged by plain loads.
//
// Built by plain nvcc into a shared library with a C interface and loaded
// with ctypes (s2r_tpu_torch/ops/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "slab_fold.cuh"

namespace {

constexpr int kMaxThreads = 256;     // a block: nvb * tws
constexpr int kMaxAhead = 6;         // rows staged ahead
constexpr int kMaxChunks = 1024;     // arrival counters
constexpr int kDkBlocksPerSM = 4;    // dk: >= 50% occupancy (<= 64 registers)
constexpr int kFoldAhead = 16;       // dk's last-block fold: loads in flight
constexpr int kDkCols = 2;           // dk: columns a thread (they share its sums)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int B> struct WordOf;
template <> struct WordOf<16> { using type = uint4; };
template <> struct WordOf<8> { using type = uint2; };
template <> struct WordOf<4> { using type = unsigned; };
template <> struct WordOf<2> { using type = unsigned short; };

// V consecutive elements as float32, one load.
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  using W = typename WordOf<V * sizeof(T)>::type;
  const W raw = *reinterpret_cast<const W*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f32(e[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&in)[V]) {
  using W = typename WordOf<V * sizeof(T)>::type;
  W raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = from_f32<T>(in[i]);
  *reinterpret_cast<W*>(p) = raw;
}

// Stage V elements from src into shared memory at dst, or zeros if !ok.
template <typename T, int V>
__device__ __forceinline__ void stage(T* dst, const T* src, bool ok) {
  constexpr int B = V * sizeof(T);
  if constexpr (B >= 4) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    const int n = ok ? B : 0;  // src-size 0: B zero bytes, nothing read
    if constexpr (B == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                   "r"(n)
                   : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
                   "n"(B), "r"(n)
                   : "memory");
  } else {
    *dst = ok ? *src : from_f32<T>(0.0f);  // no cp.async of two bytes
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most n copy groups are pending (n is an immediate in PTX).
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// One launch's shapes and plan (ops/kernels/depthwise.py SweepPlan).
struct Sweep {
  int64_t n;         // images
  int h, w, c, d;    // image rows, columns, channels; dilation
  int nvb, tws;      // block: nvb channel vectors x tws thread columns
  int tw;            // tile columns, tws * columns a thread: thread column
                     // tc owns tc, tc + tws, ...
  int rows, runs;    // output rows a run (of a class); runs a class
  int ahead;         // rows staged ahead; the ring has ahead + 2 slots
  int nchunks, ntiles;
  int span;          // staged columns a row: tw + 2 * min(d, tw)
};

// The block's place: chunk, tile, row class and run (one division each,
// once a block).
struct Place {
  int chunk, tile, cls, j0, j1;
};

__device__ __forceinline__ Place place(const Sweep& s) {
  Place p;
  const unsigned b = blockIdx.x;
  p.chunk = b % s.nchunks;
  const unsigned rest = b / s.nchunks;
  p.tile = rest % s.ntiles;
  const int yb = rest / s.ntiles;
  p.cls = yb / s.runs;
  const int run = yb - p.cls * s.runs;
  const int nseq = (s.h - p.cls + s.d - 1) / s.d;  // rows of this class
  p.j0 = run * s.rows;
  p.j1 = min(p.j0 + s.rows, nseq);
  return p;
}

// Stage input row r of image xn into a slot (already offset by the
// thread's channel vector): staged columns tc, tc + tws, ... of [w0 - d,
// w0 + tw + d) when d <= tw, else of each of the three tw-wide segments at
// w0 - d, w0 and w0 + d.
template <typename T, int V>
__device__ __forceinline__ void stage_row(T* slot, const T* xn, const T* any, const Sweep& s,
                                          int r, int w0, int tc, int ch, bool ch_ok, int cb) {
  const bool r_ok = ch_ok && r >= 0 && r < s.h;
  const T* src_row = xn + ((int64_t)(r_ok ? r : 0) * s.w) * s.c + ch;
  if (s.d <= s.tw) {
    for (int sc = tc; sc < s.span; sc += s.tws) {
      const int gc = w0 - s.d + sc;
      const bool ok = r_ok && gc >= 0 && gc < s.w;
      stage<T, V>(slot + sc * cb, ok ? src_row + (int64_t)gc * s.c : any, ok);
    }
  } else {
#pragma unroll
    for (int seg = 0; seg < 3; ++seg)
      for (int off = tc; off < s.tw; off += s.tws) {
        const int gc = w0 + (seg - 1) * s.d + off;
        const bool ok = r_ok && gc >= 0 && gc < s.w;
        stage<T, V>(slot + (seg * s.tw + off) * cb, ok ? src_row + (int64_t)gc * s.c : any, ok);
      }
  }
}

// The stream of rows a block stages: for each of its images n = blockIdx.y,
// blockIdx.y + gridDim.y, ..., staged rows 0 .. len - 1 (input row j0 + t
// - 1 of the class, and for dk g row j0 + t while t < len - 2).  The ring
// runs on across images, so a block that takes several images pays the
// pipeline's fill once.
struct Stream {
  int64_t n;  // image of the next row to stage (>= s.n: none left)
  int t;      // its staged row
  __device__ __forceinline__ void advance(int len, int64_t stride) {
    if (++t == len) {
      t = 0;
      n += stride;
    }
  }
};

// Forward sweep.  blockDim (nvb, tw); grid (nchunks * ntiles * classes *
// runs, images a stride).
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    dw3x3_sweep(const T* __restrict__ x, const T* __restrict__ k, T* __restrict__ y,
                const Sweep s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const Place p = place(s);
  if (p.j0 >= p.j1) return;  // an empty run of a short class: the whole block
  const int v = threadIdx.x, tc = threadIdx.y;
  const int cb = s.nvb * V;
  const int ch = p.chunk * cb + v * V;
  const bool ch_ok = ch < s.c;
  const int w0 = p.tile * s.tw, col = w0 + tc;
  const bool out_ok = ch_ok && col < s.w;
  const int reach = min(s.d, s.tw) * cb;  // staged elements between taps
  const int slot_elems = s.span * cb;
  const int slots = s.ahead + 2;
  const int len = p.j1 - p.j0 + 2;  // staged rows: the run and one each side
  const int64_t image = (int64_t)s.h * s.w * s.c;

  float kf[3][3][V];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    if (ch_ok) {
      load<T, V>(k + t * s.c + ch, kf[t / 3][t % 3]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) kf[t / 3][t % 3][i] = 0.0f;
    }
  }

  Stream next{(int64_t)blockIdx.y, 0};
  int ws = 0, rs = 0;
  auto stage_next = [&]() {
    if (next.n < s.n) {
      stage_row<T, V>(ring + ws * slot_elems + v * V, x + next.n * image, x, s,
                      p.cls + (p.j0 + next.t - 1) * s.d, w0, tc, ch, ch_ok, cb);
      next.advance(len, gridDim.y);
    }
    ws = ws + 1 == slots ? 0 : ws + 1;
    commit();
  };
  for (int i = 0; i < s.ahead; ++i) stage_next();

  for (int64_t n = blockIdx.y; n < s.n; n += gridDim.y) {
    T* yn = y + n * image;
    // Staged row t starts output row t (an, its first product) and adds
    // into rows t - 1 (am) and t - 2 (ao, then written).  The loop is
    // unrolled by three so the accumulators rotate by renaming.
    auto step = [&](int t, float (&an)[V], float (&am)[V], float (&ao)[V]) {
      stage_next();
      wait_pending(s.ahead);  // row t has landed, for this thread's copies
      __syncthreads();        // ... and everyone's; slot t + ahead was free
      const T* row = ring + rs * slot_elems + tc * cb + v * V;
      rs = rs + 1 == slots ? 0 : rs + 1;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float xv[V];
        load<T, V>(row + dx * reach, xv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          ao[i] = fmaf(xv[i], kf[2][dx][i], ao[i]);
          am[i] = fmaf(xv[i], kf[1][dx][i], am[i]);
          // 0 + x * k is x * k: the sum's order is unchanged
          an[i] = dx == 0 ? xv[i] * kf[0][0][i] : fmaf(xv[i], kf[0][dx][i], an[i]);
        }
      }
      if (t >= 2 && out_ok) {
        const int r = p.cls + (p.j0 + t - 2) * s.d;
        store<T, V>(yn + ((int64_t)r * s.w + col) * s.c + ch, ao);
      }
    };
    float a0[V], a1[V], a2[V];  // rows t - 1, t - 2 start at zero
#pragma unroll
    for (int i = 0; i < V; ++i) a0[i] = a1[i] = a2[i] = 0.0f;
    for (int t = 0; t < len; t += 3) {
      step(t, a0, a1, a2);
      if (t + 1 < len) step(t + 1, a2, a0, a1);
      if (t + 2 < len) step(t + 2, a1, a2, a0);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One arrival counter per channel chunk, shared by every call of this
// library: the last block of a chunk resets its counter to 0, so each call
// finds them at 0.  Calls run one at a time (on one stream), as the port's
// do.
__device__ unsigned g_dk_arrivals[kMaxChunks];

// dk sweep: the forward's walk over x (haloed) and g (not), nine tap sums
// a thread over its columns, images and rows; the block's thread columns
// summed in order into partials [slab][9][C], slab = blockIdx.y * (blocks
// a chunk over images) + the block's (run, tile); then, if `fused`, the
// last block of the chunk folds its slabs in order into dk [9][C].
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads, kDkBlocksPerSM)
    dw3x3_dk_sweep(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part,
                   float* __restrict__ dk, const Sweep s, int fused) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ bool last;
  const Place p = place(s);
  const int v = threadIdx.x, tc = threadIdx.y;
  const int cb = s.nvb * V;
  const int ch = p.chunk * cb + v * V;
  const bool ch_ok = ch < s.c;
  const int w0 = p.tile * s.tw;
  const int reach = min(s.d, s.tw) * cb;
  const int slot_elems = (s.span + s.tw) * cb;  // x row, then g row
  const int slots = s.ahead + 2;
  const int nrun = p.j1 > p.j0 ? p.j1 - p.j0 : 0;
  const int len = nrun + 2;
  const int64_t image = (int64_t)s.h * s.w * s.c;
  T* ring = reinterpret_cast<T*>(smem_raw);

  float acc[3][3][V];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[t / 3][t % 3][i] = 0.0f;

  if (nrun > 0) {
    Stream next{(int64_t)blockIdx.y, 0};
    int ws = 0, rs = 0;
    auto stage_next = [&]() {
      if (next.n < s.n) {
        T* dst = ring + ws * slot_elems + v * V;
        stage_row<T, V>(dst, x + next.n * image, x, s, p.cls + (p.j0 + next.t - 1) * s.d, w0,
                        tc, ch, ch_ok, cb);
        if (next.t < nrun) {
          const int r = p.cls + (p.j0 + next.t) * s.d;
          const T* src = g + next.n * image + ((int64_t)r * s.w + w0) * s.c + ch;
#pragma unroll
          for (int j = 0; j < kDkCols; ++j) {
            const int cj = tc + j * s.tws;
            const bool ok = ch_ok && w0 + cj < s.w;
            stage<T, V>(dst + (s.span + cj) * cb, ok ? src + cj * s.c : g, ok);
          }
        }
        next.advance(len, gridDim.y);
      }
      ws = ws + 1 == slots ? 0 : ws + 1;
      commit();
    };
    for (int i = 0; i < s.ahead; ++i) stage_next();

    for (int64_t n = blockIdx.y; n < s.n; n += gridDim.y) {
      // Staged x row t pairs with g rows t (gn, loaded here), t - 1 (g1) and
      // t - 2 (g2) as taps dy = 0, 1, 2; g rows off the run are zero.  The
      // loop is unrolled by three so the window rotates by renaming.
      auto step = [&](int t, float (&gn)[kDkCols][V], float (&g1)[kDkCols][V],
                      float (&g2)[kDkCols][V]) {
        stage_next();
        wait_pending(s.ahead);
        __syncthreads();
        const T* row = ring + rs * slot_elems + tc * cb + v * V;
        rs = rs + 1 == slots ? 0 : rs + 1;
#pragma unroll
        for (int j = 0; j < kDkCols; ++j) {
          const T* rj = row + j * s.tws * cb;
          if (t < nrun) {
            load<T, V>(rj + s.span * cb, gn[j]);
          } else {
#pragma unroll
            for (int i = 0; i < V; ++i) gn[j][i] = 0.0f;
          }
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            float xv[V];
            load<T, V>(rj + dx * reach, xv);
#pragma unroll
            for (int i = 0; i < V; ++i) {
              acc[0][dx][i] = fmaf(xv[i], gn[j][i], acc[0][dx][i]);
              acc[1][dx][i] = fmaf(xv[i], g1[j][i], acc[1][dx][i]);
              acc[2][dx][i] = fmaf(xv[i], g2[j][i], acc[2][dx][i]);
            }
          }
        }
      };
      float ga[kDkCols][V], gb[kDkCols][V], gc[kDkCols][V];
#pragma unroll
      for (int j = 0; j < kDkCols; ++j)
#pragma unroll
        for (int i = 0; i < V; ++i) ga[j][i] = gb[j][i] = gc[j][i] = 0.0f;
      for (int t = 0; t < len; t += 3) {
        step(t, ga, gc, gb);
        if (t + 1 < len) step(t + 1, gb, ga, gc);
        if (t + 2 < len) step(t + 2, gc, gb, ga);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }

  // The block's thread columns: each thread's nine tap sums into shared
  // memory, then output (vector, tap, element) summed over the thread
  // columns in order, all threads sharing the outputs, straight into the
  // block's partial.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);
  constexpr int kRed = 9 * V + 1;  // a thread's stride: no bank conflicts
  const int nthreads = s.nvb * s.tws, tid = tc * s.nvb + v;
  float* mine = red + tid * kRed;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int i = 0; i < V; ++i) mine[t * V + i] = acc[t / 3][t % 3][i];
  __syncthreads();
  const int64_t per_image = (int64_t)gridDim.x / s.nchunks;  // tiles x runs
  const int64_t slab = blockIdx.y * per_image + blockIdx.x / s.nchunks;
  for (int o = tid; o < s.nvb * 9 * V; o += nthreads) {
    const int ov = o / (9 * V), q = o - ov * (9 * V);  // vector, tap * V + element
    const int c = p.chunk * cb + ov * V + q % V;
    if (c >= s.c) continue;
    const float* src = red + ov * kRed + q;
    float sum = 0.0f;
    for (int j = 0; j < s.tws; ++j) sum += src[j * s.nvb * kRed];
    part[(slab * 9 + q / V) * s.c + c] = sum;
  }
  if (!fused) return;  // slab_fold folds the partials

  // Arrival: the partials are visible device-wide before the ticket.
  __threadfence();
  __syncthreads();
  const unsigned slabs = (unsigned)(gridDim.y * per_image);
  if (tid == 0) {
    const unsigned ticket = atomicAdd(&g_dk_arrivals[p.chunk], 1u);
    last = ticket == slabs - 1;
    if (last) g_dk_arrivals[p.chunk] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Output q = (tap, channel of the chunk): its slabs summed in order,
  // kFoldAhead slabs' loads in flight before their adds.
  const int64_t stride = (int64_t)9 * s.c;
  for (int q = tid; q < 9 * cb; q += nthreads) {
    const int t = q / cb, c = p.chunk * cb + (q - t * cb);
    if (c >= s.c) continue;
    const float* src = part + (int64_t)t * s.c + c;
    float sum = 0.0f;
    unsigned i = 0;
    for (; i + kFoldAhead <= slabs; i += kFoldAhead) {
      float vals[kFoldAhead];
#pragma unroll
      for (int u = 0; u < kFoldAhead; ++u) vals[u] = src[(int64_t)(i + u) * stride];
#pragma unroll
      for (int u = 0; u < kFoldAhead; ++u) sum += vals[u];
    }
    for (; i < slabs; ++i) sum += src[(int64_t)i * stride];
    dk[t * s.c + c] = sum;
  }
}

// plan[]: the wrapper's SweepPlan fields, in this order.
enum PlanField { kVec, kNvb, kTw, kRows, kRuns, kClasses, kImagesGrid, kAhead, kFused, kSmem,
                 kPlanFields };

bool aligned_to(const void* p, int bytes) { return ((uintptr_t)p & (bytes - 1)) == 0; }

// The Sweep of a plan for `cols` columns a thread, or false if the plan
// does not fit the shapes.
bool make_sweep(const int64_t* plan, int cols, int64_t n, int64_t h, int64_t w, int64_t c,
                int64_t d, Sweep& s, dim3& grid, dim3& block) {
  const int64_t vec = plan[kVec], nvb = plan[kNvb], tw = plan[kTw];
  if (vec < 1 || c % vec || nvb < 1 || tw < 1 || plan[kRows] < 1 ||
      plan[kRuns] < 1 || plan[kClasses] != (d < h ? d : h) || plan[kAhead] < 1 ||
      plan[kAhead] > kMaxAhead || plan[kImagesGrid] < 1 || plan[kImagesGrid] > 65535 ||
      h > INT32_MAX || w > INT32_MAX || c > INT32_MAX || d > INT32_MAX)
    return false;
  const int64_t tws = tw / cols;  // every thread's columns lie in the tile
  if (tw % cols || nvb * tws > kMaxThreads) return false;
  s.n = n;
  s.h = (int)h, s.w = (int)w, s.c = (int)c, s.d = (int)d;
  s.nvb = (int)nvb, s.tws = (int)tws, s.tw = (int)tw;
  s.rows = (int)plan[kRows], s.runs = (int)plan[kRuns], s.ahead = (int)plan[kAhead];
  s.nchunks = (int)((c / vec + nvb - 1) / nvb);
  s.ntiles = (int)((w + tw - 1) / tw);
  s.span = (int)(tw + 2 * (d < tw ? d : tw));
  const int64_t blocks = (int64_t)s.nchunks * s.ntiles * plan[kClasses] * s.runs;
  if (blocks > INT32_MAX || (int64_t)s.rows * s.runs * d < h) return false;
  grid = dim3((unsigned)blocks, (unsigned)plan[kImagesGrid]);
  block = dim3(s.nvb, s.tws);
  return true;
}

template <typename Kernel>
bool allow_smem(Kernel kernel, int64_t smem) {
  if (smem > 227 * 1024) return false;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem) == cudaSuccess;
  return true;
}

template <typename T, int V>
int launch_fwd_v(const void* x, const void* k, void* y, const Sweep& s, dim3 grid, dim3 block,
                 int64_t smem, cudaStream_t stream) {
  if (!allow_smem(dw3x3_sweep<T, V>, smem)) return (int)cudaErrorInvalidValue;
  dw3x3_sweep<T, V><<<grid, block, (size_t)smem, stream>>>((const T*)x, (const T*)k, (T*)y, s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* x, const void* k, void* y, int64_t n, int64_t h, int64_t w,
               int64_t c, int64_t d, const int64_t* plan, void* stream) {
  Sweep s;
  dim3 grid, block;
  if (!make_sweep(plan, 1, n, h, w, c, d, s, grid, block)) return (int)cudaErrorInvalidValue;
  const int bytes = (int)(plan[kVec] * sizeof(T));
  if (!aligned_to(x, bytes) || !aligned_to(k, bytes) || !aligned_to(y, bytes))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t smem = plan[kSmem];
  switch (bytes) {
    case 16: return launch_fwd_v<T, 16 / sizeof(T)>(x, k, y, s, grid, block, smem, st);
    default:
      if (plan[kVec] == 1) return launch_fwd_v<T, 1>(x, k, y, s, grid, block, smem, st);
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int V>
int launch_dk_v(const void* x, const void* g, float* part, float* dk, const Sweep& s,
                dim3 grid, dim3 block, int64_t smem, bool fused, cudaStream_t stream) {
  if (!allow_smem(dw3x3_dk_sweep<T, V>, smem)) return (int)cudaErrorInvalidValue;
  dw3x3_dk_sweep<T, V><<<grid, block, (size_t)smem, stream>>>((const T*)x, (const T*)g, part, dk,
                                                               s, fused ? 1 : 0);
  if (!fused) {
    const int64_t slabs = (int64_t)grid.y * (grid.x / s.nchunks);
    launch_slab_fold(part, dk, 9 * (int64_t)s.c, slabs, stream);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dk(const void* x, const void* g, void* part, void* dk, int64_t n, int64_t h,
              int64_t w, int64_t c, int64_t d, const int64_t* plan, void* stream) {
  Sweep s;
  dim3 grid, block;
  if (!make_sweep(plan, kDkCols, n, h, w, c, d, s, grid, block))
    return (int)cudaErrorInvalidValue;
  const bool fused = plan[kFused] != 0;
  if (fused && s.nchunks > kMaxChunks) return (int)cudaErrorInvalidValue;
  const int bytes = (int)(plan[kVec] * sizeof(T));
  if (!aligned_to(x, bytes) || !aligned_to(g, bytes)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  float *pp = (float*)part, *pk = (float*)dk;
  const int64_t smem = plan[kSmem];
  if (bytes == 8)
    return launch_dk_v<T, 8 / sizeof(T)>(x, g, pp, pk, s, grid, block, smem, fused, st);
  if (plan[kVec] == 1) return launch_dk_v<T, 1>(x, g, pp, pk, s, grid, block, smem, fused, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The number of plan fields the entries read.
extern "C" int s2r_dw3x3_plan_fields() { return kPlanFields; }

// x [N,H,W,C], k [3,3,C], y [N,H,W,C], one type; plan from the wrapper.
// N*H*W*C must be below 2^31 (the wrapper splits the batch).
extern "C" int s2r_dw3x3_f32(const void* x, const void* k, void* y, int64_t n, int64_t h,
                             int64_t w, int64_t c, int64_t d, const int64_t* plan,
                             void* stream) {
  return launch_fwd<float>(x, k, y, n, h, w, c, d, plan, stream);
}

extern "C" int s2r_dw3x3_bf16(const void* x, const void* k, void* y, int64_t n, int64_t h,
                              int64_t w, int64_t c, int64_t d, const int64_t* plan,
                              void* stream) {
  return launch_fwd<__nv_bfloat16>(x, k, y, n, h, w, c, d, plan, stream);
}

// x, g [N,H,W,C] of one type; dk [3,3,C] float32; part holds the plan's
// slabs * 9 * C floats.  Any batch.
extern "C" int s2r_dw3x3_dk_f32(const void* x, const void* g, void* part, void* dk, int64_t n,
                                int64_t h, int64_t w, int64_t c, int64_t d,
                                const int64_t* plan, void* stream) {
  return launch_dk<float>(x, g, part, dk, n, h, w, c, d, plan, stream);
}

extern "C" int s2r_dw3x3_dk_bf16(const void* x, const void* g, void* part, void* dk, int64_t n,
                                 int64_t h, int64_t w, int64_t c, int64_t d,
                                 const int64_t* plan, void* stream) {
  return launch_dk<__nv_bfloat16>(x, g, part, dk, n, h, w, c, d, plan, stream);
}
