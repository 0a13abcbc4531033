// The deterministic two-pass reduction of depthwise.cu (dw3x3_dk), and the
// slab sizing that batchnorm.cu (bn_sums) shares with it.
//
// Pass 1 (in each source): block (chunk, slab) covers up to 32 channel
// vectors of a slab of rows, each thread summing every by-th row in float32
// and the block folding its rows with a fixed tree, and writes float32
// partials laid out [slab][k].  Pass 2 (here) folds the slabs into [k]: 32
// lanes of slabs per output, each summing its slabs in order, then a fixed
// tree over the lanes.  No atomics, so the result is the same bit for bit
// from run to run.  `plan` sizes pass 1: about kTargetBlocks blocks, but at
// least kMinRowsPerThread rows a thread, so small inputs get few slabs.
//
// Header only; each source that includes it gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlabThreads = 256;      // pass-1 threads a block
constexpr int kMaxSlabs = 1024;        // the wrappers size their scratch by this
constexpr int kTargetBlocks = 1024;
constexpr int kMinRowsPerThread = 16;  // fewer slabs for small inputs
constexpr int kFoldLanes = 32;

struct SlabPlan {
  int bx, by;         // pass-1 block: bx channel vectors x by rows
  int chunks;         // grid.x: channel chunks of bx vectors
  int64_t slabs;      // grid.y
  int64_t per_slab;   // rows a slab
};

// Pass-1 grid for `rows` rows of `nvec` channel vectors.
inline SlabPlan slab_plan(int64_t rows, int nvec) {
  SlabPlan p;
  p.bx = nvec < 32 ? nvec : 32;
  p.by = 1;
  while (2 * p.by * p.bx <= kSlabThreads) p.by *= 2;  // a power of two
  p.chunks = (nvec + p.bx - 1) / p.bx;
  int64_t slabs = kTargetBlocks / p.chunks;
  const int64_t by_rows = (rows + p.by * kMinRowsPerThread - 1) / (p.by * kMinRowsPerThread);
  if (slabs > by_rows) slabs = by_rows;
  if (slabs > kMaxSlabs) slabs = kMaxSlabs;
  if (slabs < 1) slabs = 1;
  p.per_slab = (rows + slabs - 1) / slabs;
  p.slabs = (rows + p.per_slab - 1) / p.per_slab;
  return p;
}

// Pass 2: part [slabs][k] -> out [k].  Block of 32 outputs x kFoldLanes
// lanes; lane l sums slabs l, l + kFoldLanes, ... in order.
__global__ void slab_fold(const float* __restrict__ part, float* __restrict__ out, int k,
                          int slabs) {
  __shared__ float sh[kFoldLanes][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * 32 + tx;
  float s = 0.0f;
  if (j < k)
    for (int i = ty; i < slabs; i += kFoldLanes) s += part[(size_t)i * k + j];
  sh[ty][tx] = s;
  __syncthreads();
  for (int step = kFoldLanes / 2; step > 0; step >>= 1) {
    if (ty < step) sh[ty][tx] += sh[ty + step][tx];
    __syncthreads();
  }
  if (ty == 0 && j < k) out[j] = sh[0][tx];
}

inline void launch_slab_fold(const float* part, float* out, int64_t k, int64_t slabs,
                             cudaStream_t stream) {
  slab_fold<<<(unsigned)((k + 31) / 32), dim3(32, kFoldLanes), 0, stream>>>(
      part, out, (int)k, (int)slabs);
}

}  // namespace
