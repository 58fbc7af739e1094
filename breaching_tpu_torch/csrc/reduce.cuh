// Block-level sums shared by the reduction kernels: B1 matching sums and B3 TV
// forward reduce in two launches, the fused TV value and gradient (csrc/image.cu)
// in one.
//
// No float atomics, and the result is the same from run to run: every block writes
// its K partial sums to scratch (partials[block * K + k]), then one block adds them
// up in a fixed order (`sum_partials`, a second launch; in the fused kernel, the
// block that finishes last). The number of blocks is a function of the input shape
// only, so the order of additions is too.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace breaching {

constexpr int kThreads = 256;        // threads per block for every kernel here
constexpr int kMaxReduceBlocks = 1024;

// Sums each of K values over the block; the totals are valid in thread 0.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K]) {
  __shared__ float warp_sums[K][kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      v[k] += __shfl_down_sync(0xffffffffu, v[k], offset);
    }
    if (lane == 0) warp_sums[k][warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = lane < kThreads / 32 ? warp_sums[k][lane] : 0.0f;
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) {
        v[k] += __shfl_down_sync(0xffffffffu, v[k], offset);
      }
    }
  }
}

// One block: out[k] = scale * sum over blocks b of partials[b * K + k].
template <int K>
__global__ void __launch_bounds__(kThreads)
sum_partials(const float* __restrict__ partials, int num_blocks, float scale,
             float* __restrict__ out) {
  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0.0f;
  for (int b = threadIdx.x; b < num_blocks; b += kThreads) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += partials[(int64_t)b * K + k];
  }
  block_sum<K>(v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = v[k] * scale;
  }
}

// Grid size for an elementwise grid-stride pass over n elements, `per_thread` each.
inline int grid_for(int64_t n, int per_thread, int max_blocks) {
  int64_t blocks = (n + (int64_t)kThreads * per_thread - 1) / ((int64_t)kThreads * per_thread);
  if (blocks < 1) blocks = 1;
  return (int)(blocks < max_blocks ? blocks : max_blocks);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace breaching
