// Block-level sums shared by the reduction kernels: B1 matching sums reduce in two
// launches, the fused TV kernel (csrc/image.cu: the value and gradient, and B3 TV
// forward, its value-only form) in one.
//
// No float atomics, and the result is the same from run to run: every block writes
// its K partial sums to scratch (partials[block * K + k]), then one block adds them
// up in a fixed order (`sum_partials`, a second launch; in the fused kernel, the
// segment's first block, through flagged slots). The number of blocks is a function of
// the input shape only, so the order of additions is too.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace breaching {

constexpr int kThreads = 256;        // threads per block, for every kernel here but the fused TV's
constexpr int kMaxReduceBlocks = 1024;

// Sums each of K values over a block of Threads threads; the totals are valid in thread 0.
template <int K, int Threads = kThreads>
__device__ __forceinline__ void block_sum(float (&v)[K]) {
  __shared__ float warp_sums[K][Threads / 32];
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
      v[k] = lane < Threads / 32 ? warp_sums[k][lane] : 0.0f;
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

// Blocks for each of `segments` segments of `units` units (one unit a thread a round)
// when one wave of `wave` blocks is shared among them: at least one, at most what one
// round of the segment needs.
inline int blocks_per_segment(int wave, int64_t segments, int64_t units) {
  int64_t share = wave / (segments < 1 ? 1 : segments);
  const int64_t need = (units + kThreads - 1) / kThreads;
  if (share > need) share = need;
  return share < 1 ? 1 : (int)share;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// How a kernel fills the current device: its registers per thread, static shared
// memory and local (spilled) bytes per thread (cudaFuncGetAttributes), the blocks of
// `threads` threads resident on one SM (the occupancy API) and, times the SM count, the
// blocks of one wave. Read once per device and kept: a launcher asks on every launch.
struct Occupancy {
  int registers, shared_bytes, local_bytes, blocks_per_sm, wave;
};

constexpr int kMaxDevices = 64;

inline Occupancy occupancy(const void* kernel, int threads, Occupancy (&cache)[kMaxDevices]) {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kMaxDevices) return Occupancy{};
  Occupancy& o = cache[device];
  if (o.wave == 0) {
    cudaFuncAttributes attributes;
    int per_sm = 0, sms = 0;
    if (cudaFuncGetAttributes(&attributes, kernel) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || per_sm < 1)
      return Occupancy{};
    o = Occupancy{attributes.numRegs, (int)attributes.sharedSizeBytes, (int)attributes.localSizeBytes, per_sm,
                  per_sm * sms};
  }
  return o;
}

}  // namespace breaching
