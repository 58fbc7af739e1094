// Gradient-matching kernels of the cosine objective.
//
// B1 `b1_matching_sums` replaces breaching_tpu/ops/matching.py `_matching_sums`
// (Pallas `_reduction_kernel`): (<rec, data>, |rec|^2, |data|^2) in one pass over
// two flat float32 vectors, accumulated in float32. Bound on the H100: it reads
// 8 bytes per element and does 6 flops, so bytes bound it: 8 n / 3.35 TB/s
// (about 6.9 us for ConvNet-64's 2,904,970 parameters). Design: a grid-stride
// loop with 16-byte loads where both vectors are 16-byte aligned, a scalar tail
// (no padding, unlike the TPU's 2048x128 tiles), per-block partial sums in
// scratch, and a second one-block launch that adds them in a fixed order.
//
// B2 `b2_axpby` replaces `_axpby` (Pallas `_axpby_kernel`): out = a x + b y with
// scalars a, b read from device memory, so the backward of the cosine never waits
// on the host. Bound: 12 bytes per element, 12 n / 3.35 TB/s (about 10.4 us at
// ConvNet-64). Design: 16-byte vector loads and stores with a masked scalar tail.
// Products and the sum are rounded separately (no fused multiply-add), which is
// what the plain PyTorch version computes.
#include "reduce.cuh"

namespace breaching {

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
matching_partials(const float* __restrict__ rec, const float* __restrict__ data, int64_t n,
                  float* __restrict__ partials) {
  float v[3] = {0.0f, 0.0f, 0.0f};
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t tail = 0;
  if (kVec) {
    const int64_t n4 = n / 4;
    const float4* r4 = reinterpret_cast<const float4*>(rec);
    const float4* d4 = reinterpret_cast<const float4*>(data);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 r = r4[i];
      const float4 d = d4[i];
      v[0] += r.x * d.x + r.y * d.y + r.z * d.z + r.w * d.w;
      v[1] += r.x * r.x + r.y * r.y + r.z * r.z + r.w * r.w;
      v[2] += d.x * d.x + d.y * d.y + d.z * d.z + d.w * d.w;
    }
    tail = n4 * 4;
  }
  for (int64_t i = tail + tid; i < n; i += stride) {
    const float r = rec[i];
    const float d = data[i];
    v[0] += r * d;
    v[1] += r * r;
    v[2] += d * d;
  }
  block_sum<3>(v);
  if (threadIdx.x == 0) {
    partials[(int64_t)blockIdx.x * 3 + 0] = v[0];
    partials[(int64_t)blockIdx.x * 3 + 1] = v[1];
    partials[(int64_t)blockIdx.x * 3 + 2] = v[2];
  }
}

__device__ __forceinline__ float axpby1(float a, float x, float b, float y) {
  return __fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
axpby_kernel(const float* __restrict__ a_ptr, const float* __restrict__ x,
             const float* __restrict__ b_ptr, const float* __restrict__ y,
             float* __restrict__ out, int64_t n) {
  const float a = *a_ptr;
  const float b = *b_ptr;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t tail = 0;
  if (kVec) {
    const int64_t n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 xv = x4[i];
      const float4 yv = y4[i];
      o4[i] = make_float4(axpby1(a, xv.x, b, yv.x), axpby1(a, xv.y, b, yv.y),
                          axpby1(a, xv.z, b, yv.z), axpby1(a, xv.w, b, yv.w));
    }
    tail = n4 * 4;
  }
  for (int64_t i = tail + tid; i < n; i += stride) out[i] = axpby1(a, x[i], b, y[i]);
}

}  // namespace breaching

using namespace breaching;

// sums[0..2] = (<rec, data>, |rec|^2, |data|^2). `partials` holds 3 * num_blocks floats.
extern "C" int b1_matching_sums(const float* rec, const float* data, int64_t n, float* partials,
                                int num_blocks, float* sums, void* stream) {
  if (n < 0 || num_blocks < 1 || num_blocks > kMaxReduceBlocks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned16(rec) && aligned16(data)) {
    matching_partials<true><<<num_blocks, kThreads, 0, s>>>(rec, data, n, partials);
  } else {
    matching_partials<false><<<num_blocks, kThreads, 0, s>>>(rec, data, n, partials);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<3><<<1, kThreads, 0, s>>>(partials, num_blocks, 1.0f, sums);
  return (int)cudaGetLastError();
}

// out = a[0] * x + b[0] * y over n floats.
extern "C" int b2_axpby(const float* a, const float* x, const float* b, const float* y,
                        float* out, int64_t n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(n, 4, 8192);
  if (aligned16(x) && aligned16(y) && aligned16(out)) {
    axpby_kernel<true><<<grid, kThreads, 0, s>>>(a, x, b, y, out, n);
  } else {
    axpby_kernel<false><<<grid, kThreads, 0, s>>>(a, x, b, y, out, n);
  }
  return (int)cudaGetLastError();
}
