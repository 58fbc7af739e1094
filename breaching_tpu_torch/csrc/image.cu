// Image-space kernels of the attack step, on NCHW float32 batches.
//
// B3 `b3_tv_forward` replaces breaching_tpu/ops/image.py `fused_total_variation`
// (Pallas `_tv_kernel`): sum over pixels of ((|dx|+eps)^p + (|dy|+eps)^p)^q divided
// by the element count, with forward differences along W (dx) and H (dy) and the
// last column's dx and last row's dy set to 0. Bound: 4 bytes read per element,
// 4 n / 3.35 TB/s (3.7 ns for one 3x32x32 image), far below a launch: the kernel
// is one block-reduction pass like B1, and its cost is the two launches.
//
// `b3_tv_backward` is the gradient the TPU kernel lacks (the JAX package computes
// it in regularizers.py `_tv_p1q1_bwd` and `_make_tv_general`): the divergence of
// the field g_x = q (px+py)^(q-1) p (|dx|+eps)^(p-1) sign(dx) (and g_y alike),
// times upstream / element count. One elementwise stencil pass; each thread
// recomputes its neighbours' differences from the input instead of storing them.
// Bound: 8 bytes per element, 8 n / 3.35 TB/s.
//
// B4 `b4_box_project` replaces `box_project` (Pallas `_box_kernel`): clamps each
// element to its channel's [lo, hi]; the channel is dim 1 of NCHW. Bound: 8 bytes
// per element. 16-byte vector loads with a masked tail. A NaN input stays NaN, as
// with torch.clamp.
#include "reduce.cuh"

namespace breaching {

// x^e without transcendentals for the exponents the configs use
// (breaching_tpu/attacks/auxiliaries/regularizers.py `_cheap_pow`).
__device__ __forceinline__ float cheap_pow(float x, float e) {
  if (e == 0.0f) return 1.0f;
  if (e == 1.0f) return x;
  if (e == 2.0f) return x * x;
  if (e == 0.5f) return sqrtf(x);
  if (e == 1.5f) return x * sqrtf(x);
  return powf(x, e);
}

__device__ __forceinline__ float sign_of(float d) { return (float)((d > 0.0f) - (d < 0.0f)); }

struct TVParams {
  int H, W;
  float p, q, eps;
};

// Masked forward differences at (h, w) of one H x W plane.
__device__ __forceinline__ void diffs(const float* __restrict__ plane, int h, int w, const TVParams& t,
                                      float& dx, float& dy) {
  const float c = plane[h * t.W + w];
  dx = (w < t.W - 1) ? plane[h * t.W + w + 1] - c : 0.0f;
  dy = (h < t.H - 1) ? plane[(h + 1) * t.W + w] - c : 0.0f;
}

// The gradient field (g_x, g_y) of the TV integrand with respect to (dx, dy) at (h, w).
__device__ __forceinline__ void grad_field(const float* __restrict__ plane, int h, int w,
                                           const TVParams& t, float& gx, float& gy) {
  float dx, dy;
  diffs(plane, h, w, t, dx, dy);
  const float ax = fabsf(dx) + t.eps;
  const float ay = fabsf(dy) + t.eps;
  const float outer = t.q * cheap_pow(cheap_pow(ax, t.p) + cheap_pow(ay, t.p), t.q - 1.0f);
  gx = (w < t.W - 1) ? outer * t.p * cheap_pow(ax, t.p - 1.0f) * sign_of(dx) : 0.0f;
  gy = (h < t.H - 1) ? outer * t.p * cheap_pow(ay, t.p - 1.0f) * sign_of(dy) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
tv_forward_partials(const float* __restrict__ x, int64_t n, TVParams t, float* __restrict__ partials) {
  float v[1] = {0.0f};
  const int64_t hw = (int64_t)t.H * t.W;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int64_t r = i % hw;
    const int h = (int)(r / t.W);
    const int w = (int)(r % t.W);
    float dx, dy;
    diffs(x + (i - r), h, w, t, dx, dy);
    const float px = cheap_pow(fabsf(dx) + t.eps, t.p);
    const float py = cheap_pow(fabsf(dy) + t.eps, t.p);
    v[0] += cheap_pow(px + py, t.q);
  }
  block_sum<1>(v);
  if (threadIdx.x == 0) partials[blockIdx.x] = v[0];
}

__global__ void __launch_bounds__(kThreads)
tv_backward_kernel(const float* __restrict__ x, const float* __restrict__ upstream, int64_t n,
                   TVParams t, float* __restrict__ out) {
  const float scale = __fdiv_rn(*upstream, (float)n);
  const int64_t hw = (int64_t)t.H * t.W;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int64_t r = i % hw;
    const int h = (int)(r / t.W);
    const int w = (int)(r % t.W);
    const float* plane = x + (i - r);
    float gx, gy, gx_left = 0.0f, gy_up = 0.0f, unused;
    grad_field(plane, h, w, t, gx, gy);
    if (w > 0) grad_field(plane, h, w - 1, t, gx_left, unused);
    if (h > 0) grad_field(plane, h - 1, w, t, unused, gy_up);
    out[i] = ((gx_left - gx) + (gy_up - gy)) * scale;
  }
}

__device__ __forceinline__ float clamp1(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
box_kernel(const float* __restrict__ x, const float* __restrict__ lo, const float* __restrict__ hi,
           float* __restrict__ out, int64_t n, int64_t hw, int channels) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t tail = 0;
  if (kVec) {
    const int64_t n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 v = x4[i];
      const int64_t e = i * 4;
      const int c0 = (int)((e / hw) % channels), c1 = (int)(((e + 1) / hw) % channels);
      const int c2 = (int)(((e + 2) / hw) % channels), c3 = (int)(((e + 3) / hw) % channels);
      o4[i] = make_float4(clamp1(v.x, lo[c0], hi[c0]), clamp1(v.y, lo[c1], hi[c1]),
                          clamp1(v.z, lo[c2], hi[c2]), clamp1(v.w, lo[c3], hi[c3]));
    }
    tail = n4 * 4;
  }
  for (int64_t i = tail + tid; i < n; i += stride) {
    const int c = (int)((i / hw) % channels);
    out[i] = clamp1(x[i], lo[c], hi[c]);
  }
}

}  // namespace breaching

using namespace breaching;

// out[0] = TV of the NCHW batch x (n = N*C*H*W elements). `partials` holds num_blocks floats.
extern "C" int b3_tv_forward(const float* x, int64_t n, int H, int W, float p, float q, float eps,
                             float* partials, int num_blocks, float* out, void* stream) {
  if (n < 1 || H < 1 || W < 1 || n % ((int64_t)H * W) != 0 || num_blocks < 1 ||
      num_blocks > kMaxReduceBlocks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TVParams t{H, W, p, q, eps};
  tv_forward_partials<<<num_blocks, kThreads, 0, s>>>(x, n, t, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<1><<<1, kThreads, 0, s>>>(partials, num_blocks, 1.0f / (float)n, out);
  return (int)cudaGetLastError();
}

// out = d TV / d x times upstream[0], for the NCHW batch x.
extern "C" int b3_tv_backward(const float* x, const float* upstream, int64_t n, int H, int W,
                              float p, float q, float eps, float* out, void* stream) {
  if (n < 1 || H < 1 || W < 1 || n % ((int64_t)H * W) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TVParams t{H, W, p, q, eps};
  tv_backward_kernel<<<grid_for(n, 1, 8192), kThreads, 0, s>>>(x, upstream, n, t, out);
  return (int)cudaGetLastError();
}

// out = clamp(x, lo[c], hi[c]) for the NCHW batch x with `channels` channels of hw pixels.
extern "C" int b4_box_project(const float* x, const float* lo, const float* hi, float* out,
                              int64_t n, int64_t hw, int channels, void* stream) {
  if (n < 0 || hw < 1 || channels < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(n, 4, 8192);
  if (aligned16(x) && aligned16(out)) {
    box_kernel<true><<<grid, kThreads, 0, s>>>(x, lo, hi, out, n, hw, channels);
  } else {
    box_kernel<false><<<grid, kThreads, 0, s>>>(x, lo, hi, out, n, hw, channels);
  }
  return (int)cudaGetLastError();
}
