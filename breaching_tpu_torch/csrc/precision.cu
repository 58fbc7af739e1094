// The kernels B1-B4 in the element types other than float32 that the attack's precision
// knobs give them: `attack.impl.dtype` (bfloat16 or float16 gradient leaves matched
// against float32 targets) and `case.impl.dtype` (a float64 or bfloat16 candidate, its
// gradients and targets). The float32 forms stay in csrc/matching.cu and csrc/image.cu;
// csrc/bindings.cpp sends a call here only for the type pairs instantiated below, and
// raises by name for any other.
//
// One template per function, each a plain grid-stride kernel (a simple form first:
// these forms are not yet tuned). Half-precision elements are widened to float32 on
// load, every sum and product is taken in float32, and results are rounded to the
// element type on store; float64 elements are summed and multiplied in float64. No
// fused multiply-add: each product and sum is rounded on its own (__fmul_rn and
// friends), in the plain PyTorch version's order (ops/matching.py, ops/image.py), so
// that the two differ only by the order of the reductions' additions.
//
// - B1 `matching_sums` (replaces breaching_tpu/ops/matching.py `_matching_sums`):
//   (<r, d>, |r|^2, |d|^2) for r in bf16 or f16 with d in f32, or r in f32 with d in
//   bf16, summed in f32; r and d in f64, summed in f64. Per-block partials, then one block adds them in
//   a fixed order (the same bits every run). Bound: bytes, (sizeof r + sizeof d) n.
// - B2 `cosine_backward` (replaces `_axpby` in `_cos_bwd`, matching.py:135-146): the
//   cosine's VJP a d + b r from B1's sums, for T rows at once, written in r's type
//   (d's type for d/d data). `axpby` (replaces `_axpby`): a x + b y written in x's type,
//   for x and y in f64, or x in f32 with y in bf16 (`fused-euclidean`'s backward). Bound: bytes, reads of r and d
//   and the write of out.
// - B3 `tv_value_and_grad` (replaces breaching_tpu/ops/image.py `fused_total_variation`
//   and computes what the attack's XLA TV, regularizers.py:23-90, computes): the mean
//   anisotropic TV of each segment times a scale and its gradient, on f64 (summed in
//   f64) or bf16 (summed in f32) candidates. Each thread recomputes the field at its
//   pixel and at its left and upper neighbours (wrapped, as the JAX VJP's rolls), so no
//   shared tile; the value's partials go per block, then one block per segment adds
//   them. Bound: bytes, one read of x and one write of the gradient.
// - B4 `box_project` (replaces `box_project`): the per-channel clamp, exact in any type.
//   `adam_box_step`: sign, optax's Adam with its moments in the candidate's type, the
//   box, the finite guard and the best iterate, for T trials; the loss values and best
//   values are f32 for a bf16 candidate and f64 for a f64 one. Bound: bytes, at most
//   five reads and four writes of the candidate's elements.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace breaching {
namespace precision {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

// The element types and their accumulation types.
template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T narrow(typename Acc<T>::type v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ double narrow<double>(double v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ __half narrow<__half>(float v) { return __float2half_rn(v); }

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float power(float a, float e) { return powf(a, e); }
__device__ __forceinline__ double power(double a, double e) { return pow(a, e); }
__device__ __forceinline__ float magnitude(float a) { return fabsf(a); }
__device__ __forceinline__ double magnitude(double a) { return ::fabs(a); }
__device__ __forceinline__ float hyptan(float a) { return tanhf(a); }
__device__ __forceinline__ double hyptan(double a) { return tanh(a); }
__device__ __forceinline__ bool finite(float a) { return isfinite(a); }
__device__ __forceinline__ bool finite(double a) { return isfinite(a); }

// jnp.sign: -1 or 1 by the sign, NaN and both zeros kept.
template <typename A> __device__ __forceinline__ A sgn(A v) { return v > A(0) ? A(1) : (v < A(0) ? A(-1) : v); }

// x ** e as ops/image.py cheap_pow forms it.
template <typename A> __device__ __forceinline__ A cheap_pow(A x, A e) {
  if (e == A(0)) return A(1);
  if (e == A(1)) return x;
  if (e == A(2)) return mul(x, x);
  if (e == A(0.5)) return root(x);
  if (e == A(1.5)) return mul(x, root(x));
  return power(x, e);
}

// Sums each of K values over the block; the totals are valid in thread 0.
template <int K, typename A>
__device__ __forceinline__ void block_sum(A (&v)[K]) {
  __shared__ A partial[K][kThreads];
#pragma unroll
  for (int k = 0; k < K; ++k) partial[k][threadIdx.x] = v[k];
  __syncthreads();
  for (int width = kThreads / 2; width > 0; width >>= 1) {
    if ((int)threadIdx.x < width) {
#pragma unroll
      for (int k = 0; k < K; ++k) partial[k][threadIdx.x] = add(partial[k][threadIdx.x], partial[k][threadIdx.x + width]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = partial[k][0];
}

// ------------------------------------------------------------------------- B1

template <typename R, typename D>
__global__ void __launch_bounds__(kThreads)
matching_partials(const R* __restrict__ rec, const D* __restrict__ data, int64_t n,
                  typename Acc<R>::type* __restrict__ partials) {
  using A = typename Acc<R>::type;
  A v[3] = {A(0), A(0), A(0)};
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const A r = (A)widen(rec[i]);
    const A d = (A)widen(data[i]);
    v[0] = add(v[0], mul(r, d));
    v[1] = add(v[1], mul(r, r));
    v[2] = add(v[2], mul(d, d));
  }
  block_sum<3>(v);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 3; ++k) partials[(int64_t)blockIdx.x * 3 + k] = v[k];
  }
}

template <typename A>
__global__ void __launch_bounds__(kThreads)
sum_partials(const A* __restrict__ partials, int num_blocks, A* __restrict__ out) {
  A v[3] = {A(0), A(0), A(0)};
  for (int b = threadIdx.x; b < num_blocks; b += kThreads) {
    for (int k = 0; k < 3; ++k) v[k] = add(v[k], partials[(int64_t)b * 3 + k]);
  }
  block_sum<3>(v);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 3; ++k) out[k] = v[k];
  }
}

inline int blocks_for(int64_t n) {
  int64_t b = (n + (int64_t)kThreads * 16 - 1) / ((int64_t)kThreads * 16);
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

template <typename R, typename D>
int matching_sums(const void* rec, const void* data, int64_t n, void* partials, void* sums, cudaStream_t s) {
  using A = typename Acc<R>::type;
  const int blocks = blocks_for(n);
  matching_partials<R, D><<<blocks, kThreads, 0, s>>>(static_cast<const R*>(rec), static_cast<const D*>(data), n,
                                                     static_cast<A*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<A><<<1, kThreads, 0, s>>>(static_cast<const A*>(partials), blocks, static_cast<A*>(sums));
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------- B2

// out[r] = a_r other[r] + b_r self[r] over rows of n elements, from sums[r] and g[r] in
// `_cos_bwd`'s order; out in self's type.
template <typename S, typename O>
__global__ void __launch_bounds__(kThreads)
cosine_backward_kernel(const typename Acc<S>::type* __restrict__ sums, const typename Acc<S>::type* __restrict__ g,
                       const S* __restrict__ self, const O* __restrict__ other, S* __restrict__ out, int64_t n,
                       int blocks_per_row, int wrt_data) {
  using A = typename Acc<S>::type;
  const int row = blockIdx.x / blocks_per_row;
  const A gr = g[row];
  const A dot = sums[3 * row];
  const A rec_n = root(sums[3 * row + 1]);
  const A data_n = root(sums[3 * row + 2]);
  const A self_n = wrt_data ? data_n : rec_n;
  const A other_n = wrt_data ? rec_n : data_n;
  const A a = dvd(-gr, add(mul(rec_n, data_n), A(1e-12)));
  const A b = dvd(mul(gr, dot), add(mul(mul(mul(self_n, self_n), self_n), other_n), A(1e-12)));
  const int64_t offset = (int64_t)row * n;
  const int64_t stride = (int64_t)blocks_per_row * kThreads;
  for (int64_t i = (int64_t)(blockIdx.x - row * blocks_per_row) * kThreads + threadIdx.x; i < n; i += stride) {
    out[offset + i] = narrow<S>(add(mul(a, (A)widen(other[offset + i])), mul(b, (A)widen(self[offset + i]))));
  }
}

template <typename S, typename O>
int cosine_backward(const void* sums, const void* g, const void* self, const void* other, void* out, int64_t rows,
                    int64_t n, int wrt_data, cudaStream_t s) {
  using A = typename Acc<S>::type;
  int64_t bpr = (n + kThreads - 1) / kThreads;
  const int64_t cap = (4 * kMaxBlocks) / rows;
  if (bpr > cap) bpr = cap;
  if (bpr < 1) bpr = 1;
  cosine_backward_kernel<S, O><<<(int)(rows * bpr), kThreads, 0, s>>>(
      static_cast<const A*>(sums), static_cast<const A*>(g), static_cast<const S*>(self),
      static_cast<const O*>(other), static_cast<S*>(out), n, (int)bpr, wrt_data);
  return (int)cudaGetLastError();
}

// out = a x + b y, out in x's type, a and b one element each of x's accumulation type.
template <typename X, typename Y>
__global__ void __launch_bounds__(kThreads)
axpby_kernel(const typename Acc<X>::type* __restrict__ a_ptr, const X* __restrict__ x,
             const typename Acc<X>::type* __restrict__ b_ptr, const Y* __restrict__ y, X* __restrict__ out,
             int64_t n) {
  using A = typename Acc<X>::type;
  const A a = *a_ptr, b = *b_ptr;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    out[i] = narrow<X>(add(mul(a, (A)widen(x[i])), mul(b, (A)widen(y[i]))));
  }
}

template <typename X, typename Y>
int axpby(const void* a, const void* x, const void* b, const void* y, void* out, int64_t n, cudaStream_t s) {
  using A = typename Acc<X>::type;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4 * kMaxBlocks) blocks = 4 * kMaxBlocks;
  if (blocks < 1) blocks = 1;
  axpby_kernel<X, Y><<<(int)blocks, kThreads, 0, s>>>(static_cast<const A*>(a), static_cast<const X*>(x),
                                                     static_cast<const A*>(b), static_cast<const Y*>(y),
                                                     static_cast<X*>(out), n);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------- B3

struct TVShape {
  int H, W;
};

// The field (gx, gy) of the TV's gradient at (h, w) of the plane at `plane`, as
// ops/image.py tv_backward_plain forms it: differences to the wrapped right and lower
// neighbours, masked at the last column and row by a product with 0 or 1.
template <typename T, typename A>
__device__ __forceinline__ void field(const T* __restrict__ plane, int h, int w, TVShape t, A p, A q, A eps,
                                      bool p1q1, A& gx, A& gy) {
  const A x = (A)widen(plane[(int64_t)h * t.W + w]);
  const A right = (A)widen(plane[(int64_t)h * t.W + (w + 1 < t.W ? w + 1 : 0)]);
  const A down = (A)widen(plane[(int64_t)(h + 1 < t.H ? h + 1 : 0) * t.W + w]);
  const A col = w < t.W - 1 ? A(1) : A(0);
  const A row = h < t.H - 1 ? A(1) : A(0);
  A dx = sub(right, x), dy = sub(down, x);
  if (p1q1) {
    gx = mul(sgn(dx), col);
    gy = mul(sgn(dy), row);
    return;
  }
  dx = mul(dx, col);
  dy = mul(dy, row);
  const A ax = add(magnitude(dx), eps), ay = add(magnitude(dy), eps);
  const A px = cheap_pow(ax, p), py = cheap_pow(ay, p);
  const A outer = mul(q, cheap_pow(add(px, py), sub(q, A(1))));
  gx = mul(mul(mul(mul(outer, p), cheap_pow(ax, sub(p, A(1)))), sgn(dx)), col);
  gy = mul(mul(mul(mul(outer, p), cheap_pow(ay, sub(p, A(1)))), sgn(dy)), row);
}

// Each segment of `per` elements (whole images) takes `bps` consecutive blocks. A thread
// writes the gradient of its pixels and sums their value terms ((|dx|+eps)^p +
// (|dy|+eps)^p)^q, with the last column's dx and last row's dy x - x as jnp.diff(...,
// append=) forms them; each block stores its partial sum.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tv_kernel(const T* __restrict__ x, const T* __restrict__ scale_ptr, int64_t per, TVShape t,
          typename Acc<T>::type p, typename Acc<T>::type q, typename Acc<T>::type eps, bool p1q1, int bps,
          typename Acc<T>::type* __restrict__ partials, T* __restrict__ grad) {
  using A = typename Acc<T>::type;
  const int segment = blockIdx.x / bps;
  const int64_t hw = (int64_t)t.H * t.W;
  const A factor = dvd((A)widen(*scale_ptr), (A)per);
  const T* base = x + (int64_t)segment * per;
  T* gbase = grad + (int64_t)segment * per;
  A value[1] = {A(0)};
  const int64_t stride = (int64_t)bps * kThreads;
  for (int64_t i = (int64_t)(blockIdx.x - segment * bps) * kThreads + threadIdx.x; i < per; i += stride) {
    const T* plane = base + (i / hw) * hw;
    const int h = (int)((i % hw) / t.W), w = (int)(i % t.W);
    // the value term at (h, w)
    const A xv = (A)widen(plane[(int64_t)h * t.W + w]);
    const A dxv = w + 1 < t.W ? sub((A)widen(plane[(int64_t)h * t.W + w + 1]), xv) : sub(xv, xv);
    const A dyv = h + 1 < t.H ? sub((A)widen(plane[(int64_t)(h + 1) * t.W + w]), xv) : sub(xv, xv);
    const A term = cheap_pow(add(cheap_pow(add(magnitude(dxv), eps), p), cheap_pow(add(magnitude(dyv), eps), p)), q);
    value[0] = add(value[0], term);
    if (grad != nullptr) {
      A gx, gy, gxl, gyl, gxu, gyu;
      field(plane, h, w, t, p, q, eps, p1q1, gx, gy);
      field(plane, h, w > 0 ? w - 1 : t.W - 1, t, p, q, eps, p1q1, gxl, gyl);
      field(plane, h > 0 ? h - 1 : t.H - 1, w, t, p, q, eps, p1q1, gxu, gyu);
      gbase[i] = narrow<T>(mul(add(sub(gxl, gx), sub(gyu, gy)), factor));
    }
  }
  block_sum<1>(value);
  if (threadIdx.x == 0) partials[blockIdx.x] = value[0];
}

// values[s] = scale * (sum of segment s's partials) / per, one block per segment.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tv_finish(const typename Acc<T>::type* __restrict__ partials, int bps, const T* __restrict__ scale_ptr, int64_t per,
          T* __restrict__ values) {
  using A = typename Acc<T>::type;
  A v[1] = {A(0)};
  for (int b = threadIdx.x; b < bps; b += kThreads) v[0] = add(v[0], partials[(int64_t)blockIdx.x * bps + b]);
  block_sum<1>(v);
  if (threadIdx.x == 0) values[blockIdx.x] = narrow<T>(mul(dvd(v[0], (A)per), (A)widen(*scale_ptr)));
}

template <typename T>
int tv_blocks_per_segment(int64_t per, int segments) {
  int64_t bps = (per + kThreads - 1) / kThreads;
  const int64_t cap = (4 * kMaxBlocks) / segments;
  if (bps > cap) bps = cap;
  return (int)(bps < 1 ? 1 : bps);
}

template <typename T>
int tv_value_and_grad(const void* x, const void* scale, int64_t n, int H, int W, int segments, double p, double q,
                      double eps, void* partials, void* values, void* grad, cudaStream_t s) {
  using A = typename Acc<T>::type;
  const int64_t per = n / segments;
  const int bps = tv_blocks_per_segment<T>(per, segments);
  const bool p1q1 = p == 1.0 && q == 1.0;
  tv_kernel<T><<<segments * bps, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(scale), per,
                                                   TVShape{H, W}, (A)p, (A)q, (A)eps, p1q1, bps,
                                                   static_cast<A*>(partials), static_cast<T*>(grad));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tv_finish<T><<<segments, kThreads, 0, s>>>(static_cast<const A*>(partials), bps, static_cast<const T*>(scale), per,
                                             static_cast<T*>(values));
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------- B4

template <typename T>
__global__ void __launch_bounds__(kThreads)
box_kernel(const T* x, const T* __restrict__ lo, const T* __restrict__ hi, T* out, int64_t n, int64_t hw,
           int channels) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int c = (int)((i / hw) % channels);
    const auto v = widen(x[i]);
    const auto l = widen(lo[c]), h = widen(hi[c]);
    // torch.minimum(torch.maximum(x, lo), hi): NaN stays NaN
    const auto m = v != v ? v : (v > l ? v : l);
    out[i] = narrow<T>(m != m ? m : (m < h ? m : h));
  }
}

template <typename T>
int box_project(const void* x, const void* lo, const void* hi, void* out, int64_t n, int64_t hw, int channels,
                cudaStream_t s) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4 * kMaxBlocks) blocks = 4 * kMaxBlocks;
  if (blocks < 1) blocks = 1;
  box_kernel<T><<<(int)blocks, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(lo),
                                                 static_cast<const T*>(hi), static_cast<T*>(out), n, hw, channels);
  return (int)cudaGetLastError();
}

template <typename A>
struct AdamScalars {
  A lr, one_minus_b1, b1, one_minus_b2, b2, eps, bias1, bias2, soft_scale, soft_div;
};

// Trial t's elements are [t per, (t + 1) per); its blocks are consecutive, `bpt` of
// them. mode: 0 unsigned, 1 hard sign, 4 soft sign.
template <typename T>
__global__ void __launch_bounds__(kThreads)
adam_kernel(T* __restrict__ x, const T* __restrict__ grad, T* __restrict__ mu, T* __restrict__ nu,
            T* __restrict__ best, const T* __restrict__ lo, const T* __restrict__ hi,
            const typename Acc<T>::type* __restrict__ values, const typename Acc<T>::type* __restrict__ best_vals,
            typename Acc<T>::type* __restrict__ new_best_vals, int64_t per, int64_t hw, int channels, int bpt,
            AdamScalars<typename Acc<T>::type> a, int mode, bool boxed) {
  using A = typename Acc<T>::type;
  const int trial = blockIdx.x / bpt;
  const A value = values[trial], best_val = best_vals[trial];
  const bool ok = finite(value);
  const bool improved = ok && value < best_val;
  if (blockIdx.x == trial * bpt && threadIdx.x == 0) new_best_vals[trial] = improved ? value : best_val;
  const int64_t offset = (int64_t)trial * per;
  const int64_t stride = (int64_t)bpt * kThreads;
  for (int64_t j = (int64_t)(blockIdx.x - trial * bpt) * kThreads + threadIdx.x; j < per; j += stride) {
    const int64_t i = offset + j;
    const A g = (A)widen(grad[i]);
    const A sg = mode == 1 ? sgn(g) : (mode == 4 ? dvd(hyptan(mul(g, a.soft_scale)), a.soft_div) : g);
    const A m = add(mul(a.one_minus_b1, sg), mul(a.b1, (A)widen(mu[i])));
    const A v = add(mul(a.one_minus_b2, mul(sg, sg)), mul(a.b2, (A)widen(nu[i])));
    const T m_t = narrow<T>(m), v_t = narrow<T>(v);
    mu[i] = m_t;
    nu[i] = v_t;
    const A xv = (A)widen(x[i]);
    // the stored moments, as the plain version reads them back
    const A step = dvd(dvd((A)widen(m_t), a.bias1), add(root(dvd((A)widen(v_t), a.bias2)), a.eps));
    A next = (A)widen(narrow<T>(add(xv, mul(-a.lr, step))));
    if (boxed) {
      const int c = (int)((j / hw) % channels);
      const A l = (A)widen(lo[c]), h = (A)widen(hi[c]);
      next = next != next ? next : (next > l ? next : l);
      next = next != next ? next : (next < h ? next : h);
    }
    if (improved) best[i] = x[i];
    if (ok) x[i] = narrow<T>(next);
  }
}

template <typename T>
int adam_box_step(void* x, const void* grad, void* mu, void* nu, void* best, const void* lo, const void* hi,
                  const void* values, const void* best_vals, void* new_best_vals, int64_t trials, int64_t per,
                  int64_t hw, int channels, const double* scalars, int flags, cudaStream_t s) {
  using A = typename Acc<T>::type;
  int64_t bpt = (per + kThreads - 1) / kThreads;
  const int64_t cap = (4 * kMaxBlocks) / trials;
  if (bpt > cap) bpt = cap;
  if (bpt < 1) bpt = 1;
  // lr, b1, b2, eps, bias1, bias2, soft_scale, soft_div; 1 - b1 and 1 - b2 formed in double
  const AdamScalars<A> a{(A)scalars[0], (A)(1.0 - scalars[1]), (A)scalars[1], (A)(1.0 - scalars[2]),
                         (A)scalars[2], (A)scalars[3], (A)scalars[4], (A)scalars[5], (A)scalars[6], (A)scalars[7]};
  const int mode = (flags & 1) ? 1 : ((flags & 4) ? 4 : 0);
  adam_kernel<T><<<(int)(trials * bpt), kThreads, 0, s>>>(
      static_cast<T*>(x), static_cast<const T*>(grad), static_cast<T*>(mu), static_cast<T*>(nu),
      static_cast<T*>(best), static_cast<const T*>(lo), static_cast<const T*>(hi), static_cast<const A*>(values),
      static_cast<const A*>(best_vals), static_cast<A*>(new_best_vals), per, hw, channels, (int)bpt, a, mode,
      (flags & 2) != 0);
  return (int)cudaGetLastError();
}

}  // namespace precision
}  // namespace breaching

using namespace breaching::precision;

// Element type codes, as csrc/bindings.cpp passes them.
enum : int { kF32 = 0, kF64 = 1, kBF16 = 2, kF16 = 3 };

static cudaStream_t as_stream(void* stream) { return static_cast<cudaStream_t>(stream); }

// B1 for (rec, data) in (bf16, f32) and (f16, f32) (attack.impl.dtype), (f32, bf16)
// (case.impl.dtype=bfloat16: float32 gradients, bfloat16 targets) and (f64, f64).
// `partials` holds 3 * 1024 sums of the accumulation type, `sums` 3.
extern "C" int b1_matching_sums_typed(int rec_type, int data_type, const void* rec, const void* data, int64_t n,
                                      void* partials, void* sums, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = as_stream(stream);
  if (rec_type == kBF16 && data_type == kF32) return matching_sums<__nv_bfloat16, float>(rec, data, n, partials, sums, s);
  if (rec_type == kF16 && data_type == kF32) return matching_sums<__half, float>(rec, data, n, partials, sums, s);
  if (rec_type == kF32 && data_type == kBF16) return matching_sums<float, __nv_bfloat16>(rec, data, n, partials, sums, s);
  if (rec_type == kF64 && data_type == kF64) return matching_sums<double, double>(rec, data, n, partials, sums, s);
  return (int)cudaErrorNotSupported;
}

// B2's cosine backward for (self, other) of B1's pairs (the gradient with respect to rec);
// out in self's type, sums and g in its accumulation type.
extern "C" int b2_cosine_backward_typed(int self_type, int other_type, const void* sums, const void* g,
                                        const void* self, const void* other, void* out, int64_t rows, int64_t n,
                                        int wrt_data, void* stream) {
  if (rows < 1 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = as_stream(stream);
#define BREACHING_COS(S, O) return cosine_backward<S, O>(sums, g, self, other, out, rows, n, wrt_data, s)
  if (self_type == kBF16 && other_type == kF32) BREACHING_COS(__nv_bfloat16, float);
  if (self_type == kF16 && other_type == kF32) BREACHING_COS(__half, float);
  if (self_type == kF32 && other_type == kBF16) BREACHING_COS(float, __nv_bfloat16);
  if (self_type == kF64 && other_type == kF64) BREACHING_COS(double, double);
#undef BREACHING_COS
  return (int)cudaErrorNotSupported;
}

// B2's axpby for (x, y) in (f64, f64) and (f32, bf16): `fused-euclidean`'s backward under
// case.impl.dtype float64 and bfloat16; out in x's type, a and b in its accumulation type.
extern "C" int b2_axpby_typed(int x_type, int y_type, const void* a, const void* x, const void* b, const void* y,
                              void* out, int64_t n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = as_stream(stream);
  if (x_type == kF32 && y_type == kBF16) return axpby<float, __nv_bfloat16>(a, x, b, y, out, n, s);
  if (x_type == kF64 && y_type == kF64) return axpby<double, double>(a, x, b, y, out, n, s);
  return (int)cudaErrorNotSupported;
}

// Bytes of the partial sums that b3_tv_value_and_grad_typed takes for `segments`
// segments of n elements: one accumulation-type value per block.
extern "C" int64_t b3_tv_partials_bytes(int type, int64_t n, int segments) {
  if (segments < 1) return -1;
  const int64_t per = n / segments;
  if (type == kF64) return (int64_t)segments * tv_blocks_per_segment<double>(per, segments) * (int64_t)sizeof(double);
  return (int64_t)segments * tv_blocks_per_segment<float>(per, segments) * (int64_t)sizeof(float);
}

// B3's fused value and gradient on f64 or bf16 images; scale, values and grad in the
// images' type.
extern "C" int b3_tv_value_and_grad_typed(int type, const void* x, const void* scale, int64_t n, int H, int W,
                                          int segments, double p, double q, double eps, void* partials, void* values,
                                          void* grad, void* stream) {
  if (segments < 1 || n % segments != 0 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = as_stream(stream);
  if (type == kF64) return tv_value_and_grad<double>(x, scale, n, H, W, segments, p, q, eps, partials, values, grad, s);
  if (type == kBF16)
    return tv_value_and_grad<__nv_bfloat16>(x, scale, n, H, W, segments, p, q, eps, partials, values, grad, s);
  return (int)cudaErrorNotSupported;
}

// B4's clamp on f64 or bf16 images, bounds in their type; out may be x.
extern "C" int b4_box_project_typed(int type, const void* x, const void* lo, const void* hi, void* out, int64_t n,
                                    int64_t hw, int channels, void* stream) {
  if (n < 0 || hw < 1 || channels < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = as_stream(stream);
  if (type == kF64) return box_project<double>(x, lo, hi, out, n, hw, channels, s);
  if (type == kBF16) return box_project<__nv_bfloat16>(x, lo, hi, out, n, hw, channels, s);
  return (int)cudaErrorNotSupported;
}

// B4's fused Adam step on f64 or bf16 candidates: x, grad, mu, nu, best, lo and hi in
// the candidate's type, values and best values in its accumulation type. scalars =
// (lr, b1, b2, eps, bias1, bias2, soft_scale, soft_div); flags as b4_adam_box_step's.
extern "C" int b4_adam_box_step_typed(int type, void* x, const void* grad, void* mu, void* nu, void* best,
                                      const void* lo, const void* hi, const void* values, const void* best_vals,
                                      void* new_best_vals, int64_t trials, int64_t per, int64_t hw, int channels,
                                      const double* scalars, int flags, void* stream) {
  if (trials < 1 || per < 1 || hw < 1 || channels < 1 || per % (hw * channels) != 0 || best_vals == new_best_vals ||
      (flags & 5) == 5)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = as_stream(stream);
  if (type == kF64)
    return adam_box_step<double>(x, grad, mu, nu, best, lo, hi, values, best_vals, new_best_vals, trials, per, hw,
                                 channels, scalars, flags, s);
  if (type == kBF16)
    return adam_box_step<__nv_bfloat16>(x, grad, mu, nu, best, lo, hi, values, best_vals, new_best_vals, trials, per,
                                        hw, channels, scalars, flags, s);
  return (int)cudaErrorNotSupported;
}
