// Image-space kernels of the attack step, on NCHW float32 batches.
//
// B3 `b3_tv_forward` replaces breaching_tpu/ops/image.py `fused_total_variation`
// (Pallas `_tv_kernel`): sum over pixels of ((|dx|+eps)^p + (|dy|+eps)^p)^q divided
// by the element count, with forward differences along W (dx) and H (dy) and the
// last column's dx and last row's dy set to 0. Bound: 4 bytes read per element,
// 4 n / 3.35 TB/s (3.7 ns for one 3x32x32 image), far below a launch: the kernel
// is one block-reduction pass like B1, and its cost is the two launches.
//
// `b3_tv_value_and_grad` is B3 rebuilt for the attack step, which needs the TV's
// value and its gradient together: one launch gives both, the value times a scale
// held on the device and the gradient the JAX package computes in regularizers.py
// `_tv_p1q1_bwd` and `_make_tv_general` (the TPU kernel has none): the divergence
// of the field g_x = q (px+py)^(q-1) p (|dx|+eps)^(p-1) sign(dx) (and g_y alike),
// times scale / element count. Bound: 8 bytes per element, 8 n / 3.35 TB/s (0.0073
// us for one 3x32x32 image, 0.36 us at 1x3x224x224), far below a launch, so the
// design aims at one launch that reads each element once:
// - a block of 256 threads takes a 16x16 tile of one H x W plane, one output per
//   thread, and loads it with a one-pixel halo on every side (18x18 floats, 1.3 KB
//   of shared memory), each element once, every thread's loads in flight together.
//   The work is a chain of latencies, not of bytes: 16x16 tiles give the slice's
//   3x32x32 batch 12 blocks where 32x32 tiles give 3, each with a quarter of the
//   work to do in turn; on the card they were faster at that shape and as fast at
//   1x3x224x224 (588 blocks, one wave).
//   The halo wraps as the JAX VJP's rolls do, and the boundary terms are multiplied
//   by the 0/1 mask, never selected away, so a NaN at the edge reaches the gradient
//   where the rolls carry it, and signed zeros come out as in the plain version. At
//   p = q = 1 the field is `_tv_p1q1_bwd`'s, the sign of the unmasked difference
//   times the mask, so an infinite wrapped difference gives 0 there as in the JAX
//   regularizer (the general form, (d * mask) first, gives NaN);
// - the field is computed once per position into shared memory, over the tile's
//   17x17 positions, then each output takes its divergence from there;
// - the same pass sums the tile's own value terms, whose boundary differences are
//   x - x as jnp.diff(..., append=) forms them (0, or NaN for a pixel that is not
//   finite), not the wrapped ones;
// - the cross-block sum needs no second launch: each block writes its partial,
//   fences and draws a ticket from an integer counter; the block that draws the
//   last one adds the partials in a fixed order (no float atomics: the same bits
//   every run), writes the value and sets the counter back to 0, which keeps it
//   right under CUDA-graph replay. The counter and the partials live in a
//   workspace that the wrapper keeps per device and stream.
// No tensor-core product (wgmma) has work in a stencil; a TMA tile load would do
// for the 1.3 KB tile what the block's coalesced loads do. Every product and sum is
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn: no fused multiply-add), with
// IEEE square root, in the plain version's order, so for exponents p, p-1, q and
// q-1 in cheap_pow's set (0, 0.5, 1, 1.5, 2) the gradient equals the plain
// version's bit for bit; other exponents go through powf.
//
// B4 `b4_box_project` replaces `box_project` (Pallas `_box_kernel`): clamps each
// element to its channel's [lo, hi]; the channel is dim 1 of NCHW. Bound: 8 bytes
// per element. 16-byte vector loads with a masked tail. A NaN input stays NaN, as
// with torch.clamp.
//
// `b4_adam_box_step` is B4 rebuilt as the attack step's whole tail. The JAX package
// never runs its box kernel in the attack: it clips with jnp.clip inside the
// optimizer update (breaching_tpu/attacks/optimization_based_attack.py:206-217), and
// XLA fuses the sign (:401), optax.adam's update and apply_updates (:456-457), the
// clip (:459), the finite guard and the best-iterate update (:460-466) into one pass.
// This kernel is that pass: one launch in place of about 23 eager launches. It
// reads x, g, mu and nu and writes x, mu, nu and, when the loss improved, best, in
// place: each element is read and written by one thread only. Bound: at most 32
// bytes per element, 32 n / 3.35 TB/s (0.029 us for one 3x32x32 image, a single
// wave of 12 blocks), far below a launch, so the design has one aim: one launch,
// each operand read once and written once. No tensor-core product (wgmma), bulk copy (TMA) or shared memory has work
// here. Arithmetic follows optax's order with each product and sum rounded on its
// own (__fmul_rn / __fadd_rn, never contracted into a fused multiply-add) and IEEE
// division and square root, so it equals the plain PyTorch sequence bit for bit.
// The step's new best value goes to a second buffer: were blocks to read and write
// one buffer, a block that wrote first would change what the others compare with.
#include "reduce.cuh"

namespace breaching {

// x^e without transcendentals for the exponents the configs use
// (breaching_tpu/attacks/auxiliaries/regularizers.py `_cheap_pow`), each rounding
// on its own as PyTorch's separate kernels round it.
__device__ __forceinline__ float cheap_pow(float x, float e) {
  if (e == 0.0f) return 1.0f;
  if (e == 1.0f) return x;
  if (e == 2.0f) return __fmul_rn(x, x);
  if (e == 0.5f) return __fsqrt_rn(x);
  if (e == 1.5f) return __fmul_rn(x, __fsqrt_rn(x));
  return powf(x, e);
}

// jnp.sign: +-1, and NaN and +-0 kept as they are.
__device__ __forceinline__ float sign_of(float d) { return d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : d); }

struct TVParams {
  int H, W;
  float p, q, eps;
};

// Masked forward differences at (h, w) of one H x W plane, the last column's dx and
// the last row's dy 0 (Pallas `_tv_kernel` concatenates zeros there).
__device__ __forceinline__ void diffs(const float* __restrict__ plane, int h, int w, const TVParams& t,
                                      float& dx, float& dy) {
  const float c = plane[h * t.W + w];
  dx = (w < t.W - 1) ? plane[h * t.W + w + 1] - c : 0.0f;
  dy = (h < t.H - 1) ? plane[(h + 1) * t.W + w] - c : 0.0f;
}

// The TV integrand at one pixel from its two differences: ((|dx|+eps)^p + (|dy|+eps)^p)^q.
__device__ __forceinline__ float tv_term(float dx, float dy, const TVParams& t) {
  const float px = cheap_pow(__fadd_rn(fabsf(dx), t.eps), t.p);
  const float py = cheap_pow(__fadd_rn(fabsf(dy), t.eps), t.p);
  return cheap_pow(__fadd_rn(px, py), t.q);
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
    v[0] += tv_term(dx, dy, t);
  }
  block_sum<1>(v);
  if (threadIdx.x == 0) partials[blockIdx.x] = v[0];
}

constexpr int kTile = 16;                  // outputs per tile side
constexpr int kHalo = kTile + 2;           // loaded per side: the tile and a one-pixel halo
constexpr int kField = kTile + 1;          // field positions per side: the tile and its left/top halo
constexpr int kRows = kThreads / kTile;    // a block is kTile columns by kRows rows of threads
constexpr int kLoads = (kHalo + kRows - 1) / kRows;  // halo rows each thread loads

// i mod n for i >= -1; the modulo runs only past the plane's far edge.
__device__ __forceinline__ int wrap(int i, int n) {
  if (i < 0) i += n;
  return i < n ? i : i % n;
}

// One component of the gradient field: outer p (|d|+eps)^(p-1) sign(d) mask.
__device__ __forceinline__ float field(float outer, float a, float d, float mask, const TVParams& t) {
  return __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(outer, t.p), cheap_pow(a, t.p - 1.0f)), sign_of(d)), mask);
}

// The workspace: the ticket counter, then one partial sum per block.
struct TVWorkspace {
  unsigned int counter;
  float partials[kMaxReduceBlocks];
};

__global__ void __launch_bounds__(kThreads)
tv_value_and_grad_kernel(const float* __restrict__ x, const float* __restrict__ scale_ptr, int64_t n,
                         TVParams t, int tiles_per_plane, int tiles_w, int num_tiles,
                         TVWorkspace* __restrict__ ws, float* __restrict__ value,
                         float* __restrict__ grad) {
  __shared__ float tile[kHalo][kHalo];
  __shared__ float gx[kField][kField];
  __shared__ float gy[kField][kField];
  __shared__ bool last_block;
  const int lane = threadIdx.x % kTile;
  const int row0 = threadIdx.x / kTile;
  const float scale = *scale_ptr;
  const float s = __fdiv_rn(scale, (float)n);
  const bool p1q1 = t.p == 1.0f && t.q == 1.0f;
  const int64_t hw = (int64_t)t.H * t.W;
  float v[1] = {0.0f};
  for (int id = blockIdx.x; id < num_tiles; id += gridDim.x) {
    const int plane = id / tiles_per_plane;
    const int r = id - plane * tiles_per_plane;
    const int h0 = r / tiles_w * kTile;
    const int w0 = (r % tiles_w) * kTile;
    const float* in = x + plane * hw;
    // tile[i][j] = x[(h0 - 1 + i) mod H][(w0 - 1 + j) mod W]: the rolls' wrap. Each
    // thread issues all its loads before it stores any, so they are in flight together.
    const int col0 = wrap(w0 - 1 + lane, t.W);
    const int col1 = lane < kHalo - kTile ? wrap(w0 - 1 + kTile + lane, t.W) : 0;
    float near[kLoads], far[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int i = row0 + k * kRows;
      if (i < kHalo) {
        const float* line = in + (int64_t)wrap(h0 - 1 + i, t.H) * t.W;
        near[k] = line[col0];
        if (lane < kHalo - kTile) far[k] = line[col1];
      }
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int i = row0 + k * kRows;
      if (i < kHalo) {
        tile[i][lane] = near[k];
        if (lane < kHalo - kTile) tile[i][kTile + lane] = far[k];
      }
    }
    __syncthreads();
    // the field at (h0 - 1 + i, w0 - 1 + j); the masks follow the wrapped index
    for (int i = row0; i < kField; i += kRows) {
      const float row = wrap(h0 - 1 + i, t.H) < t.H - 1 ? 1.0f : 0.0f;
      for (int j = lane; j < kField; j += kTile) {
        const float col = wrap(w0 - 1 + j, t.W) < t.W - 1 ? 1.0f : 0.0f;
        const float c = tile[i][j];
        const float dx_raw = __fsub_rn(tile[i][j + 1], c);
        const float dy_raw = __fsub_rn(tile[i + 1][j], c);
        if (p1q1) {  // _tv_p1q1_bwd: the sign of the unmasked difference, masked
          gx[i][j] = __fmul_rn(sign_of(dx_raw), col);
          gy[i][j] = __fmul_rn(sign_of(dy_raw), row);
          continue;
        }
        const float dx = __fmul_rn(dx_raw, col);
        const float dy = __fmul_rn(dy_raw, row);
        const float ax = __fadd_rn(fabsf(dx), t.eps);
        const float ay = __fadd_rn(fabsf(dy), t.eps);
        const float outer =
            __fmul_rn(t.q, cheap_pow(__fadd_rn(cheap_pow(ax, t.p), cheap_pow(ay, t.p)), t.q - 1.0f));
        gx[i][j] = field(outer, ax, dx, col, t);
        gy[i][j] = field(outer, ay, dy, row, t);
      }
    }
    __syncthreads();
    const int w = w0 + lane;
    for (int i = row0; i < kTile && h0 + i < t.H && w < t.W; i += kRows) {
      const int h = h0 + i;
      // (roll(gx, 1) - gx) + (roll(gy, 1) - gy), times scale / n
      const float div = __fadd_rn(__fsub_rn(gx[i + 1][lane], gx[i + 1][lane + 1]),
                                  __fsub_rn(gy[i][lane + 1], gy[i + 1][lane + 1]));
      grad[plane * hw + (int64_t)h * t.W + w] = __fmul_rn(div, s);
      // the value's differences: x - x at the last column and row, as diff(append=) forms them
      const float c = tile[i + 1][lane + 1];
      const float dx = __fsub_rn(w < t.W - 1 ? tile[i + 1][lane + 2] : c, c);
      const float dy = __fsub_rn(h < t.H - 1 ? tile[i + 2][lane + 1] : c, c);
      v[0] += tv_term(dx, dy, t);
    }
    __syncthreads();  // the next tile overwrites shared memory
  }
  block_sum<1>(v);
  if (threadIdx.x == 0) {
    ws->partials[blockIdx.x] = v[0];
    __threadfence();  // the partial is visible before the ticket is drawn
    last_block = atomicAdd(&ws->counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  float total[1] = {0.0f};
  for (int b = threadIdx.x; b < gridDim.x; b += kThreads) total[0] += __ldcg(&ws->partials[b]);
  block_sum<1>(total);
  if (threadIdx.x == 0) {
    *value = __fmul_rn(__fdiv_rn(total[0], (float)n), scale);
    ws->counter = 0u;
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

struct AdamParams {
  float lr, one_minus_b1, b1, one_minus_b2, b2, eps, bias1, bias2;
};

__global__ void __launch_bounds__(kThreads)
adam_box_step_kernel(float* __restrict__ x, const float* __restrict__ grad, float* __restrict__ mu,
                     float* __restrict__ nu, float* __restrict__ best, const float* __restrict__ lo,
                     const float* __restrict__ hi, const float* __restrict__ value,
                     const float* __restrict__ best_val, float* __restrict__ new_best_val, int64_t n,
                     int64_t hw, int channels, AdamParams a, bool is_signed, bool boxed) {
  const float v = *value;
  const float bv = *best_val;
  const bool finite = isfinite(v);
  const bool improved = finite && v < bv;
  if (blockIdx.x == 0 && threadIdx.x == 0) *new_best_val = improved ? v : bv;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const float x0 = x[i];
    const float g = is_signed ? sign_of(grad[i]) : grad[i];
    const float m = __fadd_rn(__fmul_rn(a.one_minus_b1, g), __fmul_rn(a.b1, mu[i]));
    const float s = __fadd_rn(__fmul_rn(a.one_minus_b2, __fmul_rn(g, g)), __fmul_rn(a.b2, nu[i]));
    mu[i] = m;
    nu[i] = s;
    const float u = __fdiv_rn(__fdiv_rn(m, a.bias1), __fadd_rn(__fsqrt_rn(__fdiv_rn(s, a.bias2)), a.eps));
    float x1 = __fadd_rn(x0, __fmul_rn(-a.lr, u));
    if (boxed) {
      const int c = (int)((i / hw) % channels);
      x1 = clamp1(x1, lo[c], hi[c]);
    }
    if (improved) best[i] = x0;
    x[i] = finite ? x1 : x0;
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

// value[0] = TV of the NCHW batch x (n = N*C*H*W elements) times scale[0], and grad =
// its gradient times scale[0]. `workspace` is a zeroed TVWorkspace (1 + 1024 4-byte words) that
// only this stream uses; the kernel leaves its counter at 0.
extern "C" int b3_tv_value_and_grad(const float* x, const float* scale, int64_t n, int H, int W,
                                    float p, float q, float eps, void* workspace, float* value,
                                    float* grad, void* stream) {
  if (n < 1 || H < 1 || W < 1 || n % ((int64_t)H * W) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TVParams t{H, W, p, q, eps};
  const int tiles_w = (W + kTile - 1) / kTile;
  const int64_t tiles_per_plane = (int64_t)((H + kTile - 1) / kTile) * tiles_w;
  const int64_t num_tiles = n / ((int64_t)H * W) * tiles_per_plane;
  if (num_tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (int)(num_tiles < kMaxReduceBlocks ? num_tiles : kMaxReduceBlocks);
  tv_value_and_grad_kernel<<<grid, kThreads, 0, s>>>(x, scale, n, t, (int)tiles_per_plane, tiles_w,
                                                     (int)num_tiles, static_cast<TVWorkspace*>(workspace),
                                                     value, grad);
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

// One attack step on the NCHW candidate x (n elements, `channels` channels of hw
// pixels), in place on x, mu, nu and best; new_best_val[0] gets the step's best value.
// flags: bit 0 takes the gradient's sign, bit 1 clamps to [lo[c], hi[c]].
extern "C" int b4_adam_box_step(float* x, const float* grad, float* mu, float* nu, float* best,
                                const float* lo, const float* hi, const float* value,
                                const float* best_val, float* new_best_val, int64_t n, int64_t hw,
                                int channels, float lr, float one_minus_b1, float b1,
                                float one_minus_b2, float b2, float eps, float bias1, float bias2,
                                int flags, void* stream) {
  if (n < 1 || hw < 1 || channels < 1 || best_val == new_best_val) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AdamParams a{lr, one_minus_b1, b1, one_minus_b2, b2, eps, bias1, bias2};
  adam_box_step_kernel<<<grid_for(n, 1, 8192), kThreads, 0, s>>>(
      x, grad, mu, nu, best, lo, hi, value, best_val, new_best_val, n, hw, channels, a,
      (flags & 1) != 0, (flags & 2) != 0);
  return (int)cudaGetLastError();
}
