// Image-space kernels of the attack step, on NCHW float32 batches.
//
// B3 `b3_tv_forward` replaces breaching_tpu/ops/image.py `fused_total_variation`
// (Pallas `_tv_kernel`): sum over pixels of ((|dx|+eps)^p + (|dy|+eps)^p)^q divided
// by the element count, with forward differences along W (dx) and H (dy), the last
// column's dx and last row's dy x - x (0, or NaN for a pixel that is not finite). Bound:
// 4 bytes read per element, 4 n / 3.35 TB/s (3.7 ns for one 3x32x32 image), far below a
// launch. It is the value-only form of the fused kernel below (kGrad = false): the same
// tiles, the same one wave and the same sum across blocks through flagged slots, in one
// launch, with no gradient pass and no store but the value.
//
// `b3_tv_value_and_grad` is B3 rebuilt for the attack step, which needs the TV's
// value and its gradient together: one launch gives both, the value times a scale
// held on the device and the gradient the JAX package computes in regularizers.py
// `_tv_p1q1_bwd` and `_make_tv_general` (the TPU kernel has none): the divergence
// of the field g_x = q (px+py)^(q-1) p (|dx|+eps)^(p-1) sign(dx) (and g_y alike),
// times scale / element count. One launch also takes T trials stacked as segments of
// the batch, each with its own value (the mean over its own elements). It is called
// through PyTorch's dispatcher (csrc/bindings.cpp). Bound: 8 bytes per element,
// 8 n / 3.35 TB/s (0.0073 us for one 3x32x32 image, 1.44 us at 4x3x224x224), far
// below a launch, so the design aims at one short chain of latencies per launch:
// - one wave and no rounds: the grid is the occupancy API's blocks per SM times the
//   SM count, shared among the segments, at most one block per tile. A block of 128
//   threads takes a 32 x 32 tile (4x3x224x224: 588 tiles; 100x3x32x32: 300), and each
//   thread walks 8 rows of one column with a register window: the field's y
//   component at one row is the next row's upper neighbour. Where a block owns more
//   than one tile, the next one's copy into a second buffer (cp.async) runs while the
//   current one is computed, so the block waits on one cold load, not one per tile;
// - one shared tile with its one-pixel halo (34 x 34 floats), one __syncthreads per
//   tile. The halo wraps as the JAX VJP's rolls do, which a TMA box cannot express at
//   the plane's edges, and a 4.6 KB tile is copied by the block's own 4-byte
//   cp.async as fast as a bulk copy would be; so no TMA. The boundary terms are
//   multiplied by the 0/1 mask, never selected away, so a NaN at the edge reaches the
//   gradient where the rolls carry it, and signed zeros come out as in the plain
//   version. At p = q = 1 the field is `_tv_p1q1_bwd`'s, the sign of the unmasked
//   difference times the mask, so an infinite wrapped difference gives 0 there as in
//   the JAX regularizer (the general form, (d * mask) first, gives NaN). Each output
//   forms the two field positions it reads (its own and its left neighbour's) from
//   the tile: at these sizes arithmetic is not what the kernel waits on;
// - the value terms come from the same tile, their boundary differences x - x as
//   jnp.diff(..., append=) forms them (0, or NaN for a pixel that is not finite), not
//   the wrapped ones;
// - the cross-block sum needs no second launch, per segment: each block sums a tile's
//   value terms first and stores one partial per tile it took (per run of tiles, past
//   16,384 tiles a launch) into a slot, with a flag in the same 64-bit store; the
//   segment's first block, once its own tiles are done, reads each slot until its flag
//   shows, adds the partials in the tiles' order (no float atomics: the same bits every
//   run, on any grid, so a trial's value in the batched form equals its own call's),
//   empties the slots and writes the value, which keeps the workspace right under
//   CUDA-graph replay. The tail is one round trip to L2, where a ticket counter takes
//   three (a release fence, the atomic, the last block's reads) and queues hundreds of
//   blocks on one address. The slots live in a workspace that the wrapper keeps per
//   device and stream.
// No tensor-core product (wgmma) has work in a stencil. Every product and sum is
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn: no fused multiply-add), with
// IEEE square root, in the plain version's order, so for exponents p, p-1, q and
// q-1 in cheap_pow's set (0, 0.5, 1, 1.5, 2, and -0.5 as rsqrtf, which is what
// PyTorch's CUDA pow(x, -0.5) computes) the gradient equals the plain version's on the
// card bit for bit; other exponents go through powf.
//
// B4 `b4_box_project` replaces `box_project` (Pallas `_box_kernel`): clamps each
// element to its channel's [lo, hi]; the channel is dim 1 of NCHW. A NaN input stays
// NaN, as with torch.clamp. Bound: 8 bytes per element, 8 n / 3.35 TB/s (0.0073 us at
// the path's 1x3x32x32, 12 KB), a thousandth of a launch: what the call costs is the
// host's work and the launch's latency, not bytes. So the kernel is one wave with one
// float4 per thread: 32-bit index arithmetic whenever n < 2^30 (an index
// plus the grid's stride then stays within 32 bits), the
// channel found once per float4 where hw % 4 == 0 (the four lie in one channel; at
// other widths, or off a 16-byte boundary, one element per thread), the bounds read
// once per thread, independent of the load of x. Beyond one wave a grid-stride loop
// takes the rest. Shared memory, a tensor-core product (wgmma) or a TMA copy have no
// work in a 12 KB clamp: each element is read once and written once by one thread.
// x and out may be one buffer (the wrapper's in-place form): each thread reads its
// elements before it writes them, and neither pointer is __restrict__.
//
// `b4_adam_box_step` is B4 rebuilt as the attack step's whole tail. The JAX package
// never runs its box kernel in the attack: it clips with jnp.clip inside the
// optimizer update (breaching_tpu/attacks/optimization_based_attack.py:206-217), and
// XLA fuses the sign (:401), optax.adam's update and apply_updates (:456-457), the
// clip (:459), the finite guard and the best-iterate update (:460-466) into one pass,
// vmapped over the trials (:487-532). This kernel is that pass for every trial at once:
// T candidates stacked (T, N, C, H, W), each with its own loss, best value and best
// iterate, in one launch. It reads x, g, mu and nu and writes x, mu, nu and, where the
// trial's loss improved, best, in place: each element is read and written by one
// thread only. Bound: at most 32 bytes per element, 32 n / 3.35 TB/s: 0.029 us at
// 1x3x32x32, 5.75 us at 4x3x224x224, 11.50 us at 8x1x3x224x224 (the fleet). The design
// is about bytes in flight and one wave:
// - one float4 a thread where the five tensors are 16-byte aligned and a plane's
//   H*W is a multiple of 4, so that a float4 lies in one channel of one trial and its
//   channel is found once (a scalar form for the rest); 32-bit indices below 2^30
//   elements a trial;
// - one wave from the occupancy API, shared among the trials: a trial's blocks are
//   consecutive, so each thread reads its trial's loss and best value once, and the
//   trial's first block writes its new best value. Beyond one wave a grid-stride loop
//   issues the loads of kAdamUnroll iterations before their arithmetic;
// - the gradient is read evict-first (__ldcs): nothing reads it again. x, mu and nu
//   are stored normally: the next step reads them.
// No tensor-core product (wgmma), bulk copy (TMA) or shared memory has work here:
// each element is read once and written once by one thread, and nothing is a tile
// read twice. Arithmetic follows optax's order with each product and sum rounded on
// its own (__fmul_rn / __fadd_rn, never contracted into a fused multiply-add) and IEEE
// division and square root, so it equals the plain PyTorch sequence bit for bit, and
// each trial of a stack equals its own single call.
// The step's new best value goes to a second buffer: were blocks to read and write
// one buffer, a block that wrote first would change what the others compare with.
// Its soft-sign mode (the `modern` and `legacy` presets) takes tanh(g s) / max(s, 1e-3)
// in place of the sign, as the JAX package's transform_grads does
// (optimization_based_attack.py:397-399), with s = 1 - iteration / max_iterations and
// max(s, 1e-3) formed on the host in float32. tanhf need not round as PyTorch's tanh
// does, so that mode agrees with the plain version to a stated tolerance, not bit for
// bit; the product and the quotient are rounded on their own as before.
//
// Every kernel here is called through PyTorch's dispatcher (csrc/bindings.cpp), which
// checks the tensors and allocates outputs and scratch in C++.
#include <cuda/atomic>
#include <cuda_pipeline.h>

#include "reduce.cuh"

namespace breaching {

// powf out of line: each call site of cheap_pow costs a call, not a copy of powf's body
// (many copies of it made the unrolled TV kernel too large for the instruction cache).
__device__ __noinline__ float pow_call(float x, float e) { return powf(x, e); }

// x^e without transcendentals for the exponents the configs use
// (breaching_tpu/attacks/auxiliaries/regularizers.py `_cheap_pow`), each rounding
// on its own as PyTorch's separate kernels round it.
__device__ __forceinline__ float cheap_pow(float x, float e) {
  if (e == 0.0f) return 1.0f;
  if (e == 1.0f) return x;
  if (e == 2.0f) return __fmul_rn(x, x);
  if (e == 0.5f) return __fsqrt_rn(x);
  if (e == 1.5f) return __fmul_rn(x, __fsqrt_rn(x));
  if (e == -0.5f) return rsqrtf(x);  // PyTorch's CUDA pow(x, -0.5) is its rsqrt kernel, rsqrtf
  return pow_call(x, e);
}

// jnp.sign: +-1, and NaN and +-0 kept as they are.
__device__ __forceinline__ float sign_of(float d) { return d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : d); }

struct TVParams {
  int H, W;
  float p, q, eps;
};

// The TV integrand at one pixel from its two differences: ((|dx|+eps)^p + (|dy|+eps)^p)^q.
__device__ __forceinline__ float tv_term(float dx, float dy, const TVParams& t) {
  const float px = cheap_pow(__fadd_rn(fabsf(dx), t.eps), t.p);
  const float py = cheap_pow(__fadd_rn(fabsf(dy), t.eps), t.p);
  return cheap_pow(__fadd_rn(px, py), t.q);
}

// The fused TV kernel's geometry: a block of kTvWarps warps takes a tile of kTvCols
// columns (one a lane) by kTvRows rows of one plane, and each thread walks
// kTvRowsPerWarp rows down its column.
constexpr int kTvCols = 32;
constexpr int kTvWarps = 4;
constexpr int kTvRowsPerWarp = 8;
constexpr int kTvRows = kTvWarps * kTvRowsPerWarp;
constexpr int kTvThreads = kTvWarps * 32;
constexpr int kTvMaxPartials = 16384;

// i mod n for i >= -1; the modulo runs only past the plane's far edge.
__device__ __forceinline__ int wrap(int i, int n) {
  if (i < 0) i += n;
  return i < n ? i : i % n;
}

// One component of the gradient field: outer p (|d|+eps)^(p-1) sign(d) mask.
__device__ __forceinline__ float field(float outer, float a, float d, float mask, const TVParams& t) {
  return __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(outer, t.p), cheap_pow(a, t.p - 1.0f)), sign_of(d)), mask);
}

// The gradient field (gx, gy) at a position holding c, with `right` and `below` its
// wrapped neighbours and col, row its 0/1 masks. At p = q = 1 it is `_tv_p1q1_bwd`'s,
// the sign of the unmasked difference, masked; else `_make_tv_general`'s, on the masked
// differences.
template <bool kP1Q1>
__device__ __forceinline__ void field_at(float c, float right, float below, float col, float row,
                                         const TVParams& t, float& gx, float& gy) {
  const float dx_raw = __fsub_rn(right, c);
  const float dy_raw = __fsub_rn(below, c);
  if (kP1Q1) {
    gx = __fmul_rn(sign_of(dx_raw), col);
    gy = __fmul_rn(sign_of(dy_raw), row);
    return;
  }
  const float dx = __fmul_rn(dx_raw, col);
  const float dy = __fmul_rn(dy_raw, row);
  const float ax = __fadd_rn(fabsf(dx), t.eps);
  const float ay = __fadd_rn(fabsf(dy), t.eps);
  const float outer =
      __fmul_rn(t.q, cheap_pow(__fadd_rn(cheap_pow(ax, t.p), cheap_pow(ay, t.p)), t.q - 1.0f));
  gx = field(outer, ax, dx, col, t);
  gy = field(outer, ay, dy, row, t);
}

// The workspace: one slot per chunk of tiles for its partial sum, (1 << 32 | the
// partial's bits) once written and 0 once read.
struct TVWorkspace {
  unsigned long long partials[kTvMaxPartials];
};

// How the grid covers the batch: each segment's planes are cut into `tiles` tiles,
// grouped into `chunks` runs of `chunk` consecutive tiles (one, unless the batch has
// more tiles than the workspace has partials), and a segment's `blocks` blocks take its
// chunks in turn (chunk k to block k mod blocks).
struct TVGrid {
  int tiles_w, tiles_per_plane, planes, tiles, chunk, chunks, blocks;
};

typedef float TVTile[kTvRows + 2][kTvCols + 2];

// Issues the asynchronous copies of one tile and its one-pixel halo:
// tile[i][j] = plane[(h0 - 1 + i) mod H][(w0 - 1 + j) mod W], the rolls' wrap. Lane l
// copies column w0 + l of each of its warp's rows; lanes 0 and 1 the two halo columns.
__device__ __forceinline__ void load_tile(TVTile& tile, const float* plane, int h0, int w0, const TVParams& t,
                                          int lane, int warp) {
  const int col = wrap(w0 + lane, t.W);
  const int side = wrap(lane == 0 ? w0 - 1 : w0 + kTvCols, t.W);
  for (int i = warp; i < kTvRows + 2; i += kTvWarps) {
    const float* line = plane + (int64_t)wrap(h0 - 1 + i, t.H) * t.W;
    __pipeline_memcpy_async(&tile[i][lane + 1], line + col, sizeof(float));
    if (lane < 2) __pipeline_memcpy_async(&tile[i][lane == 0 ? 0 : kTvCols + 1], line + side, sizeof(float));
  }
  __pipeline_commit();
}

// kGrad = false is b3_tv_forward: the value alone, unscaled (scale_ptr and grad unused).
template <bool kP1Q1, bool kGrad>
__global__ void __launch_bounds__(kTvThreads)
tv_value_and_grad_kernel(const float* __restrict__ x, const float* __restrict__ scale_ptr, TVParams t, TVGrid g,
                         int64_t n_segment, TVWorkspace* __restrict__ ws, float* __restrict__ values,
                         float* __restrict__ grad) {
  __shared__ TVTile tiles[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int segment = blockIdx.x / g.blocks;
  const int first = blockIdx.x - segment * g.blocks;
  const float scale = kGrad ? *scale_ptr : 1.0f;
  const float s = __fdiv_rn(scale, (float)n_segment);
  const int64_t hw = (int64_t)t.H * t.W;
  // tile k of the segment: its plane, top row and left column
  struct Place {
    int64_t plane;
    int h0, w0;
  };
  auto locate = [&](int k) {
    const int plane = k / g.tiles_per_plane;
    const int r = k - plane * g.tiles_per_plane;
    return Place{(int64_t)segment * g.planes + plane, r / g.tiles_w * kTvRows, (r % g.tiles_w) * kTvCols};
  };
  auto load = [&](const Place& place, TVTile& tile) {
    load_tile(tile, x + place.plane * hw, place.h0, place.w0, t, lane, warp);
  };
  Place here{0, 0, 0}, next{0, 0, 0};  // the tile computed now, and the one loading for the next round
  if (first < g.chunks) {
    here = locate(first * g.chunk);
    load(here, tiles[0]);
  }
  int buffer = 0;
  for (int chunk = first; chunk < g.chunks; chunk += g.blocks) {
    const int end = min((chunk + 1) * g.chunk, g.tiles);
    float v[1] = {0.0f};
    for (int k = chunk * g.chunk; k < end; ++k, buffer ^= 1, here = next) {
      __pipeline_wait_prior(0);
      __syncthreads();  // tile k has landed for every thread, and no thread still reads the other buffer
      // the next tile loads while this one is computed
      const int following = k + 1 < end ? k + 1 : chunk + g.blocks < g.chunks ? (chunk + g.blocks) * g.chunk : -1;
      if (following >= 0) {
        next = locate(following);
        load(next, tiles[buffer ^ 1]);
      }
      const int64_t plane = here.plane;
      const int h0 = here.h0, w0 = here.w0;
      const TVTile& tile = tiles[buffer];
      const int w = w0 + lane;
      const int top = h0 + warp * kTvRowsPerWarp;
      const bool owns = w < t.W && top < t.H;  // the thread has outputs in this tile
      const int j = lane + 1;
      const int i0 = 1 + warp * kTvRowsPerWarp;
      const int rows = owns ? min(kTvRowsPerWarp, t.H - top) : 0;
      // the value's terms first, whose differences are x - x at the last column and row,
      // as diff(append=) forms them
      auto value_row = [&](int r) {
        const float c = tile[i0 + r][j];
        const float dx = __fsub_rn(w < t.W - 1 ? tile[i0 + r][j + 1] : c, c);
        const float dy = __fsub_rn(top + r < t.H - 1 ? tile[i0 + r + 1][j] : c, c);
        v[0] += kP1Q1 ? __fadd_rn(__fadd_rn(fabsf(dx), t.eps), __fadd_rn(fabsf(dy), t.eps)) : tv_term(dx, dy, t);
      };
      // a full column of rows unrolled without branches, so that its shared loads are
      // issued together; a column cut by the plane's last row, and the general form's
      // (unrolled, its inlined exponent tests overflow the instruction cache: 25.5 us in
      // place of 11.2 at 1x6x224x224 on the H100), as a loop
      const bool unrolled = kP1Q1 && rows == kTvRowsPerWarp;
      if (unrolled) {
#pragma unroll
        for (int r = 0; r < kTvRowsPerWarp; ++r) value_row(r);
      } else {
        for (int r = 0; r < rows; ++r) value_row(r);
      }
      if (k == end - 1) {
        // one partial per chunk, in the order of the tiles: the value's bits do not depend
        // on the grid. Its slot takes it with a flag in one 64-bit store, which no fence
        // has to wait for.
        block_sum<1, kTvThreads>(v);
        if (threadIdx.x == 0) {
          cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> slot(
              ws->partials[(int64_t)segment * g.chunks + chunk]);
          slot.store(1ull << 32 | __float_as_uint(v[0]), cuda::memory_order_relaxed);
        }
      }
      if (!kGrad || !owns) continue;
      // the gradient: the masks follow the wrapped index, 0 at the last column and row
      // and at the column left of 0 and the row above 0, which wrap to them
      const float col = w < t.W - 1 ? 1.0f : 0.0f;
      const float col_left = w > 0 ? 1.0f : 0.0f;
      float* out = grad + (plane * t.H + top) * t.W + w;
      float unused, gy_up;  // gy one row up, carried down the column
      field_at<kP1Q1>(tile[i0 - 1][j], tile[i0 - 1][j + 1], tile[i0][j], col, top > 0 ? 1.0f : 0.0f, t, unused,
                      gy_up);
      auto grad_row = [&](int r) {
        const int i = i0 + r;
        const float row = top + r < t.H - 1 ? 1.0f : 0.0f;
        const float c = tile[i][j];
        float gx, gy, gx_left;
        field_at<kP1Q1>(c, tile[i][j + 1], tile[i + 1][j], col, row, t, gx, gy);
        field_at<kP1Q1>(tile[i][j - 1], c, tile[i + 1][j - 1], col_left, row, t, gx_left, unused);
        // (roll(gx, 1) - gx) + (roll(gy, 1) - gy), times scale / n
        out[(int64_t)r * t.W] = __fmul_rn(__fadd_rn(__fsub_rn(gx_left, gx), __fsub_rn(gy_up, gy)), s);
        gy_up = gy;
      };
      if (unrolled) {
#pragma unroll
        for (int r = 0; r < kTvRowsPerWarp; ++r) grad_row(r);
      } else {
        for (int r = 0; r < rows; ++r) grad_row(r);
      }
    }
  }
  // the segment's first block adds its partials: it reads each slot until the flag of the
  // block that stores it shows, and empties it for the next launch. Only blocks that wait
  // on nothing store into slots, so this wait ends, on one wave or several.
  if (first != 0) return;
  __syncthreads();  // this block's own partials, stored by thread 0, are visible to the block
  unsigned long long* partials = ws->partials + (int64_t)segment * g.chunks;
  float total[1] = {0.0f};
  constexpr int kReads = 4;  // slots a thread reads at once, so that their round trips overlap
  for (int k0 = threadIdx.x; k0 < g.chunks; k0 += kReads * kTvThreads) {
    unsigned long long bits[kReads];
#pragma unroll
    for (int u = 0; u < kReads; ++u) {
      const int k = k0 + u * kTvThreads;
      bits[u] = k < g.chunks ? cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(partials[k]).load(
                                   cuda::memory_order_relaxed)
                             : 0ull;
    }
#pragma unroll
    for (int u = 0; u < kReads; ++u) {
      const int k = k0 + u * kTvThreads;
      if (k >= g.chunks) break;
      cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> slot(partials[k]);
      while ((bits[u] >> 32) == 0) {
        __nanosleep(64);
        bits[u] = slot.load(cuda::memory_order_relaxed);
      }
      slot.store(0ull, cuda::memory_order_relaxed);
      total[0] += __uint_as_float((unsigned int)bits[u]);
    }
  }
  block_sum<1, kTvThreads>(total);
  if (threadIdx.x == 0) values[segment] = __fmul_rn(__fdiv_rn(total[0], (float)n_segment), scale);
}

__device__ __forceinline__ float clamp1(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One float4 per thread: hw4 = hw / 4 float4s per channel plane.
template <typename Index>
__global__ void __launch_bounds__(kThreads)
box_vec4_kernel(const float4* x, const float* __restrict__ lo, const float* __restrict__ hi, float4* out,
                Index n4, Index hw4, int channels) {
  const Index stride = (Index)gridDim.x * kThreads;
  for (Index i = (Index)blockIdx.x * kThreads + threadIdx.x; i < n4; i += stride) {
    const int c = (int)((i / hw4) % channels);
    const float l = __ldg(lo + c), h = __ldg(hi + c);
    const float4 v = x[i];
    out[i] = make_float4(clamp1(v.x, l, h), clamp1(v.y, l, h), clamp1(v.z, l, h), clamp1(v.w, l, h));
  }
}

// One element per thread, any width and alignment.
template <typename Index>
__global__ void __launch_bounds__(kThreads)
box_scalar_kernel(const float* x, const float* __restrict__ lo, const float* __restrict__ hi, float* out,
                  Index n, Index hw, int channels) {
  const Index stride = (Index)gridDim.x * kThreads;
  for (Index i = (Index)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int c = (int)((i / hw) % channels);
    out[i] = clamp1(x[i], __ldg(lo + c), __ldg(hi + c));
  }
}

template <typename Index>
void launch_box(const float* x, const float* lo, const float* hi, float* out, int64_t n, int64_t hw,
                int channels, cudaStream_t s) {
  // blocks beyond 8 per SM's worth of threads would wait for a second wave: loop instead
  constexpr int kMaxBlocks = 132 * 8;
  if (hw % 4 == 0 && aligned16(x) && aligned16(out)) {
    box_vec4_kernel<Index><<<grid_for(n / 4, 1, kMaxBlocks), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(x), lo, hi, reinterpret_cast<float4*>(out), (Index)(n / 4),
        (Index)(hw / 4), channels);
  } else {
    box_scalar_kernel<Index><<<grid_for(n, 1, kMaxBlocks), kThreads, 0, s>>>(x, lo, hi, out, (Index)n,
                                                                            (Index)hw, channels);
  }
}

struct AdamParams {
  float lr, one_minus_b1, b1, one_minus_b2, b2, eps, bias1, bias2;
  float soft_scale, soft_div;  // s and max(s, 1e-3) of the soft sign
};

enum SignMode { kUnsigned = 0, kHardSign = 1, kSoftSign = 2 };

// The step's tensors: T trials of `per` elements stacked, each trial with its own loss
// values[t], best value best_vals[t] and new best value new_best_vals[t].
struct AdamOperands {
  float* x;
  const float* grad;
  float* mu;
  float* nu;
  float* best;
  const float* lo;
  const float* hi;
  const float* values;
  const float* best_vals;
  float* new_best_vals;
};

// One element's step in optax's order: the sign, the moments (updated in place), the
// update, the box [l, h] and the finite guard; returns the element's new value.
template <SignMode kMode>
__device__ __forceinline__ float adam_element(float x0, float g, float& m, float& s, const AdamParams& a,
                                              bool boxed, float l, float h, bool finite) {
  const float gs = kMode == kHardSign   ? sign_of(g)
                   : kMode == kSoftSign ? __fdiv_rn(tanhf(__fmul_rn(g, a.soft_scale)), a.soft_div)
                                        : g;
  m = __fadd_rn(__fmul_rn(a.one_minus_b1, gs), __fmul_rn(a.b1, m));
  s = __fadd_rn(__fmul_rn(a.one_minus_b2, __fmul_rn(gs, gs)), __fmul_rn(a.b2, s));
  const float u = __fdiv_rn(__fdiv_rn(m, a.bias1), __fadd_rn(__fsqrt_rn(__fdiv_rn(s, a.bias2)), a.eps));
  float x1 = __fadd_rn(x0, __fmul_rn(-a.lr, u));
  if (boxed) x1 = clamp1(x1, l, h);
  return finite ? x1 : x0;
}

// A trial's loss and best value, read by each thread once, after its first loads of the
// tensors are issued: nothing is stored before those loads, so the two round trips
// overlap.
struct TrialStatus {
  float v = 0.0f, bv = 0.0f;
  bool finite = false, improved = false, read = false;

  __device__ __forceinline__ void fetch(const AdamOperands& o, int trial) {
    if (read) return;
    v = o.values[trial];
    bv = o.best_vals[trial];
    finite = isfinite(v);
    improved = finite && v < bv;
    read = true;
  }
};

constexpr int kAdamUnroll = 2;  // grid-stride iterations whose loads a thread issues together

// blocks_per_trial consecutive blocks take one trial; kVec: one float4 a thread, which
// lies in one channel (hw % 4 == 0) of one trial. The trial's first block writes its new
// best value last.
template <bool kVec, SignMode kMode, typename Index>
__global__ void __launch_bounds__(kThreads)
adam_box_step_kernel(AdamOperands o, Index per, Index hw, int channels, int blocks_per_trial, AdamParams a,
                     bool boxed) {
  const int trial = blockIdx.x / blocks_per_trial;
  const int block = blockIdx.x - trial * blocks_per_trial;
  const int64_t base = (int64_t)trial * per;
  float* __restrict__ x = o.x + base;
  const float* __restrict__ grad = o.grad + base;
  float* __restrict__ mu = o.mu + base;
  float* __restrict__ nu = o.nu + base;
  float* __restrict__ best = o.best + base;
  const Index stride = (Index)blocks_per_trial * kThreads;
  const Index tid = (Index)block * kThreads + threadIdx.x;
  TrialStatus st;
  if (kVec) {
    const Index n4 = per / 4, hw4 = hw / 4;
    float4* x4 = reinterpret_cast<float4*>(x);
    const float4* g4 = reinterpret_cast<const float4*>(grad);
    float4* m4 = reinterpret_cast<float4*>(mu);
    float4* s4 = reinterpret_cast<float4*>(nu);
    float4* b4 = reinterpret_cast<float4*>(best);
    for (Index start = tid; start < n4; start += kAdamUnroll * stride) {
      float4 xv[kAdamUnroll], gv[kAdamUnroll], mv[kAdamUnroll], sv[kAdamUnroll];
#pragma unroll
      for (int u = 0; u < kAdamUnroll; ++u) {
        const Index i = start + u * stride;
        if (i < n4) {
          xv[u] = x4[i];
          gv[u] = __ldcs(g4 + i);  // evict-first: nothing reads the gradient again
          mv[u] = m4[i];
          sv[u] = s4[i];
        }
      }
      st.fetch(o, trial);
#pragma unroll
      for (int u = 0; u < kAdamUnroll; ++u) {
        const Index i = start + u * stride;
        if (i < n4) {
          float l = 0.0f, h = 0.0f;
          if (boxed) {
            const int c = (int)((i / hw4) % channels);
            l = __ldg(o.lo + c);
            h = __ldg(o.hi + c);
          }
          const float4 x0 = xv[u];
          float4 x1;
          x1.x = adam_element<kMode>(x0.x, gv[u].x, mv[u].x, sv[u].x, a, boxed, l, h, st.finite);
          x1.y = adam_element<kMode>(x0.y, gv[u].y, mv[u].y, sv[u].y, a, boxed, l, h, st.finite);
          x1.z = adam_element<kMode>(x0.z, gv[u].z, mv[u].z, sv[u].z, a, boxed, l, h, st.finite);
          x1.w = adam_element<kMode>(x0.w, gv[u].w, mv[u].w, sv[u].w, a, boxed, l, h, st.finite);
          m4[i] = mv[u];
          s4[i] = sv[u];
          if (st.improved) b4[i] = x0;
          x4[i] = x1;
        }
      }
    }
  } else {
    for (Index start = tid; start < per; start += kAdamUnroll * stride) {
      float xv[kAdamUnroll], gv[kAdamUnroll], mv[kAdamUnroll], sv[kAdamUnroll];
#pragma unroll
      for (int u = 0; u < kAdamUnroll; ++u) {
        const Index i = start + u * stride;
        if (i < per) {
          xv[u] = x[i];
          gv[u] = __ldcs(grad + i);
          mv[u] = mu[i];
          sv[u] = nu[i];
        }
      }
      st.fetch(o, trial);
#pragma unroll
      for (int u = 0; u < kAdamUnroll; ++u) {
        const Index i = start + u * stride;
        if (i < per) {
          float l = 0.0f, h = 0.0f;
          if (boxed) {
            const int c = (int)((i / hw) % channels);
            l = __ldg(o.lo + c);
            h = __ldg(o.hi + c);
          }
          const float x1 = adam_element<kMode>(xv[u], gv[u], mv[u], sv[u], a, boxed, l, h, st.finite);
          mu[i] = mv[u];
          nu[i] = sv[u];
          if (st.improved) best[i] = xv[u];
          x[i] = x1;
        }
      }
    }
  }
  if (block == 0 && threadIdx.x == 0) {
    st.fetch(o, trial);
    o.new_best_vals[trial] = st.improved ? st.v : st.bv;
  }
}

}  // namespace breaching

using namespace breaching;

// The fused TV kernel's occupancy on the current device (the p = q = 1 form or the
// general one), and in `g` how its grid covers n elements of H x W planes in
// `segments` segments: the blocks of one wave, the lesser of the two forms', shared
// among the segments, at most one block per chunk. False for shapes it does not take.
static bool tv_launch(int64_t n, int H, int W, int segments, bool p1q1, TVGrid& g, Occupancy& o) {
  static Occupancy cache[2][kMaxDevices];
  const Occupancy general = occupancy((const void*)tv_value_and_grad_kernel<false, true>, kTvThreads, cache[0]);
  const Occupancy p1 = occupancy((const void*)tv_value_and_grad_kernel<true, true>, kTvThreads, cache[1]);
  o = p1q1 ? p1 : general;
  const int64_t hw = (int64_t)H * W;
  if (n < 1 || H < 1 || W < 1 || n % hw != 0 || segments < 1 || segments > kTvMaxPartials ||
      (n / hw) % segments != 0 || general.wave < 1 || p1.wave < 1)
    return false;
  const int64_t planes = n / hw / segments;
  const int64_t tiles_w = (W + kTvCols - 1) / kTvCols;
  const int64_t tiles_per_plane = (int64_t)((H + kTvRows - 1) / kTvRows) * tiles_w;
  const int64_t tiles = planes * tiles_per_plane;
  if (tiles > INT32_MAX) return false;
  // at most kTvMaxPartials / segments partials a segment
  const int64_t per_segment = kTvMaxPartials / segments;
  const int64_t chunk = (tiles + per_segment - 1) / per_segment;
  const int64_t chunks = (tiles + chunk - 1) / chunk;
  const int64_t wave = general.wave < p1.wave ? general.wave : p1.wave;
  int64_t blocks = wave / segments;
  if (blocks < 1) blocks = 1;
  if (blocks > chunks) blocks = chunks;
  g = TVGrid{(int)tiles_w, (int)tiles_per_plane, (int)planes, (int)tiles, (int)chunk, (int)chunks, (int)blocks};
  return true;
}

// values[s] = TV of segment s of the NCHW batch x (n = N*C*H*W elements in `segments`
// segments of whole images, each the mean over its own n / segments elements) times
// scale[0], and grad = the gradient of each segment's value. `workspace` is a zeroed
// TVWorkspace (2 * 16384 4-byte words) that only this stream uses; the kernel leaves it
// zeroed.
extern "C" int b3_tv_value_and_grad(const float* x, const float* scale, int64_t n, int H, int W, int segments,
                                    float p, float q, float eps, void* workspace, float* values, float* grad,
                                    void* stream) {
  const bool p1q1 = p == 1.0f && q == 1.0f;
  TVGrid g;
  Occupancy o;
  if (!tv_launch(n, H, W, segments, p1q1, g, o)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TVParams t{H, W, p, q, eps};
  TVWorkspace* ws = static_cast<TVWorkspace*>(workspace);
  const int64_t n_segment = n / segments;
  if (p1q1) {
    tv_value_and_grad_kernel<true, true><<<segments * g.blocks, kTvThreads, 0, s>>>(x, scale, t, g, n_segment, ws,
                                                                                    values, grad);
  } else {
    tv_value_and_grad_kernel<false, true><<<segments * g.blocks, kTvThreads, 0, s>>>(x, scale, t, g, n_segment,
                                                                                     ws, values, grad);
  }
  return (int)cudaGetLastError();
}

// out[0] = TV of the NCHW batch x (n = N*C*H*W elements): the fused kernel's value-only
// form, one segment, on the grid of its gradient form. `workspace` as b3_tv_value_and_grad's.
extern "C" int b3_tv_forward(const float* x, int64_t n, int H, int W, float p, float q, float eps,
                             void* workspace, float* out, void* stream) {
  const bool p1q1 = p == 1.0f && q == 1.0f;
  TVGrid g;
  Occupancy o;
  if (!tv_launch(n, H, W, 1, p1q1, g, o)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TVParams t{H, W, p, q, eps};
  TVWorkspace* ws = static_cast<TVWorkspace*>(workspace);
  if (p1q1) {
    tv_value_and_grad_kernel<true, false><<<g.blocks, kTvThreads, 0, s>>>(x, nullptr, t, g, n, ws, out, nullptr);
  } else {
    tv_value_and_grad_kernel<false, false><<<g.blocks, kTvThreads, 0, s>>>(x, nullptr, t, g, n, ws, out, nullptr);
  }
  return (int)cudaGetLastError();
}

// The bytes of the workspace that b3_tv_value_and_grad takes.
extern "C" int64_t b3_tv_workspace_bytes() { return (int64_t)sizeof(TVWorkspace); }

// config = (threads per block, registers per thread, static shared bytes, local bytes per
// thread, blocks per SM, grid) of b3_tv_value_and_grad's launch, in its p = q = 1 form or
// the general one.
extern "C" int b3_tv_value_and_grad_config(int64_t n, int H, int W, int segments, int p1q1, int* config) {
  TVGrid g;
  Occupancy o;
  if (!tv_launch(n, H, W, segments, p1q1 != 0, g, o)) return (int)cudaErrorInvalidValue;
  const int values[6] = {kTvThreads, o.registers, o.shared_bytes, o.local_bytes, o.blocks_per_sm,
                         segments * g.blocks};
  for (int i = 0; i < 6; ++i) config[i] = values[i];
  return (int)cudaSuccess;
}

// out = clamp(x, lo[c], hi[c]) for the NCHW batch x with `channels` channels of hw
// pixels; out may be x.
extern "C" int b4_box_project(const float* x, const float* lo, const float* hi, float* out,
                              int64_t n, int64_t hw, int channels, void* stream) {
  if (n < 0 || hw < 1 || channels < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < ((int64_t)1 << 30)) {
    launch_box<int32_t>(x, lo, hi, out, n, hw, channels, s);
  } else {
    launch_box<int64_t>(x, lo, hi, out, n, hw, channels, s);
  }
  return (int)cudaGetLastError();
}

// b4_adam_box_step's kernel for trials of `per` elements: one instance per sign mode,
// 32-bit indices below 2^30 elements a trial, the float4 form where the five tensors are
// 16-byte aligned and a plane's hw pixels a multiple of 4.
template <typename Index>
using AdamKernel = void (*)(AdamOperands, Index, Index, int, int, AdamParams, bool);

template <typename Index>
static AdamKernel<Index> adam_kernel(bool vec, SignMode mode) {
  if (vec) {
    return mode == kHardSign   ? adam_box_step_kernel<true, kHardSign, Index>
           : mode == kSoftSign ? adam_box_step_kernel<true, kSoftSign, Index>
                               : adam_box_step_kernel<true, kUnsigned, Index>;
  }
  return mode == kHardSign   ? adam_box_step_kernel<false, kHardSign, Index>
         : mode == kSoftSign ? adam_box_step_kernel<false, kSoftSign, Index>
                             : adam_box_step_kernel<false, kUnsigned, Index>;
}

// The kernel's occupancy on the current device and its blocks per trial: one wave shared
// among the trials, at most what a trial needs.
struct AdamLaunch {
  Occupancy o;
  int blocks_per_trial;
  bool narrow;
};

static AdamLaunch adam_launch(bool vec, SignMode mode, int64_t trials, int64_t per) {
  static Occupancy cache[12][kMaxDevices];
  const bool narrow = per < ((int64_t)1 << 30);
  const int form = ((vec ? 2 : 0) + (narrow ? 1 : 0)) * 3 + (int)mode;
  const void* kernel =
      narrow ? (const void*)adam_kernel<int32_t>(vec, mode) : (const void*)adam_kernel<int64_t>(vec, mode);
  const Occupancy o = occupancy(kernel, kThreads, cache[form]);
  return AdamLaunch{o, o.wave < 1 ? 0 : blocks_per_segment(o.wave, trials, vec ? per / 4 : per), narrow};
}

// One attack step on `trials` stacked NCHW candidates x of `per` elements each
// (`channels` channels of hw pixels), in place on x, mu, nu and best; trial t's loss is
// values[t], its best value best_vals[t], and new_best_vals[t] gets its new best value.
// The scalars come as doubles and are rounded to float32 here, as PyTorch rounds a
// Python scalar (1 - b1 and 1 - b2 formed in double first). flags: bit 0 takes the
// gradient's sign, bit 1 clamps to [lo[c], hi[c]], bit 2 takes the soft sign
// tanh(g soft_scale) / soft_div (bits 0 and 2 exclude each other).
extern "C" int b4_adam_box_step(float* x, const float* grad, float* mu, float* nu, float* best, const float* lo,
                                const float* hi, const float* values, const float* best_vals, float* new_best_vals,
                                int64_t trials, int64_t per, int64_t hw, int channels, double lr, double b1,
                                double b2, double eps, double bias1, double bias2, double soft_scale,
                                double soft_div, int flags, void* stream) {
  if (trials < 1 || per < 1 || hw < 1 || channels < 1 || per % (hw * channels) != 0 || best_vals == new_best_vals ||
      (flags & 5) == 5)
    return (int)cudaErrorInvalidValue;
  const bool vec = hw % 4 == 0 && aligned16(x) && aligned16(grad) && aligned16(mu) && aligned16(nu) &&
                   aligned16(best);
  const SignMode mode = (flags & 1) ? kHardSign : (flags & 4) ? kSoftSign : kUnsigned;
  const AdamLaunch launch = adam_launch(vec, mode, trials, per);
  if (launch.blocks_per_trial < 1) return (int)cudaErrorInvalidConfiguration;  // the occupancy query failed
  if (trials * launch.blocks_per_trial > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AdamOperands o{x, grad, mu, nu, best, lo, hi, values, best_vals, new_best_vals};
  const AdamParams a{(float)lr, (float)(1.0 - b1), (float)b1, (float)(1.0 - b2), (float)b2, (float)eps,
                     (float)bias1, (float)bias2, (float)soft_scale, (float)soft_div};
  const bool boxed = (flags & 2) != 0;
  const int grid = (int)(trials * launch.blocks_per_trial);
  const int bpt = launch.blocks_per_trial;
  if (launch.narrow) {
    const AdamKernel<int32_t> kernel = adam_kernel<int32_t>(vec, mode);
    kernel<<<grid, kThreads, 0, s>>>(o, (int32_t)per, (int32_t)hw, channels, bpt, a, boxed);
  } else {
    const AdamKernel<int64_t> kernel = adam_kernel<int64_t>(vec, mode);
    kernel<<<grid, kThreads, 0, s>>>(o, per, hw, channels, bpt, a, boxed);
  }
  return (int)cudaGetLastError();
}

// config = (threads per block, registers per thread, static shared bytes, local bytes per
// thread, blocks per SM, grid) of b4_adam_box_step's hard-sign launch over `trials`
// trials of `per` elements with planes of hw pixels (the float4 form where hw % 4 == 0),
// on the current device.
extern "C" int b4_adam_box_step_config(int64_t trials, int64_t per, int64_t hw, int* config) {
  if (trials < 1 || per < 1 || hw < 1) return (int)cudaErrorInvalidValue;
  const AdamLaunch launch = adam_launch(hw % 4 == 0, kHardSign, trials, per);
  const Occupancy& o = launch.o;
  const int values[6] = {kThreads, o.registers, o.shared_bytes, o.local_bytes, o.blocks_per_sm,
                         (int)(trials * launch.blocks_per_trial)};
  for (int i = 0; i < 6; ++i) config[i] = values[i];
  return launch.blocks_per_trial < 1 ? (int)cudaErrorInvalidValue : (int)cudaSuccess;
}
