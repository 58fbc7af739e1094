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
// on the host. Bound: 12 bytes per element, 12 n / 3.35 TB/s (10.41 us at
// ConvNet-64's 2,904,970 entries). It is called through PyTorch's dispatcher
// (csrc/bindings.cpp), which checks and allocates in C++: at this size the call's
// host work, not the pass, set its cost. The pass is a stream, so the design is
// about bytes in flight: the grid is exactly one wave (the occupancy API's blocks
// per SM times the SM count), each thread issues the 16-byte loads of x and y for
// kAxpbyUnroll grid-stride iterations before any arithmetic, and reads them with
// the evict-first hint (__ldcs), since nothing reads x or y again; `out` is stored
// normally, since its consumer (the gradient's split into the leaves) reads it
// next. A masked scalar tail takes the last n % 4 elements and unaligned pointers.
// Shared memory, wgmma and TMA have no work in a 12-byte-per-element stream: no
// element is read twice and nothing is a product of tiles. Products and the sum are
// rounded separately (no fused multiply-add), which is what the plain PyTorch
// version computes, so the two agree bit for bit.
//
// `b2_cosine_backward` is B2 rebuilt for the cosine's VJP, `_cos_bwd`
// (breaching_tpu/ops/matching.py:135-146), whose `_axpby` calls it replaces with
// the scalar arithmetic before them, for T rows at once: the JAX package vmaps the
// cosine over the attack's trials, and one launch takes every trial's row here. Every
// thread reads its row's three sums from B1 and its upstream gradient g from device
// memory and forms, in registers and in `_cos_bwd`'s order, rec_n = sqrt(|rec|^2),
// data_n = sqrt(|data|^2), a = -g / (rec_n data_n + 1e-12) and
// b = g dot / (rec_n^3 data_n + 1e-12), with rec_n^3 = (rec_n rec_n) rec_n as
// PyTorch's pow(x, 3) forms it (data's roles swap for d/d data); then it streams
// a data + b rec. One launch in place of about eleven scalar launches and `b2_axpby`
// per trial. Bound: 12 bytes per element, 12 n / 3.35 TB/s (10.41 us at ConvNet-64's
// 2,904,970 parameters, 41.6 us for 4 trials of them, 40.76 us at ResNet-18's
// 11,380,173); the scalar work is a few dozen operations per thread from cached loads.
// The pass is a stream, so the design is `b2_axpby`'s, measured on the card: a grid
// of one wave from the occupancy API, shared among the rows; each thread issues the
// 16-byte loads of kAxpbyUnroll grid-stride iterations before any arithmetic; 32-bit
// indices below 2^30 elements a row. Only the fresh gradient (rec, or data where the
// gradient is taken with respect to it) is read evict-first (__ldcs): the other
// vector is the attack's cached target, which the next evaluation reads again. A row
// of n % 4 != 0 floats starts off a 16-byte boundary where the row before it ends, so
// each row takes a scalar head up to its first boundary, then float4s, then a scalar
// tail, wherever rec, data and out lie alike against 16-byte boundaries (else all
// scalar). Nothing here is a matrix product or a tile to stage, so wgmma, TMA and
// shared memory do not apply. No fused multiply-add and IEEE division and square root:
// the result equals the plain PyTorch version bit for bit, and each row of the trials
// form equals its own single call.
//
// Every kernel here is called through PyTorch's dispatcher (csrc/bindings.cpp), which
// checks the tensors and allocates outputs and scratch in C++.
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

constexpr int kAxpbyUnroll = 4;  // grid-stride iterations whose loads a thread issues together

template <bool kVec, typename Index>
__global__ void __launch_bounds__(kThreads)
axpby_kernel(const float* __restrict__ a_ptr, const float* __restrict__ x,
             const float* __restrict__ b_ptr, const float* __restrict__ y,
             float* __restrict__ out, Index n) {
  const float a = *a_ptr;
  const float b = *b_ptr;
  const Index stride = (Index)gridDim.x * kThreads;
  const Index tid = (Index)blockIdx.x * kThreads + threadIdx.x;
  Index tail = 0;
  if (kVec) {
    const Index n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (Index base = tid; base < n4; base += kAxpbyUnroll * stride) {
      float4 xv[kAxpbyUnroll], yv[kAxpbyUnroll];
#pragma unroll
      for (int u = 0; u < kAxpbyUnroll; ++u) {
        const Index i = base + u * stride;
        if (i < n4) {
          xv[u] = __ldcs(x4 + i);
          yv[u] = y4[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kAxpbyUnroll; ++u) {
        const Index i = base + u * stride;
        if (i < n4) {
          o4[i] = make_float4(axpby1(a, xv[u].x, b, yv[u].x), axpby1(a, xv[u].y, b, yv[u].y),
                              axpby1(a, xv[u].z, b, yv[u].z), axpby1(a, xv[u].w, b, yv[u].w));
        }
      }
    }
    tail = n4 * 4;
  }
  for (Index i = tail + tid; i < n; i += stride) out[i] = axpby1(a, __ldcs(x + i), b, y[i]);
}

// The scalars a, b of the cosine's VJP with respect to the vector whose squared norm
// is sums[1 + wrt_data], in `_cos_bwd`'s order of operations.
__device__ __forceinline__ void cosine_coefficients(const float* __restrict__ sums,
                                                    const float* __restrict__ g_ptr, int wrt_data,
                                                    float& a, float& b) {
  const float g = *g_ptr;
  const float dot = sums[0];
  const float rec_n = __fsqrt_rn(sums[1]);
  const float data_n = __fsqrt_rn(sums[2]);
  const float self_n = wrt_data ? data_n : rec_n;
  const float other_n = wrt_data ? rec_n : data_n;
  a = __fdiv_rn(-g, __fadd_rn(__fmul_rn(rec_n, data_n), 1e-12f));
  const float cube = __fmul_rn(__fmul_rn(self_n, self_n), self_n);
  b = __fdiv_rn(__fmul_rn(g, dot), __fadd_rn(__fmul_rn(cube, other_n), 1e-12f));
}

// out = a other + b self for each of the grid's rows of n floats, with self = rec and
// other = data, or the reverse if wrt_data; row r's a and b come from sums[3 r ..] and
// g[r]. blocks_per_row consecutive blocks take one row. kVec: the three vectors lie
// alike against 16-byte boundaries, so each row is a scalar head up to its first
// boundary, float4s, and a scalar tail.
template <bool kVec, typename Index>
__global__ void __launch_bounds__(kThreads)
cosine_backward_kernel(const float* __restrict__ sums, const float* __restrict__ g,
                       const float* __restrict__ self, const float* __restrict__ other,
                       float* __restrict__ out, Index n, int blocks_per_row, int wrt_data) {
  const int row = blockIdx.x / blocks_per_row;
  const Index stride = (Index)blocks_per_row * kThreads;
  const Index tid = (Index)(blockIdx.x - row * blocks_per_row) * kThreads + threadIdx.x;
  // the row's a and b, formed once after the thread's first loads are issued, so that
  // the round trip for the sums overlaps theirs
  float a = 0.0f, b = 0.0f;
  bool formed = false;
  const int64_t offset = (int64_t)row * n;
  self += offset;
  other += offset;
  out += offset;
  Index head = 0, n4 = 0;
  if (kVec) {
    head = (Index)(((16u - (unsigned)(reinterpret_cast<uintptr_t>(self) & 15u)) & 15u) >> 2);
    if (head > n) head = n;
    n4 = (n - head) / 4;
    const float4* s4 = reinterpret_cast<const float4*>(self + head);
    const float4* o4 = reinterpret_cast<const float4*>(other + head);
    float4* out4 = reinterpret_cast<float4*>(out + head);
    for (Index base = tid; base < n4; base += kAxpbyUnroll * stride) {
      float4 ov[kAxpbyUnroll], sv[kAxpbyUnroll];
#pragma unroll
      for (int u = 0; u < kAxpbyUnroll; ++u) {
        const Index i = base + u * stride;
        if (i < n4) {
          ov[u] = o4[i];           // the cached vector: the next evaluation reads it again
          sv[u] = __ldcs(s4 + i);  // the fresh gradient: read once
        }
      }
      if (!formed) {
        cosine_coefficients(sums + 3 * row, g + row, wrt_data, a, b);
        formed = true;
      }
#pragma unroll
      for (int u = 0; u < kAxpbyUnroll; ++u) {
        const Index i = base + u * stride;
        if (i < n4) {
          out4[i] = make_float4(axpby1(a, ov[u].x, b, sv[u].x), axpby1(a, ov[u].y, b, sv[u].y),
                                axpby1(a, ov[u].z, b, sv[u].z), axpby1(a, ov[u].w, b, sv[u].w));
        }
      }
    }
  }
  // the scalar rest: the head [0, head) and the tail [head + 4 n4, n)
  const Index rest = n - 4 * n4;
  for (Index j = tid; j < rest; j += stride) {
    const Index i = j < head ? j : j + 4 * n4;
    const float o = other[i], v = __ldcs(self + i);
    if (!formed) {
      cosine_coefficients(sums + 3 * row, g + row, wrt_data, a, b);
      formed = true;
    }
    out[i] = axpby1(a, o, b, v);
  }
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

// b2_axpby's kernel for n floats (32-bit indices below 2^30 elements, where an index
// plus the grid's stride stays within 32 bits; the float4 form for 16-byte aligned
// pointers), its occupancy on the current device and its grid: one wave at most.
struct AxpbyLaunch {
  Occupancy o;
  int grid;
};

static AxpbyLaunch axpby_launch(bool vec, int64_t n) {
  static Occupancy cache[4][kMaxDevices];
  const bool narrow = n < ((int64_t)1 << 30);
  const int form = (vec ? 2 : 0) + (narrow ? 1 : 0);
  const void* kernel = vec ? (narrow ? (const void*)axpby_kernel<true, int32_t>
                                  : (const void*)axpby_kernel<true, int64_t>)
                           : (narrow ? (const void*)axpby_kernel<false, int32_t>
                                     : (const void*)axpby_kernel<false, int64_t>);
  const Occupancy o = occupancy(kernel, kThreads, cache[form]);
  return AxpbyLaunch{o, o.wave < 1 ? 0 : grid_for(vec ? n / 4 : n, 1, o.wave)};
}

// out = a[0] * x + b[0] * y over n floats.
extern "C" int b2_axpby(const float* a, const float* x, const float* b, const float* y,
                        float* out, int64_t n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x) && aligned16(y) && aligned16(out);
  const AxpbyLaunch launch = axpby_launch(vec, n);
  if (launch.grid < 1) return (int)cudaErrorInvalidConfiguration;  // the occupancy query failed
  const bool narrow = n < ((int64_t)1 << 30);
  if (vec && narrow) {
    axpby_kernel<true, int32_t><<<launch.grid, kThreads, 0, s>>>(a, x, b, y, out, (int32_t)n);
  } else if (vec) {
    axpby_kernel<true, int64_t><<<launch.grid, kThreads, 0, s>>>(a, x, b, y, out, n);
  } else if (narrow) {
    axpby_kernel<false, int32_t><<<launch.grid, kThreads, 0, s>>>(a, x, b, y, out, (int32_t)n);
  } else {
    axpby_kernel<false, int64_t><<<launch.grid, kThreads, 0, s>>>(a, x, b, y, out, n);
  }
  return (int)cudaGetLastError();
}

// config = (threads per block, registers per thread, static shared bytes, local bytes per
// thread, blocks per SM, grid) of b2_axpby's launch over n aligned floats, on the current
// device.
extern "C" int b2_axpby_config(int64_t n, int* config) {
  const AxpbyLaunch launch = axpby_launch(true, n);
  const Occupancy& o = launch.o;
  const int values[6] = {kThreads, o.registers, o.shared_bytes, o.local_bytes, o.blocks_per_sm, launch.grid};
  for (int i = 0; i < 6; ++i) config[i] = values[i];
  return launch.grid < 1 ? (int)cudaErrorInvalidValue : (int)cudaSuccess;
}

// b2_cosine_backward's kernel for rows of n floats (32-bit indices below 2^30 floats a
// row; the float4 form where rec, data and out lie alike against 16-byte boundaries),
// its occupancy on the current device and its blocks per row: one wave shared among
// the rows, at most what a row needs in one round.
struct CosineLaunch {
  Occupancy o;
  int blocks_per_row;
  bool narrow;
};

static CosineLaunch cosine_launch(bool vec, int64_t rows, int64_t n) {
  static Occupancy cache[4][kMaxDevices];
  const bool narrow = n < ((int64_t)1 << 30);
  const int form = (vec ? 2 : 0) + (narrow ? 1 : 0);
  const void* kernel = vec ? (narrow ? (const void*)cosine_backward_kernel<true, int32_t>
                                     : (const void*)cosine_backward_kernel<true, int64_t>)
                           : (narrow ? (const void*)cosine_backward_kernel<false, int32_t>
                                     : (const void*)cosine_backward_kernel<false, int64_t>);
  const Occupancy o = occupancy(kernel, kThreads, cache[form]);
  return CosineLaunch{o, o.wave < 1 ? 0 : blocks_per_segment(o.wave, rows, vec ? n / 4 : n), narrow};
}

// out[r] = d/d rec[r] (wrt_data = 0) or d/d data[r] (wrt_data = 1) of g[r] (1 - cos(rec[r],
// data[r])) for `rows` rows of n floats, from sums[r] = (<rec, data>, |rec|^2, |data|^2).
extern "C" int b2_cosine_backward(const float* sums, const float* g, const float* rec, const float* data,
                                  float* out, int64_t rows, int64_t n, int wrt_data, void* stream) {
  if (rows < 1 || n < 0 || (wrt_data != 0 && wrt_data != 1)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const float* self = wrt_data ? data : rec;
  const float* other = wrt_data ? rec : data;
  const uintptr_t phase = reinterpret_cast<uintptr_t>(self) & 15u;
  const bool vec = (reinterpret_cast<uintptr_t>(other) & 15u) == phase &&
                   (reinterpret_cast<uintptr_t>(out) & 15u) == phase && (phase & 3u) == 0;
  const CosineLaunch launch = cosine_launch(vec, rows, n);
  if (launch.blocks_per_row < 1) return (int)cudaErrorInvalidConfiguration;  // the occupancy query failed
  if (rows * launch.blocks_per_row > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (int)(rows * launch.blocks_per_row);
  const int bpr = launch.blocks_per_row;
  if (vec && launch.narrow) {
    cosine_backward_kernel<true, int32_t><<<grid, kThreads, 0, s>>>(sums, g, self, other, out, (int32_t)n, bpr,
                                                                    wrt_data);
  } else if (vec) {
    cosine_backward_kernel<true, int64_t><<<grid, kThreads, 0, s>>>(sums, g, self, other, out, n, bpr, wrt_data);
  } else if (launch.narrow) {
    cosine_backward_kernel<false, int32_t><<<grid, kThreads, 0, s>>>(sums, g, self, other, out, (int32_t)n, bpr,
                                                                     wrt_data);
  } else {
    cosine_backward_kernel<false, int64_t><<<grid, kThreads, 0, s>>>(sums, g, self, other, out, n, bpr, wrt_data);
  }
  return (int)cudaGetLastError();
}

// config = (threads per block, registers per thread, static shared bytes, local bytes per
// thread, blocks per SM, grid) of b2_cosine_backward's launch over `rows` aligned rows of
// n floats, on the current device.
extern "C" int b2_cosine_backward_config(int64_t rows, int64_t n, int* config) {
  if (rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const CosineLaunch launch = cosine_launch(true, rows, n);
  const Occupancy& o = launch.o;
  const int values[6] = {kThreads, o.registers, o.shared_bytes, o.local_bytes, o.blocks_per_sm,
                         (int)(rows * launch.blocks_per_row)};
  for (int i = 0; i < 6; ++i) config[i] = values[i];
  return launch.blocks_per_row < 1 ? (int)cudaErrorInvalidValue : (int)cudaSuccess;
}
