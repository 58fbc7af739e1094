"""Where the fused TV kernel's device time goes, on the card.

    python3 -m breaching_tpu_torch.tv_profile

builds ``csrc/image.cu`` once more with ``b3_tv_value_and_grad``'s kernel given a mode,
by text substitution on a copy: mode 1 cuts the tail (the first block's sum of the
partials), mode 2 the gradient pass, mode 3 both. A small CUDA harness times each mode at
the shapes the attack paths give the kernel, cold (each launch after a 100 MB read
that evicts L2, whose time is subtracted) and warm, in CUDA graphs as
``timing.time_ms`` does, with a plain CUDA kernel for the read in place of
``torch.sum``. It prints one JSON line per shape; the full kernel's time minus a
mode's is what the cut part adds. Needs ``nvcc`` and a CUDA device.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
# (images, channels, height, width, segments, p, q): slices 1-5's shapes and the fleet's trials
SHAPES = [(1, 3, 32, 32, 1, 1.0, 1.0), (1, 3, 96, 96, 1, 1.0, 1.0), (1, 3, 192, 192, 1, 1.0, 1.0),
          (1, 3, 224, 224, 1, 1.0, 1.0), (4, 3, 224, 224, 1, 1.0, 1.0), (100, 3, 32, 32, 1, 1.0, 1.0),
          (1, 6, 224, 224, 1, 2.0, 0.5), (8, 3, 224, 224, 8, 1.0, 1.0)]
MODES = {0: "full", 1: "no tail", 2: "no gradient pass", 3: "neither"}
# (text of csrc/image.cu, its replacement): the kernel takes a mode
CUTS = [
    ("template <bool kP1Q1, bool kGrad>\n__global__ void __launch_bounds__(kTvThreads)\ntv_value_and_grad_kernel(",
     "template <bool kP1Q1, bool kGrad, int kMode>\n__global__ void __launch_bounds__(kTvThreads)\n"
     "tv_value_and_grad_kernel("),
    ("      if (!kGrad || !owns) continue;", "      if (!kGrad || !owns || (kMode & 2)) continue;"),
    ("  if (first != 0) return;", "  if (first != 0 || (kMode & 1)) return;"),
    ("tv_value_and_grad_kernel<false, true>", "tv_value_and_grad_kernel<false, true, 0>"),
    ("tv_value_and_grad_kernel<true, true>", "tv_value_and_grad_kernel<true, true, 0>"),
    ("tv_value_and_grad_kernel<false, false>", "tv_value_and_grad_kernel<false, false, 0>"),
    ("tv_value_and_grad_kernel<true, false>", "tv_value_and_grad_kernel<true, false, 0>"),
]
HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>

__global__ void flush_kernel(const float* p, size_t n, float* sink) {
  float s = 0.0f;
  for (size_t i = blockIdx.x * 256 + threadIdx.x; i < n; i += (size_t)gridDim.x * 256) s += p[i];
  if (s == 12345.0f) *sink = s;
}

static float *g_flush, *g_sink;
static const size_t kFlush = (size_t)100 << 18;  // 100 MB of floats

template <typename F>
float graph_us(F launch, bool flush, int iters) {
  cudaStream_t s;
  cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  cudaGraph_t graph;
  cudaGraphExec_t exec;
  cudaStreamBeginCapture(s, cudaStreamCaptureModeGlobal);
  for (int i = 0; i < iters; ++i) {
    if (flush) flush_kernel<<<528, 256, 0, s>>>(g_flush, kFlush, g_sink);
    launch(s);
  }
  cudaStreamEndCapture(s, &graph);
  cudaGraphInstantiate(&exec, graph, 0);
  cudaGraphLaunch(exec, s);
  cudaStreamSynchronize(s);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a, s);
  cudaGraphLaunch(exec, s);
  cudaEventRecord(b, s);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  cudaGraphExecDestroy(exec);
  cudaGraphDestroy(graph);
  cudaStreamDestroy(s);
  return ms * 1000.0f / iters;
}

template <bool P, int M>
void mode(const float* x, const float* scale, int64_t n, int H, int W, int segments, float p, float q, void* ws,
          float* values, float* grad, bool last) {
  TVGrid g;
  Occupancy o;
  if (!tv_launch(n, H, W, segments, P, g, o)) exit(1);
  cudaMemset(ws, 0, sizeof(TVWorkspace));  // a mode without the tail leaves its slots full
  const TVParams t{H, W, p, q, 1e-8f};
  auto launch = [&](cudaStream_t s) {
    tv_value_and_grad_kernel<P, true, M><<<segments * g.blocks, kTvThreads, 0, s>>>(
        x, scale, t, g, n / segments, (TVWorkspace*)ws, values, grad);
  };
  const float flush_only = graph_us([](cudaStream_t) {}, true, 100);
  const float cold = graph_us(launch, true, 100) - flush_only;
  const float warm = graph_us(launch, false, 100);
  if (cudaGetLastError() != cudaSuccess) exit(2);
  printf("\"%d\": [%.3f, %.3f]%s", M, cold, warm, last ? "" : ", ");
}

template <bool P>
void shape(const float* x, const float* scale, int N, int C, int H, int W, int segments, float p, float q, void* ws,
           float* values, float* grad) {
  const int64_t n = (int64_t)N * C * H * W;
  TVGrid g;
  Occupancy o;
  tv_launch(n, H, W, segments, P, g, o);
  printf("{\"shape\": [%d, %d, %d, %d], \"segments\": %d, \"p\": %g, \"q\": %g, \"grid\": %d, \"us\": {", N, C, H, W,
         segments, p, q, segments * g.blocks);
  mode<P, 0>(x, scale, n, H, W, segments, p, q, ws, values, grad, false);
  mode<P, 1>(x, scale, n, H, W, segments, p, q, ws, values, grad, false);
  mode<P, 2>(x, scale, n, H, W, segments, p, q, ws, values, grad, false);
  mode<P, 3>(x, scale, n, H, W, segments, p, q, ws, values, grad, true);
  printf("}}\n");
  fflush(stdout);
}

int main(int argc, char** argv) {
  cudaMalloc(&g_flush, kFlush * 4);
  cudaMemset(g_flush, 0, kFlush * 4);
  cudaMalloc(&g_sink, 4);
  const int64_t most = 8LL * 6 * 224 * 224;
  float *x, *grad, *scale, *values;
  void* ws;
  cudaMalloc(&x, most * 4);
  cudaMalloc(&grad, most * 4);
  cudaMalloc(&scale, 4);
  cudaMalloc(&values, 4096);
  cudaMalloc(&ws, sizeof(TVWorkspace));
  cudaMemset(ws, 0, sizeof(TVWorkspace));
  std::vector<float> host(most);
  srand(7);
  for (auto& v : host) v = (float)rand() / RAND_MAX - 0.5f;
  cudaMemcpy(x, host.data(), most * 4, cudaMemcpyHostToDevice);
  const float s = 0.2f;
  cudaMemcpy(scale, &s, 4, cudaMemcpyHostToDevice);
  for (int i = 1; i + 6 < argc; i += 7) {
    const int N = atoi(argv[i]), C = atoi(argv[i + 1]), H = atoi(argv[i + 2]), W = atoi(argv[i + 3]);
    const int segments = atoi(argv[i + 4]);
    const float p = atof(argv[i + 5]), q = atof(argv[i + 6]);
    if (p == 1.0f && q == 1.0f) {
      shape<true>(x, scale, N, C, H, W, segments, p, q, ws, values, grad);
    } else {
      shape<false>(x, scale, N, C, H, W, segments, p, q, ws, values, grad);
    }
  }
  return 0;
}
"""


def cut_source():
    """``csrc/image.cu`` with CUTS applied; raises SystemExit where an anchor is gone."""
    source = open(os.path.join(CSRC, "image.cu")).read()
    for old, new in CUTS:
        if old not in source:
            raise SystemExit(f"tv_profile: csrc/image.cu no longer holds {old!r}; update CUTS.")
        source = source.replace(old, new)
    return source


def main():
    from .ops._build import NVCC_FLAGS, find_nvcc

    source = cut_source()
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(os.path.join(CSRC, "reduce.cuh"), tmp)
        with open(os.path.join(tmp, "profile.cu"), "w") as fh:
            fh.write(source + HARNESS)
        binary = os.path.join(tmp, "profile")
        flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
        subprocess.run([find_nvcc(), *flags, "-o", binary, os.path.join(tmp, "profile.cu")], check=True)
        args = [str(v) for shape in SHAPES for v in shape]
        out = subprocess.run([binary, *args], check=True, capture_output=True, text=True).stdout
    for line in out.splitlines():
        row = json.loads(line)
        row["us"] = {MODES[int(k)]: dict(zip(("cold", "warm"), v)) for k, v in row["us"].items()}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    sys.exit(main())
