// The kernels that PyTorch's dispatcher calls, as ops of the `breaching` namespace:
//
//   torch.ops.breaching.axpby(a, x, b, y) -> out                  (csrc/matching.cu b2_axpby)
//   torch.ops.breaching.tv_value_and_grad(x, scale, p, q, eps, segments, workspace)
//       -> (values, grad)                                         (csrc/image.cu b3_tv_value_and_grad)
//       values has shape (segments,), one per segment of x's images; segments = 0 takes
//       the batch as one segment and gives a 0-dim value, the form the TV regularizer
//       returns, with no view to make on the host
//   torch.ops.breaching.launch_config(kernel, n, h, w, segments) -> the launch's geometry
//
// Each op checks its tensors, allocates its outputs (at::detail::empty_cuda, the
// caching allocator without a second trip through the dispatcher) and reads the
// current stream in C++, then calls the kernel's plain-C launcher: a call through the dispatcher costs
// about what one PyTorch op costs, where the ctypes path's checks, allocations and
// argument conversion in Python cost more than the kernels at the attack's sizes.
// Only CUDA implementations are registered: the Python wrappers (ops/matching.py,
// ops/image.py) run the plain versions for CPU tensors, and their autograd Functions
// define the gradients. This is the one source that includes PyTorch's headers; the
// .cu files keep to the CUDA runtime.
#include <ATen/core/Tensor.h>
#include <ATen/cuda/EmptyTensor.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <algorithm>
#include <cstdint>
#include <string>
#include <tuple>
#include <vector>

extern "C" {
int b2_axpby(const float* a, const float* x, const float* b, const float* y, float* out, int64_t n,
             void* stream);
int b2_axpby_config(int64_t n, int* config);
int b3_tv_value_and_grad(const float* x, const float* scale, int64_t n, int H, int W, int segments, float p,
                         float q, float eps, void* workspace, float* values, float* grad, void* stream);
int64_t b3_tv_workspace_bytes();
int b3_tv_value_and_grad_config(int64_t n, int H, int W, int segments, int p1q1, int* config);
}

namespace {

// One CUDA device for every tensor (RuntimeError, as PyTorch's own ops raise), then
// float32 and contiguous (ValueError, as the wrappers raise for the CPU).
void check_tensor(const char* op, const char* name, const at::Tensor& t, const at::Device& device) {
  TORCH_CHECK(t.device() == device, "breaching::", op, ": ", name, " lies on ", t.device(),
              ", the other tensors on ", device);
  TORCH_CHECK_VALUE(t.scalar_type() == at::kFloat, "breaching::", op, ": ", name, " must be float32, got ",
                    t.scalar_type());
  TORCH_CHECK_VALUE(t.is_contiguous(), "breaching::", op, ": ", name, " must be contiguous");
}

void check_launch(int status, const char* kernel) {
  TORCH_CHECK(status == 0, "CUDA kernel ", kernel, " failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(status)));
}

void* current_stream(const at::Device& device) {
  return c10::cuda::getCurrentCUDAStream(device.index()).stream();
}

at::Tensor axpby_cuda(const at::Tensor& a, const at::Tensor& x, const at::Tensor& b, const at::Tensor& y) {
  const at::Device device = x.device();
  TORCH_CHECK(device.is_cuda(), "breaching::axpby: x lies on ", device, ", not on a CUDA device");
  check_tensor("axpby", "a", a, device);
  check_tensor("axpby", "x", x, device);
  check_tensor("axpby", "b", b, device);
  check_tensor("axpby", "y", y, device);
  TORCH_CHECK_VALUE(x.dim() == 1 && y.sizes() == x.sizes() && a.numel() == 1 && b.numel() == 1,
                    "breaching::axpby takes one-element a, b and flat x, y of one length, got ", a.sizes(),
                    ", ", x.sizes(), ", ", b.sizes(), ", ", y.sizes());
  const c10::cuda::CUDAGuard guard(device);
  at::Tensor out = at::detail::empty_cuda(x.sizes(), x.options());
  check_launch(b2_axpby(a.data_ptr<float>(), x.data_ptr<float>(), b.data_ptr<float>(), y.data_ptr<float>(),
                        out.data_ptr<float>(), x.numel(), current_stream(device)),
               "b2_axpby");
  return out;
}

std::tuple<at::Tensor, at::Tensor> tv_value_and_grad_cuda(const at::Tensor& x, const at::Tensor& scale, double p,
                                                          double q, double eps, int64_t segments,
                                                          const at::Tensor& workspace) {
  const at::Device device = x.device();
  TORCH_CHECK(device.is_cuda(), "breaching::tv_value_and_grad: x lies on ", device, ", not on a CUDA device");
  check_tensor("tv_value_and_grad", "x", x, device);
  check_tensor("tv_value_and_grad", "scale", scale, device);
  TORCH_CHECK(workspace.device() == device, "breaching::tv_value_and_grad: the workspace lies on ",
              workspace.device(), ", the other tensors on ", device);
  TORCH_CHECK_VALUE(workspace.scalar_type() == at::kInt && workspace.is_contiguous() &&
                        workspace.numel() * 4 == b3_tv_workspace_bytes(),
                    "breaching::tv_value_and_grad takes a contiguous int32 workspace of ",
                    b3_tv_workspace_bytes() / 4, " words");
  TORCH_CHECK_VALUE(x.dim() == 4 && x.numel() > 0 && scale.numel() == 1,
                    "breaching::tv_value_and_grad takes a non-empty NCHW batch and a one-element scale, got ",
                    x.sizes(), " and ", scale.sizes());
  TORCH_CHECK_VALUE(segments >= 0 && x.size(0) % std::max<int64_t>(segments, 1) == 0,
                    "breaching::tv_value_and_grad: ", segments, " segments do not divide ", x.size(0), " images");
  TORCH_CHECK_VALUE(x.size(2) <= INT32_MAX && x.size(3) <= INT32_MAX, "breaching::tv_value_and_grad: planes of ",
                    x.size(2), " x ", x.size(3), " are too large");
  const c10::cuda::CUDAGuard guard(device);
  at::Tensor values = segments == 0 ? at::detail::empty_cuda({}, x.options())
                                    : at::detail::empty_cuda({segments}, x.options());
  at::Tensor grad = at::detail::empty_cuda(x.sizes(), x.options());
  check_launch(b3_tv_value_and_grad(x.data_ptr<float>(), scale.data_ptr<float>(), x.numel(), (int)x.size(2),
                                    (int)x.size(3), (int)std::max<int64_t>(segments, 1), (float)p, (float)q, (float)eps,
                                    workspace.data_ptr(), values.data_ptr<float>(), grad.data_ptr<float>(),
                                    current_stream(device)),
               "b3_tv_value_and_grad");
  return {values, grad};
}

// (threads per block, registers per thread, static shared bytes, local (spilled) bytes
// per thread, blocks resident per SM, grid) of one kernel's launch on the current device: "b2_axpby" over n floats,
// "b3_tv_value_and_grad" (general exponents) or "b3_tv_value_and_grad p=q=1" over n
// elements of h x w planes in `segments` segments. Nothing is launched.
std::vector<int64_t> launch_config(const std::string& kernel, int64_t n, int64_t h, int64_t w, int64_t segments) {
  int config[6] = {0, 0, 0, 0, 0, 0};
  int status = 0;
  if (kernel == "b2_axpby") {
    status = b2_axpby_config(n, config);
  } else if (kernel == "b3_tv_value_and_grad" || kernel == "b3_tv_value_and_grad p=q=1") {
    status = b3_tv_value_and_grad_config(n, (int)h, (int)w, (int)segments, kernel != "b3_tv_value_and_grad",
                                         config);
  } else {
    TORCH_CHECK_VALUE(false, "breaching::launch_config: no kernel ", kernel);
  }
  check_launch(status, kernel.c_str());
  return std::vector<int64_t>(config, config + 6);
}

}  // namespace

TORCH_LIBRARY(breaching, m) {
  m.def("axpby(Tensor a, Tensor x, Tensor b, Tensor y) -> Tensor");
  m.def("tv_value_and_grad(Tensor x, Tensor scale, float p, float q, float eps, int segments, "
        "Tensor(a!) workspace) -> (Tensor, Tensor)");
  m.def("launch_config(str kernel, int n, int h, int w, int segments) -> int[]", &launch_config);
}

TORCH_LIBRARY_IMPL(breaching, CUDA, m) {
  m.impl("axpby", &axpby_cuda);
  m.impl("tv_value_and_grad", &tv_value_and_grad_cuda);
}
