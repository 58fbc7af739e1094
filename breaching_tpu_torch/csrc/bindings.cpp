// The kernels as ops of PyTorch's dispatcher, in the `breaching` namespace:
//
//   torch.ops.breaching.matching_sums(rec, data) -> sums          (csrc/matching.cu b1_matching_sums)
//   torch.ops.breaching.matching_sums_into(rec, data, out)        B1 into a 3-float `out`, a row of a
//                                                                 (T, 3) tensor for the trials form
//   torch.ops.breaching.axpby(a, x, b, y) -> out                  (csrc/matching.cu b2_axpby)
//   torch.ops.breaching.cosine_backward(sums, g, rec, data, wrt_data) -> out
//       (csrc/matching.cu b2_cosine_backward) flat rec and data with sums (3,) and a
//       one-element g, or T rows (T, n) with sums (T, 3) and g (T,): one launch either way
//   torch.ops.breaching.tv_forward(x, p, q, eps, workspace) -> value  (csrc/image.cu b3_tv_forward)
//   torch.ops.breaching.tv_value_and_grad(x, scale, p, q, eps, segments, workspace)
//       -> (values, grad)                                         (csrc/image.cu b3_tv_value_and_grad)
//       values has shape (segments,), one per segment of x's images; segments = 0 takes
//       the batch as one segment and gives a 0-dim value, the form the TV regularizer
//       returns, with no view to make on the host
//   torch.ops.breaching.box_project(x, lo, hi) -> out             (csrc/image.cu b4_box_project)
//   torch.ops.breaching.box_project_out(x, lo, hi, out)           the same into `out`, which may be x
//   torch.ops.breaching.adam_box_step(x, grad, mu, nu, best, lo, hi, values, best_vals,
//       new_best_vals, lr, b1, b2, eps, bias1, bias2, soft_scale, soft_div, flags)
//       (csrc/image.cu b4_adam_box_step) in place on x, mu, nu, best and new_best_vals: an
//       NCHW candidate with one-element values, or a (T, N, C, H, W) stack with (T,)
//       values, one launch either way
//   torch.ops.breaching.launch_config(kernel, n, h, w, segments) -> the launch's geometry
//
// Every op but tv_forward also takes the element types of csrc/precision.cu's forms:
// matching_sums, axpby and cosine_backward a bfloat16 or float16 gradient beside a float32
// or bfloat16 target, or float64 throughout, with the sums, g, a and b in the
// accumulation type (float64 for float64, else float32) and the output in the first
// vector's type; tv_value_and_grad, box_project(_out) and adam_box_step a float64 or
// bfloat16 candidate, with the values and best values of adam_box_step in its
// accumulation type. A type pair with no form raises by name (ValueError); no op routes
// it to the plain version.
//
// Each op checks its tensors, allocates its outputs and scratch (at::detail::empty_cuda,
// the caching allocator without a second trip through the dispatcher) and reads the
// current stream in C++, then calls the kernel's plain-C launcher: a call through the
// dispatcher costs about what one PyTorch op costs. Only CUDA implementations are
// registered: the Python wrappers (ops/matching.py, ops/image.py) run the plain
// versions for CPU tensors, and their autograd Functions define the gradients. This is
// the one source that includes PyTorch's headers; the .cu files keep to the CUDA
// runtime.
#include <ATen/core/Tensor.h>
#include <ATen/cuda/EmptyTensor.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <string>
#include <tuple>
#include <utility>
#include <vector>

extern "C" {
int b1_matching_sums(const float* rec, const float* data, int64_t n, float* partials, int num_blocks, float* sums,
                     void* stream);
int b2_axpby(const float* a, const float* x, const float* b, const float* y, float* out, int64_t n,
             void* stream);
int b2_axpby_config(int64_t n, int* config);
int b2_cosine_backward(const float* sums, const float* g, const float* rec, const float* data, float* out,
                       int64_t rows, int64_t n, int wrt_data, void* stream);
int b2_cosine_backward_config(int64_t rows, int64_t n, int* config);
int b3_tv_forward(const float* x, int64_t n, int H, int W, float p, float q, float eps, void* workspace, float* out,
                  void* stream);
int b3_tv_value_and_grad(const float* x, const float* scale, int64_t n, int H, int W, int segments, float p,
                         float q, float eps, void* workspace, float* values, float* grad, void* stream);
int64_t b3_tv_workspace_bytes();
int b3_tv_value_and_grad_config(int64_t n, int H, int W, int segments, int p1q1, int* config);
int b4_box_project(const float* x, const float* lo, const float* hi, float* out, int64_t n, int64_t hw,
                   int channels, void* stream);
int b4_adam_box_step(float* x, const float* grad, float* mu, float* nu, float* best, const float* lo,
                     const float* hi, const float* values, const float* best_vals, float* new_best_vals,
                     int64_t trials, int64_t per, int64_t hw, int channels, double lr, double b1, double b2,
                     double eps, double bias1, double bias2, double soft_scale, double soft_div, int flags,
                     void* stream);
int b4_adam_box_step_config(int64_t trials, int64_t per, int64_t hw, int* config);
// csrc/precision.cu: the forms in types other than float32; type codes as `type_code`
int b1_matching_sums_typed(int rec_type, int data_type, const void* rec, const void* data, int64_t n, void* partials,
                           void* sums, void* stream);
int b2_cosine_backward_typed(int self_type, int other_type, const void* sums, const void* g, const void* self,
                             const void* other, void* out, int64_t rows, int64_t n, int wrt_data, void* stream);
int b2_axpby_typed(int x_type, int y_type, const void* a, const void* x, const void* b, const void* y, void* out,
                   int64_t n, void* stream);
int64_t b3_tv_partials_bytes(int type, int64_t n, int segments);
int b3_tv_value_and_grad_typed(int type, const void* x, const void* scale, int64_t n, int H, int W, int segments,
                               double p, double q, double eps, void* partials, void* values, void* grad, void* stream);
int b4_box_project_typed(int type, const void* x, const void* lo, const void* hi, void* out, int64_t n, int64_t hw,
                         int channels, void* stream);
int b4_adam_box_step_typed(int type, void* x, const void* grad, void* mu, void* nu, void* best, const void* lo,
                           const void* hi, const void* values, const void* best_vals, void* new_best_vals,
                           int64_t trials, int64_t per, int64_t hw, int channels, const double* scalars, int flags,
                           void* stream);
}

namespace {

constexpr int64_t kMaxTrials = 1 << 16;

// The device of the op's first tensor, which must be a CUDA device.
at::Device cuda_device(const char* op, const char* name, const at::Tensor& t) {
  TORCH_CHECK(t.device().is_cuda(), "breaching::", op, ": ", name, " lies on ", t.device(),
              ", not on a CUDA device");
  return t.device();
}

// One CUDA device for every tensor (RuntimeError, as PyTorch's own ops raise), then
// float32 and contiguous (ValueError, as the wrappers raise for the CPU).
void check_tensor(const char* op, const char* name, const at::Tensor& t, const at::Device& device) {
  TORCH_CHECK(t.device() == device, "breaching::", op, ": ", name, " lies on ", t.device(),
              ", the other tensors on ", device);
  TORCH_CHECK_VALUE(t.scalar_type() == at::kFloat, "breaching::", op, ": ", name, " must be float32, got ",
                    t.scalar_type());
  TORCH_CHECK_VALUE(t.is_contiguous(), "breaching::", op, ": ", name, " must be contiguous");
}

// One CUDA device for every tensor and contiguous, of any type: the typed forms check the
// types themselves.
void check_typed(const char* op, const char* name, const at::Tensor& t, const at::Device& device) {
  TORCH_CHECK(t.device() == device, "breaching::", op, ": ", name, " lies on ", t.device(),
              ", the other tensors on ", device);
  TORCH_CHECK_VALUE(t.is_contiguous(), "breaching::", op, ": ", name, " must be contiguous");
}

// csrc/precision.cu's type codes: float32 0, float64 1, bfloat16 2, float16 3, else -1.
int type_code(const at::Tensor& t) {
  switch (t.scalar_type()) {
    case at::kFloat: return 0;
    case at::kDouble: return 1;
    case at::kBFloat16: return 2;
    case at::kHalf: return 3;
    default: return -1;
  }
}

// The accumulation type of a typed form whose first operand is `t`: float64 for float64,
// float32 for the rest.
at::ScalarType acc_type(const at::Tensor& t) { return t.scalar_type() == at::kDouble ? at::kDouble : at::kFloat; }

bool all_float(std::initializer_list<const at::Tensor*> tensors) {
  for (const at::Tensor* t : tensors)
    if (t->scalar_type() != at::kFloat) return false;
  return true;
}

// A typed form's status: a type pair it has no form for raises by name (ValueError).
void check_typed_launch(int status, const char* op, const char* kernel, const std::string& types) {
  TORCH_CHECK_VALUE(status != (int)cudaErrorNotSupported, "breaching::", op, ": ", kernel, " has no form for ", types);
  TORCH_CHECK(status == 0, "CUDA kernel ", kernel, " failed: ", cudaGetErrorString(static_cast<cudaError_t>(status)));
}

std::string types_of(std::initializer_list<std::pair<const char*, const at::Tensor*>> named) {
  std::string out;
  for (const auto& [name, t] : named) {
    if (!out.empty()) out += ", ";
    out += std::string(name) + " " + std::string(c10::toString(t->scalar_type()));
  }
  return out;
}

void check_launch(int status, const char* kernel) {
  TORCH_CHECK(status == 0, "CUDA kernel ", kernel, " failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(status)));
}

void* current_stream(const at::Device& device) {
  return c10::cuda::getCurrentCUDAStream(device.index()).stream();
}

// Blocks of a two-pass reduction over n elements (at least 16 per thread, at most 1024
// blocks, as csrc/reduce.cuh allows).
int reduce_blocks(int64_t n) {
  return (int)std::max<int64_t>(1, std::min<int64_t>(1024, (n + 256 * 16 - 1) / (256 * 16)));
}

void launch_matching_sums(const at::Tensor& rec, const at::Tensor& data, const at::Tensor& sums,
                          const at::Device& device) {
  if (all_float({&rec, &data, &sums})) {
    const int blocks = reduce_blocks(rec.numel());
    at::Tensor partials = at::detail::empty_cuda({(int64_t)3 * blocks}, rec.options());
    check_launch(b1_matching_sums(rec.data_ptr<float>(), data.data_ptr<float>(), rec.numel(),
                                  partials.data_ptr<float>(), blocks, sums.data_ptr<float>(), current_stream(device)),
                 "b1_matching_sums");
    return;
  }
  // a typed form (csrc/precision.cu): sums in the accumulation type, 1024 blocks at most
  TORCH_CHECK_VALUE(sums.scalar_type() == acc_type(rec), "breaching::matching_sums: the sums of rec ",
                    rec.scalar_type(), " are ", acc_type(rec), ", got out of ", sums.scalar_type());
  at::Tensor partials = at::detail::empty_cuda({3 * 1024}, rec.options().dtype(acc_type(rec)));
  check_typed_launch(b1_matching_sums_typed(type_code(rec), type_code(data), rec.data_ptr(), data.data_ptr(),
                                            rec.numel(), partials.data_ptr(), sums.data_ptr(), current_stream(device)),
                     "matching_sums", "b1_matching_sums", types_of({{"rec", &rec}, {"data", &data}}));
}

at::Device check_matching_sums(const char* op, const at::Tensor& rec, const at::Tensor& data) {
  const at::Device device = cuda_device(op, "rec", rec);
  check_typed(op, "rec", rec, device);
  check_typed(op, "data", data, device);
  TORCH_CHECK_VALUE(rec.dim() == 1 && data.sizes() == rec.sizes(), "breaching::", op,
                    " takes two flat vectors of one length, got ", rec.sizes(), " and ", data.sizes());
  return device;
}

at::Tensor matching_sums_cuda(const at::Tensor& rec, const at::Tensor& data) {
  const at::Device device = check_matching_sums("matching_sums", rec, data);
  const c10::cuda::CUDAGuard guard(device);
  at::Tensor sums = at::detail::empty_cuda({3}, rec.options().dtype(acc_type(rec)));
  launch_matching_sums(rec, data, sums, device);
  return sums;
}

void matching_sums_into_cuda(const at::Tensor& rec, const at::Tensor& data, const at::Tensor& out) {
  const at::Device device = check_matching_sums("matching_sums_into", rec, data);
  check_typed("matching_sums_into", "out", out, device);
  TORCH_CHECK_VALUE(out.numel() == 3, "breaching::matching_sums_into writes 3 floats, got out of ", out.sizes());
  const c10::cuda::CUDAGuard guard(device);
  launch_matching_sums(rec, data, out, device);
}

at::Tensor axpby_cuda(const at::Tensor& a, const at::Tensor& x, const at::Tensor& b, const at::Tensor& y) {
  const at::Device device = cuda_device("axpby", "x", x);
  const at::Tensor* tensors[] = {&a, &x, &b, &y};
  const char* names[] = {"a", "x", "b", "y"};
  for (int i = 0; i < 4; ++i) check_typed("axpby", names[i], *tensors[i], device);
  TORCH_CHECK_VALUE(x.dim() == 1 && y.sizes() == x.sizes() && a.numel() == 1 && b.numel() == 1,
                    "breaching::axpby takes one-element a, b and flat x, y of one length, got ", a.sizes(),
                    ", ", x.sizes(), ", ", b.sizes(), ", ", y.sizes());
  const c10::cuda::CUDAGuard guard(device);
  at::Tensor out = at::detail::empty_cuda(x.sizes(), x.options());
  if (all_float({&a, &x, &b, &y})) {
    check_launch(b2_axpby(a.data_ptr<float>(), x.data_ptr<float>(), b.data_ptr<float>(), y.data_ptr<float>(),
                          out.data_ptr<float>(), x.numel(), current_stream(device)),
                 "b2_axpby");
    return out;
  }
  TORCH_CHECK_VALUE(a.scalar_type() == acc_type(x) && b.scalar_type() == acc_type(x), "breaching::axpby: a and b of x ",
                    x.scalar_type(), " are ", acc_type(x), ", got ", a.scalar_type(), " and ", b.scalar_type());
  check_typed_launch(b2_axpby_typed(type_code(x), type_code(y), a.data_ptr(), x.data_ptr(), b.data_ptr(), y.data_ptr(),
                                    out.data_ptr(), x.numel(), current_stream(device)),
                     "axpby", "b2_axpby", types_of({{"x", &x}, {"y", &y}}));
  return out;
}

at::Tensor cosine_backward_cuda(const at::Tensor& sums, const at::Tensor& g, const at::Tensor& rec,
                                const at::Tensor& data, bool wrt_data) {
  const at::Device device = cuda_device("cosine_backward", "rec", rec);
  const at::Tensor* tensors[] = {&sums, &g, &rec, &data};
  const char* names[] = {"sums", "g", "rec", "data"};
  for (int i = 0; i < 4; ++i) check_typed("cosine_backward", names[i], *tensors[i], device);
  const bool flat = rec.dim() == 1;
  const int64_t rows = flat ? 1 : rec.size(0);
  TORCH_CHECK_VALUE(
      data.sizes() == rec.sizes() &&
          (flat ? sums.dim() == 1 && sums.size(0) == 3 && g.numel() == 1
                : rec.dim() == 2 && rows >= 1 && rows <= kMaxTrials && sums.dim() == 2 && sums.size(0) == rows &&
                      sums.size(1) == 3 && g.dim() == 1 && g.size(0) == rows),
      "breaching::cosine_backward takes flat rec, data of one length with sums (3,) and a one-element g, or rows "
      "(T, n) with sums (T, 3) and g (T,), got ",
      sums.sizes(), ", ", g.sizes(), ", ", rec.sizes(), ", ", data.sizes());
  const c10::cuda::CUDAGuard guard(device);
  const at::Tensor& self = wrt_data ? data : rec;
  const at::Tensor& other = wrt_data ? rec : data;
  at::Tensor out = at::detail::empty_cuda(rec.sizes(), self.options());
  const int64_t n = flat ? rec.numel() : rec.size(1);
  if (all_float({&sums, &g, &rec, &data})) {
    check_launch(b2_cosine_backward(sums.data_ptr<float>(), g.data_ptr<float>(), rec.data_ptr<float>(),
                                    data.data_ptr<float>(), out.data_ptr<float>(), rows, n, wrt_data ? 1 : 0,
                                    current_stream(device)),
                 "b2_cosine_backward");
    return out;
  }
  TORCH_CHECK_VALUE(sums.scalar_type() == acc_type(self) && g.scalar_type() == acc_type(self),
                    "breaching::cosine_backward: sums and g of ", self.scalar_type(), " are ", acc_type(self), ", got ",
                    sums.scalar_type(), " and ", g.scalar_type());
  check_typed_launch(b2_cosine_backward_typed(type_code(self), type_code(other), sums.data_ptr(), g.data_ptr(),
                                              self.data_ptr(), other.data_ptr(), out.data_ptr(), rows, n,
                                              wrt_data ? 1 : 0, current_stream(device)),
                     "cosine_backward", "b2_cosine_backward", types_of({{"rec", &rec}, {"data", &data}}));
  return out;
}

// A non-empty NCHW batch whose planes fit 32-bit sizes.
void check_images(const char* op, const at::Tensor& x) {
  TORCH_CHECK_VALUE(x.dim() == 4 && x.numel() > 0, "breaching::", op, " takes a non-empty NCHW batch, got ",
                    x.sizes());
  TORCH_CHECK_VALUE(x.size(1) <= INT32_MAX && x.size(2) <= INT32_MAX && x.size(3) <= INT32_MAX, "breaching::", op,
                    ": images of ", x.sizes(), " are too large");
}

// The fused TV kernel's workspace: contiguous int32 words on the tensors' device.
void check_tv_workspace(const char* op, const at::Tensor& workspace, const at::Device& device) {
  TORCH_CHECK(workspace.device() == device, "breaching::", op, ": the workspace lies on ", workspace.device(),
              ", the other tensors on ", device);
  TORCH_CHECK_VALUE(workspace.scalar_type() == at::kInt && workspace.is_contiguous() &&
                        workspace.numel() * 4 == b3_tv_workspace_bytes(),
                    "breaching::", op, " takes a contiguous int32 workspace of ", b3_tv_workspace_bytes() / 4,
                    " words");
}

at::Tensor tv_forward_cuda(const at::Tensor& x, double p, double q, double eps, const at::Tensor& workspace) {
  const at::Device device = cuda_device("tv_forward", "x", x);
  check_tensor("tv_forward", "x", x, device);
  check_images("tv_forward", x);
  check_tv_workspace("tv_forward", workspace, device);
  const c10::cuda::CUDAGuard guard(device);
  at::Tensor out = at::detail::empty_cuda({}, x.options());
  check_launch(b3_tv_forward(x.data_ptr<float>(), x.numel(), (int)x.size(2), (int)x.size(3), (float)p, (float)q,
                             (float)eps, workspace.data_ptr(), out.data_ptr<float>(), current_stream(device)),
               "b3_tv_forward");
  return out;
}

std::tuple<at::Tensor, at::Tensor> tv_value_and_grad_cuda(const at::Tensor& x, const at::Tensor& scale, double p,
                                                          double q, double eps, int64_t segments,
                                                          const at::Tensor& workspace) {
  const at::Device device = cuda_device("tv_value_and_grad", "x", x);
  const bool typed = !all_float({&x, &scale});
  check_typed("tv_value_and_grad", "x", x, device);
  check_typed("tv_value_and_grad", "scale", scale, device);
  if (!typed) check_tv_workspace("tv_value_and_grad", workspace, device);
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
  const int parts = (int)std::max<int64_t>(segments, 1);
  if (typed) {  // csrc/precision.cu: scale in x's type, partial sums in scratch
    TORCH_CHECK_VALUE(scale.scalar_type() == x.scalar_type(), "breaching::tv_value_and_grad: the scale of x ",
                      x.scalar_type(), " is ", x.scalar_type(), ", got ", scale.scalar_type());
    const int64_t bytes = b3_tv_partials_bytes(type_code(x), x.numel(), parts);
    at::Tensor partials = at::detail::empty_cuda({std::max<int64_t>(bytes, 1)}, x.options().dtype(at::kByte));
    check_typed_launch(b3_tv_value_and_grad_typed(type_code(x), x.data_ptr(), scale.data_ptr(), x.numel(),
                                                  (int)x.size(2), (int)x.size(3), parts, p, q, eps, partials.data_ptr(),
                                                  values.data_ptr(), grad.data_ptr(), current_stream(device)),
                       "tv_value_and_grad", "b3_tv_value_and_grad", types_of({{"x", &x}}));
    return {values, grad};
  }
  check_launch(b3_tv_value_and_grad(x.data_ptr<float>(), scale.data_ptr<float>(), x.numel(), (int)x.size(2),
                                    (int)x.size(3), parts, (float)p, (float)q, (float)eps,
                                    workspace.data_ptr(), values.data_ptr<float>(), grad.data_ptr<float>(),
                                    current_stream(device)),
               "b3_tv_value_and_grad");
  return {values, grad};
}

at::Device check_box(const char* op, const at::Tensor& x, const at::Tensor& lo, const at::Tensor& hi) {
  const at::Device device = cuda_device(op, "x", x);
  check_typed(op, "x", x, device);
  check_typed(op, "lo", lo, device);
  check_typed(op, "hi", hi, device);
  TORCH_CHECK_VALUE(x.dim() == 4 && lo.dim() == 1 && lo.size(0) == x.size(1) && hi.sizes() == lo.sizes() &&
                        x.size(1) <= INT32_MAX,
                    "breaching::", op, " takes an NCHW batch and bounds of shape (C,), got ", x.sizes(), ", ",
                    lo.sizes(), ", ", hi.sizes());
  TORCH_CHECK_VALUE(lo.scalar_type() == x.scalar_type() && hi.scalar_type() == x.scalar_type(), "breaching::", op,
                    " takes bounds of x's type ", x.scalar_type(), ", got ", lo.scalar_type(), " and ",
                    hi.scalar_type());
  return device;
}

void launch_box(const at::Tensor& x, const at::Tensor& lo, const at::Tensor& hi, const at::Tensor& out,
                const at::Device& device) {
  if (x.numel() == 0) return;  // nothing to clamp
  if (x.scalar_type() != at::kFloat) {
    check_typed_launch(b4_box_project_typed(type_code(x), x.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
                                            x.numel(), x.size(2) * x.size(3), (int)x.size(1), current_stream(device)),
                       "box_project", "b4_box_project", types_of({{"x", &x}}));
    return;
  }
  check_launch(b4_box_project(x.data_ptr<float>(), lo.data_ptr<float>(), hi.data_ptr<float>(),
                              out.data_ptr<float>(), x.numel(), x.size(2) * x.size(3), (int)x.size(1),
                              current_stream(device)),
               "b4_box_project");
}

at::Tensor box_project_cuda(const at::Tensor& x, const at::Tensor& lo, const at::Tensor& hi) {
  const at::Device device = check_box("box_project", x, lo, hi);
  const c10::cuda::CUDAGuard guard(device);
  at::Tensor out = at::detail::empty_cuda(x.sizes(), x.options());
  launch_box(x, lo, hi, out, device);
  return out;
}

void box_project_out_cuda(const at::Tensor& x, const at::Tensor& lo, const at::Tensor& hi, const at::Tensor& out) {
  const at::Device device = check_box("box_project_out", x, lo, hi);
  check_typed("box_project_out", "out", out, device);
  TORCH_CHECK_VALUE(out.sizes() == x.sizes() && out.scalar_type() == x.scalar_type(),
                    "breaching::box_project_out writes into an out of x's shape ", x.sizes(), " and type ",
                    x.scalar_type(), ", got ", out.sizes(), " ", out.scalar_type());
  const c10::cuda::CUDAGuard guard(device);
  launch_box(x, lo, hi, out, device);
}

void adam_box_step_cuda(const at::Tensor& x, const at::Tensor& grad, const at::Tensor& mu, const at::Tensor& nu,
                        const at::Tensor& best, const at::Tensor& lo, const at::Tensor& hi, const at::Tensor& values,
                        const at::Tensor& best_vals, const at::Tensor& new_best_vals, double lr, double b1, double b2,
                        double eps, double bias1, double bias2, double soft_scale, double soft_div, int64_t flags) {
  const char* op = "adam_box_step";
  const at::Device device = cuda_device(op, "x", x);
  const at::Tensor* tensors[] = {&x, &grad, &mu, &nu, &best, &lo, &hi, &values, &best_vals, &new_best_vals};
  const char* names[] = {"x", "grad", "mu", "nu", "best", "lo", "hi", "values", "best_vals", "new_best_vals"};
  const bool typed = x.scalar_type() != at::kFloat;
  for (int i = 0; i < 10; ++i) {
    check_typed(op, names[i], *tensors[i], device);
    // the candidate's type for the first seven, its accumulation type for the values
    const at::ScalarType want = typed ? (i < 7 ? x.scalar_type() : acc_type(x)) : at::kFloat;
    TORCH_CHECK_VALUE(tensors[i]->scalar_type() == want, "breaching::", op, ": ", names[i], " must be ", want,
                      " for a candidate of ", x.scalar_type(), ", got ", tensors[i]->scalar_type());
  }
  const bool stacked = x.dim() == 5;
  const int64_t trials = stacked ? x.size(0) : 1;
  TORCH_CHECK_VALUE((x.dim() == 4 || stacked) && x.numel() > 0 && trials <= kMaxTrials,
                    "breaching::adam_box_step takes a non-empty NCHW candidate or a (T, N, C, H, W) stack of "
                    "trials, got ",
                    x.sizes());
  const int64_t channels = x.size(-3);
  TORCH_CHECK_VALUE(grad.sizes() == x.sizes() && mu.sizes() == x.sizes() && nu.sizes() == x.sizes() &&
                        best.sizes() == x.sizes() && lo.dim() == 1 && lo.size(0) == channels &&
                        hi.sizes() == lo.sizes() && channels <= INT32_MAX,
                    "breaching::adam_box_step takes x, grad, mu, nu and best of one shape and bounds of shape "
                    "(C,), got ",
                    x.sizes(), ", ", grad.sizes(), ", ", mu.sizes(), ", ", nu.sizes(), ", ", best.sizes(), ", ",
                    lo.sizes(), ", ", hi.sizes());
  const bool one_each = values.numel() == trials && best_vals.numel() == trials && new_best_vals.numel() == trials;
  const bool shaped = !stacked || (values.dim() == 1 && best_vals.dim() == 1 && new_best_vals.dim() == 1);
  TORCH_CHECK_VALUE(one_each && shaped, "breaching::adam_box_step takes one-element values, best_vals and "
                    "new_best_vals for a candidate, (T,) each for a stack of T trials, got ", values.sizes(), ", ",
                    best_vals.sizes(), ", ", new_best_vals.sizes(), " for x of ", x.sizes());
  TORCH_CHECK_VALUE(new_best_vals.data_ptr() != best_vals.data_ptr(),
                    "breaching::adam_box_step writes new_best_vals while it reads best_vals: pass two buffers");
  TORCH_CHECK_VALUE(flags >= 0 && flags < 8 && (flags & 5) != 5, "breaching::adam_box_step: flags ", flags,
                    " (bit 0 the hard sign, bit 1 the box, bit 2 the soft sign, not both signs)");
  const c10::cuda::CUDAGuard guard(device);
  if (typed) {
    const double scalars[8] = {lr, b1, b2, eps, bias1, bias2, soft_scale, soft_div};
    check_typed_launch(b4_adam_box_step_typed(type_code(x), x.data_ptr(), grad.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                                              best.data_ptr(), lo.data_ptr(), hi.data_ptr(), values.data_ptr(),
                                              best_vals.data_ptr(), new_best_vals.data_ptr(), trials,
                                              x.numel() / trials, x.size(-2) * x.size(-1), (int)channels, scalars,
                                              (int)flags, current_stream(device)),
                       "adam_box_step", "b4_adam_box_step", types_of({{"x", &x}}));
    return;
  }
  check_launch(b4_adam_box_step(x.data_ptr<float>(), grad.data_ptr<float>(), mu.data_ptr<float>(),
                                nu.data_ptr<float>(), best.data_ptr<float>(), lo.data_ptr<float>(),
                                hi.data_ptr<float>(), values.data_ptr<float>(), best_vals.data_ptr<float>(),
                                new_best_vals.data_ptr<float>(), trials, x.numel() / trials, x.size(-2) * x.size(-1),
                                (int)channels, lr, b1, b2, eps, bias1, bias2, soft_scale, soft_div, (int)flags,
                                current_stream(device)),
               "b4_adam_box_step");
}

// (threads per block, registers per thread, static shared bytes, local (spilled) bytes
// per thread, blocks resident per SM, grid) of one kernel's launch on the current device:
// "b2_axpby" over n floats; "b2_cosine_backward" over n floats in `segments` rows;
// "b3_tv_value_and_grad" (general exponents) or "b3_tv_value_and_grad p=q=1" over n
// elements of h x w planes in `segments` segments; "b4_adam_box_step" over n elements of
// h x w planes in `segments` trials. Nothing is launched.
std::vector<int64_t> launch_config(const std::string& kernel, int64_t n, int64_t h, int64_t w, int64_t segments) {
  int config[6] = {0, 0, 0, 0, 0, 0};
  int status = 0;
  TORCH_CHECK_VALUE(segments >= 1 && n % segments == 0, "breaching::launch_config: ", segments,
                    " segments do not divide ", n);
  if (kernel == "b2_axpby") {
    status = b2_axpby_config(n, config);
  } else if (kernel == "b2_cosine_backward") {
    status = b2_cosine_backward_config(segments, n / segments, config);
  } else if (kernel == "b3_tv_value_and_grad" || kernel == "b3_tv_value_and_grad p=q=1") {
    status = b3_tv_value_and_grad_config(n, (int)h, (int)w, (int)segments, kernel != "b3_tv_value_and_grad",
                                         config);
  } else if (kernel == "b4_adam_box_step") {
    status = b4_adam_box_step_config(segments, n / segments, h * w, config);
  } else {
    TORCH_CHECK_VALUE(false, "breaching::launch_config: no kernel ", kernel);
  }
  check_launch(status, kernel.c_str());
  return std::vector<int64_t>(config, config + 6);
}

}  // namespace

TORCH_LIBRARY(breaching, m) {
  m.def("matching_sums(Tensor rec, Tensor data) -> Tensor");
  m.def("matching_sums_into(Tensor rec, Tensor data, Tensor(a!) out) -> ()");
  m.def("axpby(Tensor a, Tensor x, Tensor b, Tensor y) -> Tensor");
  m.def("cosine_backward(Tensor sums, Tensor g, Tensor rec, Tensor data, bool wrt_data) -> Tensor");
  m.def("tv_forward(Tensor x, float p, float q, float eps, Tensor(a!) workspace) -> Tensor");
  m.def("tv_value_and_grad(Tensor x, Tensor scale, float p, float q, float eps, int segments, "
        "Tensor(a!) workspace) -> (Tensor, Tensor)");
  m.def("box_project(Tensor x, Tensor lo, Tensor hi) -> Tensor");
  m.def("box_project_out(Tensor x, Tensor lo, Tensor hi, Tensor(a!) out) -> ()");
  m.def("adam_box_step(Tensor(a!) x, Tensor grad, Tensor(b!) mu, Tensor(c!) nu, Tensor(d!) best, Tensor lo, "
        "Tensor hi, Tensor values, Tensor best_vals, Tensor(e!) new_best_vals, float lr, float b1, float b2, "
        "float eps, float bias1, float bias2, float soft_scale, float soft_div, int flags) -> ()");
  m.def("launch_config(str kernel, int n, int h, int w, int segments) -> int[]", &launch_config);
}

TORCH_LIBRARY_IMPL(breaching, CUDA, m) {
  m.impl("matching_sums", &matching_sums_cuda);
  m.impl("matching_sums_into", &matching_sums_into_cuda);
  m.impl("axpby", &axpby_cuda);
  m.impl("cosine_backward", &cosine_backward_cuda);
  m.impl("tv_forward", &tv_forward_cuda);
  m.impl("tv_value_and_grad", &tv_value_and_grad_cuda);
  m.impl("box_project", &box_project_cuda);
  m.impl("box_project_out", &box_project_out_cuda);
  m.impl("adam_box_step", &adam_box_step_cuda);
}
