// The serving programs on ATen (see torch_programs.hpp). Each function
// names the Python function it mirrors; the operations, their order, their
// dtypes and their scalar arguments are the Python's, so that cuBLAS,
// cuDNN and the CPU kernels see the same calls. A Python float scalar is a
// double here too.
#include "torch_programs.hpp"

#include <ATen/TensorIndexing.h>

#include <algorithm>
#include <cmath>
#include <stdexcept>

#ifdef DLIMG_SERVING_CUDA
#include <ATen/cuda/CUDAContext.h>
#include <ATen/cuda/CUDAEvent.h>
#include <c10/cuda/CUDAGuard.h>
#endif

namespace dlimg_torch {

std::atomic<int64_t> g_layer_norm_launches{0};
std::atomic<int64_t> g_levit_attention_launches{0};
std::atomic<int64_t> g_add_layer_norm_launches{0};
std::atomic<int64_t> g_relpos_global_launches{0};
std::atomic<int64_t> g_relpos_windowed_launches{0};
std::atomic<int64_t> g_greedy_nms_launches{0};
std::atomic<int64_t> g_quantize_rows_launches{0};
std::atomic<int64_t> g_int8_epilogue_launches{0};
std::atomic<int64_t> g_int8_products{0};
std::atomic<int64_t> g_dequantised_products{0};

namespace {

using at::Tensor;
using at::indexing::Ellipsis;
using at::indexing::Slice;

// Python's 2.0 * np.pi.
constexpr double kTwoPi = 2.0 * 3.141592653589793;
// ops/fused_norm.py KERNEL_WIDTHS; ops/flash_attention.py KERNEL_HEAD_DIM,
// KERNEL_MAX_TOKENS.
constexpr int64_t kLayerNormWidths[] = {128, 160, 256, 320, 768, 1024, 1280};
constexpr int64_t kLevitHeadDim = 32;
constexpr int64_t kLevitMaxTokens = 256;
// ops/flash_attention.py KERNEL_HEAD_DIMS, WINDOW_MAX_SIDE.
constexpr int64_t kRelposHeadDims[] = {64, 80};
constexpr int64_t kWindowMaxSide = 16;
// ops/quant.py QUANT_ROW_WIDTHS (P2's instances), INT8_MM_MIN_ROWS.
constexpr int64_t kQuantRowWidths[] = {128, 160, 320, 512, 640, 768,
                                       1024, 1280, 3072, 4096, 5120};
constexpr int64_t kInt8MmMinRows = 17;
// An absent Optional[int] of the Python signatures.
constexpr int64_t kNone = -1;

[[noreturn]] void fail(const std::string& msg) {
  throw std::runtime_error(msg);
}

const Tensor& W(const Weights& w, const std::string& name) {
  auto it = w.find(name);
  if (it == w.end()) fail("the program's weights lack " + name);
  return it->second;
}

bool has(const Weights& w, const std::string& name) {
  return w.find(name) != w.end();
}

at::TensorOptions on(const Tensor& like, at::ScalarType dtype) {
  return at::TensorOptions().dtype(dtype).device(like.device());
}

Tensor zeros0(const Tensor& like) {  // torch.zeros((), device=dev)
  return at::zeros(at::IntArrayRef{}, on(like, at::kFloat));
}

Tensor clamp_min(const Tensor& t, double lo) {  // torch.clamp(t, min=lo)
  return at::clamp(t, std::optional<at::Scalar>(lo),
                   std::optional<at::Scalar>());
}

Tensor clamp_max(const Tensor& t, double hi) {  // torch.clamp(t, max=hi)
  return at::clamp(t, std::optional<at::Scalar>(),
                   std::optional<at::Scalar>(hi));
}

int dtype_code(at::ScalarType t) {  // ops/cuda_build.py DTYPE_CODES
  if (t == at::kFloat) return 0;
  if (t == at::kBFloat16) return 1;
  return -1;
}

void* current_stream() {
#ifdef DLIMG_SERVING_CUDA
  return static_cast<void*>(at::cuda::getCurrentCUDAStream().stream());
#else
  fail("this serving library was built without CUDA");
#endif
}

// ---------------------------------------------------------------------------
// models/common.py
// ---------------------------------------------------------------------------

// gelu: the erf form in float32, the tanh approximation in bfloat16.
Tensor gelu_(const Tensor& x) {
  return at::gelu(x, x.scalar_type() == at::kBFloat16 ? "tanh" : "none");
}

// conv2d: NHWC in and out, OIHW kernel in x's dtype.
Tensor conv2d_(const Tensor& x, const Tensor& w, int64_t stride = 1,
              int64_t padding = 0, int64_t groups = 1) {
  Tensor y = at::conv2d(x.permute({0, 3, 1, 2}), w.to(x.scalar_type()),
                        std::optional<Tensor>(), {stride, stride},
                        {padding, padding}, {1, 1}, groups);
  return y.permute({0, 2, 3, 1}).contiguous();
}

// conv_transpose2d: kernel_size == stride, as an einsum and a reshape.
Tensor conv_transpose2d_(const Tensor& x, const Tensor& w) {
  const int64_t B = x.size(0), H = x.size(1), Wd = x.size(2);
  const int64_t k = w.size(2), O = w.size(0);
  Tensor y = at::einsum("bhwc,ocpq->bhpwqo", {x, w.to(x.scalar_type())});
  return y.reshape({B, H * k, Wd * k, O});
}

// conv_bn: the ConvBN module's groups are its kernel's input split.
Tensor conv_bn(const Weights& w, const std::string& p, const Tensor& x,
               int64_t stride, int64_t padding) {
  const Tensor& k = W(w, p + ".w");
  const int64_t groups = x.size(3) / k.size(1);
  Tensor y = conv2d_(x, k, stride, padding, groups);
  return y * W(w, p + ".scale").to(y.scalar_type()) +
         W(w, p + ".bias").to(y.scalar_type());
}

// ops/fused_norm.py layer_norm_plain (also models/common.py layer_norm).
Tensor layer_norm_plain(const Tensor& x, const Tensor& scale,
                        const Tensor& bias, double eps) {
  Tensor x32 = x.to(at::kFloat);
  Tensor mean = at::mean(x32, at::IntArrayRef{-1}, true);
  Tensor mean_sq = at::mean(x32 * x32, at::IntArrayRef{-1}, true);
  Tensor var = clamp_min(mean_sq - mean * mean, 0.0);
  Tensor y = (x32 - mean) * at::rsqrt(var + eps);
  return (y * scale.to(at::kFloat) + bias.to(at::kFloat))
      .to(x.scalar_type());
}

Tensor layer_norm(const Weights& w, const std::string& p, const Tensor& x,
                  double eps = 1e-5) {
  return layer_norm_plain(x, W(w, p + ".scale"), W(w, p + ".bias"), eps);
}

// ---------------------------------------------------------------------------
// ops/quant.py: the int8 linears. P2 quantize_rows_int8 and P3
// int8_epilogue launch their kernels on a CUDA tensor and compute their
// plain versions on a CPU tensor; the s8 x s8 product is at::_int_mm.
// ---------------------------------------------------------------------------

// _div127: t / 127 as one IEEE division per element (through a 0-d tensor:
// a scalar divisor becomes a reciprocal product on CUDA).
Tensor div127(const Tensor& t) {
  return t / at::full(at::IntArrayRef{}, 127.0, on(t, t.scalar_type()));
}

// quantize_activations_int8, P2's plain version: x (..., C) -> (q int8
// (..., C), scale float32 (..., 1)).
std::pair<Tensor, Tensor> quantize_activations_int8(const Tensor& x) {
  Tensor x32 = x.to(at::kFloat);
  Tensor scale = div127(clamp_min(at::amax(at::abs(x32), {-1}, true), 1e-8));
  Tensor q = at::clamp(at::round(x32 / scale),
                       std::optional<at::Scalar>(int64_t(-127)),
                       std::optional<at::Scalar>(int64_t(127)))
                 .to(at::kChar);
  return {q, scale};
}

// int8_epilogue_plain, P3's plain version: (acc * x_scale) * w_scale
// rounded to dtype, then the bias added in dtype.
Tensor int8_epilogue_plain(const Tensor& acc, const Tensor& x_scale,
                           const Tensor& w_scale, const Tensor* b,
                           at::ScalarType dtype) {
  Tensor y = (acc.to(at::kFloat) * x_scale * w_scale.to(at::kFloat)).to(dtype);
  if (b) y = y + b->to(dtype);
  return y;
}

// _check_cuda
void check_quant_kernel(const char* name, const std::vector<Tensor>& ts,
                        at::ScalarType dtype) {
  if (dtype_code(dtype) < 0)
    fail(std::string(name) + ": the CUDA kernel takes float32 or bfloat16, "
         "not " + c10::toString(dtype));
  for (const Tensor& t : ts) {
    if (t.device() != ts[0].device())
      fail(std::string(name) + ": all inputs must share a device");
    if (!t.is_contiguous())
      fail(std::string(name) + ": inputs must be contiguous");
  }
}

// quantize_rows_int8 (P2): x (M, C) -> (q int8 (M, C), scale float32 (M, 1)).
std::pair<Tensor, Tensor> quantize_rows_int8(const Tensor& x,
                                             const Kernels* kernels) {
  if (x.is_cpu()) return quantize_activations_int8(x);
  if (!x.is_cuda()) fail("quantize_rows_int8: unsupported device");
  check_quant_kernel("quantize_rows_int8", {x}, x.scalar_type());
  const int64_t C = x.size(-1);
  bool width_ok = false;
  for (int64_t c : kQuantRowWidths) width_ok |= c == C;
  if (!width_ok)
    fail("quantize_rows_int8: no CUDA kernel for width " + std::to_string(C));
  if (kernels == nullptr || kernels->quantize_rows_int8 == nullptr)
    fail("quantize_rows_int8: the kernel library is not loaded");
  Tensor q = at::empty(x.sizes(), on(x, at::kChar));
  std::vector<int64_t> sdims = x.sizes().vec();
  sdims.back() = 1;
  Tensor scale = at::empty(sdims, on(x, at::kFloat));
  int rc = kernels->quantize_rows_int8(
      x.data_ptr(), q.data_ptr(), scale.data_ptr(), int(x.numel() / C),
      int(C), dtype_code(x.scalar_type()), current_stream());
  if (rc != 0)
    fail("CUDA kernel quantize_rows_int8 failed to launch: cudaError " +
         std::to_string(rc));
  ++g_quantize_rows_launches;
  return {q, scale};
}

// int8_epilogue (P3): acc (M, N) int32, x_scale (M, 1), w_scale (N,)
// float32, b (N,) or null -> y (M, N) in dtype.
Tensor int8_epilogue(const Tensor& acc, const Tensor& x_scale,
                     const Tensor& w_scale, const Tensor* b,
                     at::ScalarType dtype, const Kernels* kernels) {
  const int64_t M = acc.size(0), N = acc.size(1);
  if (x_scale.sizes() != at::IntArrayRef{M, 1} ||
      w_scale.sizes() != at::IntArrayRef{N})
    fail("int8_epilogue: x_scale must be (" + std::to_string(M) +
         ", 1) and w_scale (" + std::to_string(N) + ",)");
  if (b && b->sizes() != at::IntArrayRef{N})
    fail("int8_epilogue: b must be (" + std::to_string(N) + ",)");
  if (acc.is_cpu()) return int8_epilogue_plain(acc, x_scale, w_scale, b, dtype);
  if (!acc.is_cuda()) fail("int8_epilogue: unsupported device");
  Tensor bias = b ? b->to(dtype) : Tensor();
  std::vector<Tensor> ts{acc, x_scale, w_scale};
  if (b) ts.push_back(bias);
  check_quant_kernel("int8_epilogue", ts, dtype);
  if (acc.scalar_type() != at::kInt || x_scale.scalar_type() != at::kFloat ||
      w_scale.scalar_type() != at::kFloat)
    fail("int8_epilogue: acc must be int32, x_scale and w_scale float32");
  if (N % 4 || reinterpret_cast<uintptr_t>(acc.data_ptr()) % 16)
    fail("int8_epilogue: N (" + std::to_string(N) + ") must be a multiple of "
         "4 and acc 16-byte aligned");
  if (kernels == nullptr || kernels->int8_epilogue == nullptr)
    fail("int8_epilogue: the kernel library is not loaded");
  Tensor y = at::empty({M, N}, on(acc, dtype));
  int rc = kernels->int8_epilogue(acc.data_ptr(), x_scale.data_ptr(),
                                  w_scale.data_ptr(),
                                  b ? bias.data_ptr() : nullptr, y.data_ptr(),
                                  int(M), int(N), dtype_code(dtype),
                                  current_stream());
  if (rc != 0)
    fail("CUDA kernel int8_epilogue failed to launch: cudaError " +
         std::to_string(rc));
  ++g_int8_epilogue_launches;
  return y;
}

// pad_rows: q (M, K) with zero rows appended up to `rows`.
Tensor pad_rows(const Tensor& q, int64_t rows = kInt8MmMinRows) {
  const int64_t M = q.size(0);
  if (M >= rows) return q;
  return at::cat({q, at::zeros({rows - M, q.size(1)}, q.options())});
}

// int8_mm: (M, K) int8 x (K, N) int8 -> (M, N) int32, exact; on the card
// cuBLASLt takes M > 16 (fewer rows are padded and sliced back) and K, N
// multiples of 8 (another shape raises: no float product in its place).
Tensor int8_mm(const Tensor& q, const Tensor& w_q8) {
  const int64_t M = q.size(0), K = q.size(1), N = w_q8.size(1);
  if (!q.is_cuda()) return at::_int_mm(q, w_q8);
  if (K % 8 || N % 8)
    fail("int8_mm: the CUDA int8 product needs K and N multiples of 8, got (" +
         std::to_string(M) + ", " + std::to_string(K) + ") x (" +
         std::to_string(K) + ", " + std::to_string(N) + ")");
  return at::_int_mm(pad_rows(q), w_q8).slice(0, 0, M);
}

// int8_linear: y = (q_x @ w_q8) * x_scale * w_scale + b in x's dtype.
Tensor int8_linear(const Weights& w, const std::string& p, const Tensor& x,
                   const Kernels* kernels) {
  const int64_t C = x.size(-1);
  auto [q, x_scale] = quantize_rows_int8(x.reshape({-1, C}).contiguous(),
                                         kernels);
  Tensor acc = int8_mm(q, W(w, p + ".w_q8"));
  const std::string b = p + ".b";
  Tensor y = int8_epilogue(acc, x_scale, W(w, p + ".w_scale"),
                           has(w, b) ? &W(w, b) : nullptr, x.scalar_type(),
                           kernels);
  ++g_int8_products;
  std::vector<int64_t> dims = x.sizes().vec();
  dims.back() = y.size(-1);
  return y.reshape(dims);
}

// models/common.py linear: x @ w (+ b), dispatched on what the weights
// hold: w_q8 runs int8_linear (its kernels from `kernels` on a CUDA
// tensor), w_q is dequantised per call in float32 and rounded once to x's
// dtype, w is used in x's dtype.
Tensor linear(const Weights& w, const std::string& p, const Tensor& x,
              const Kernels* kernels = nullptr) {
  if (has(w, p + ".w_q8")) return int8_linear(w, p, x, kernels);
  Tensor wt;
  if (has(w, p + ".w_q")) {
    wt = (W(w, p + ".w_q").to(at::kFloat) *
          W(w, p + ".w_scale").to(at::kFloat))
             .to(x.scalar_type());
    ++g_dequantised_products;
  } else {
    wt = W(w, p + ".w").to(x.scalar_type());
  }
  Tensor y = at::matmul(x, wt);
  if (has(w, p + ".b")) y = y + W(w, p + ".b").to(x.scalar_type());
  return y;
}

// Whether the weights hold a linear at p, float or int8.
bool has_linear(const Weights& w, const std::string& p) {
  return has(w, p + ".w") || has(w, p + ".w_q") || has(w, p + ".w_q8");
}

// ---------------------------------------------------------------------------
// ops/fused_norm.py fused_layer_norm (K1) and ops/flash_attention.py
// levit_window_attention (K2): the kernel on a CUDA tensor, the plain
// version on a CPU tensor.
// ---------------------------------------------------------------------------

// ops/fused_norm.py _check's CUDA conditions, for K1 and K3.
void check_norm_kernel(const char* name, const std::vector<Tensor>& ts) {
  const Tensor& x = ts[0];
  const int code = dtype_code(x.scalar_type());
  bool same = true, contiguous = true;
  for (const Tensor& t : ts) {
    same &= t.scalar_type() == x.scalar_type();
    contiguous &= t.is_contiguous();
  }
  if (code < 0 || !same)
    fail(std::string(name) + ": the CUDA kernel takes float32 or bfloat16 "
         "inputs of x's dtype");
  bool width_ok = false;
  for (int64_t c : kLayerNormWidths) width_ok |= c == x.size(-1);
  if (!width_ok)
    fail(std::string(name) + ": no CUDA kernel for width " +
         std::to_string(x.size(-1)));
  if (!contiguous) fail(std::string(name) + ": inputs must be contiguous");
}

Tensor fused_layer_norm(const Tensor& x, const Tensor& scale,
                        const Tensor& bias, double eps,
                        const Kernels* kernels) {
  const int64_t C = x.size(-1);
  if (scale.dim() != 1 || scale.size(0) != C || bias.dim() != 1 ||
      bias.size(0) != C)
    fail("fused_layer_norm: scale and bias must be (" + std::to_string(C) +
         ",)");
  if (scale.device() != x.device() || bias.device() != x.device())
    fail("fused_layer_norm: all inputs must share a device");
  if (x.is_cpu()) return layer_norm_plain(x, scale, bias, eps);
  if (!x.is_cuda()) fail("fused_layer_norm: unsupported device");
  check_norm_kernel("fused_layer_norm", {x, scale, bias});
  const int code = dtype_code(x.scalar_type());
  if (kernels == nullptr || kernels->layer_norm == nullptr)
    fail("fused_layer_norm: the kernel library is not loaded");
  Tensor out = at::empty_like(x);
  const int64_t rows = C ? x.numel() / C : 0;
  int rc = kernels->layer_norm(x.data_ptr(), scale.data_ptr(),
                               bias.data_ptr(), out.data_ptr(), int(rows),
                               int(C), code, float(eps), current_stream());
  if (rc != 0)
    fail("CUDA kernel fused_layer_norm failed to launch: cudaError " +
         std::to_string(rc));
  ++g_layer_norm_launches;
  return out;
}

std::pair<Tensor, Tensor> fused_add_layer_norm_plain(const Tensor& x,
                                                     const Tensor& delta,
                                                     const Tensor& scale,
                                                     const Tensor& bias,
                                                     double eps) {
  Tensor s = (x.to(at::kFloat) + delta.to(at::kFloat)).to(x.scalar_type());
  return {s, layer_norm_plain(s, scale, bias, eps)};
}

// ops/fused_norm.py fused_add_layer_norm (K3): (x + delta, LN(x + delta)).
std::pair<Tensor, Tensor> fused_add_layer_norm(const Tensor& x,
                                               const Tensor& delta,
                                               const Tensor& scale,
                                               const Tensor& bias, double eps,
                                               const Kernels* kernels) {
  const int64_t C = x.size(-1);
  if (scale.dim() != 1 || scale.size(0) != C || bias.dim() != 1 ||
      bias.size(0) != C)
    fail("fused_add_layer_norm: scale and bias must be (" +
         std::to_string(C) + ",)");
  if (delta.sizes() != x.sizes())
    fail("fused_add_layer_norm: delta must have x's shape");
  if (scale.device() != x.device() || bias.device() != x.device() ||
      delta.device() != x.device())
    fail("fused_add_layer_norm: all inputs must share a device");
  if (x.is_cpu()) return fused_add_layer_norm_plain(x, delta, scale, bias, eps);
  if (!x.is_cuda()) fail("fused_add_layer_norm: unsupported device");
  check_norm_kernel("fused_add_layer_norm", {x, scale, bias, delta});
  if (kernels == nullptr || kernels->add_layer_norm == nullptr)
    fail("fused_add_layer_norm: the kernel library is not loaded");
  Tensor s = at::empty_like(x);
  Tensor out = at::empty_like(x);
  const int64_t rows = C ? x.numel() / C : 0;
  int rc = kernels->add_layer_norm(
      x.data_ptr(), delta.data_ptr(), scale.data_ptr(), bias.data_ptr(),
      s.data_ptr(), out.data_ptr(), int(rows), int(C),
      dtype_code(x.scalar_type()), float(eps), current_stream());
  if (rc != 0)
    fail("CUDA kernel fused_add_layer_norm failed to launch: cudaError " +
         std::to_string(rc));
  ++g_add_layer_norm_launches;
  return {s, out};
}

Tensor levit_window_attention_plain(const Tensor& qkv, const Tensor& bias,
                                    int64_t nh) {
  const int64_t G = qkv.size(0), N = qkv.size(1), H = qkv.size(2);
  const int64_t kd = H / (3 * nh);
  Tensor qkv4 = qkv.reshape({G, N, nh, 3 * kd});
  Tensor q = qkv4.index({Ellipsis, Slice(0, kd)}).to(at::kFloat);
  Tensor k = qkv4.index({Ellipsis, Slice(kd, 2 * kd)}).to(at::kFloat);
  Tensor v = qkv4.index({Ellipsis, Slice(2 * kd)});
  Tensor s = at::einsum("gnhd,gmhd->ghnm", {q, k}) *
             std::pow(double(kd), -0.5);
  s = s + bias.to(at::kFloat).unsqueeze(0);
  Tensor p = at::softmax(s, -1).to(qkv.scalar_type());
  Tensor out = at::einsum("ghnm,gmhd->gnhd",
                          {p.to(at::kFloat), v.to(at::kFloat)});
  return out.to(qkv.scalar_type()).reshape({G, N, nh * kd});
}

Tensor levit_window_attention(Tensor qkv, const Tensor& bias, int64_t nh,
                              const Kernels* kernels) {
  if (qkv.dim() != 3) fail("levit_window_attention: qkv must be (G, N, H)");
  const int64_t G = qkv.size(0), N = qkv.size(1), H = qkv.size(2);
  if (H % (nh * 3))
    fail("levit_window_attention: qkv's channels are not nh * 3 * kd");
  const int64_t kd = H / (nh * 3);
  if (bias.dim() != 3 || bias.size(0) != nh || bias.size(1) != N ||
      bias.size(2) != N)
    fail("levit_window_attention: bias must be (nh, N, N)");
  if (qkv.device() != bias.device())
    fail("levit_window_attention: qkv and bias must share a device");
  if (qkv.is_cpu()) return levit_window_attention_plain(qkv, bias, nh);
  if (!qkv.is_cuda()) fail("levit_window_attention: unsupported device");
  const int code = dtype_code(qkv.scalar_type());
  if (code < 0 || bias.scalar_type() != qkv.scalar_type())
    fail("levit_window_attention: the CUDA kernel takes float32 or "
         "bfloat16 qkv and bias of one dtype");
  if (kd != kLevitHeadDim || N <= 0 || N > kLevitMaxTokens)
    fail("levit_window_attention: the CUDA kernel takes kd == 32 and "
         "N <= 256");
  if (!qkv.is_contiguous() || !bias.is_contiguous())
    fail("levit_window_attention: inputs must be contiguous");
  if (kernels == nullptr || kernels->levit_attention == nullptr)
    fail("levit_window_attention: the kernel library is not loaded");
  // The bf16 kernel reads qkv in 16-byte chunks.
  if (qkv.scalar_type() == at::kBFloat16 &&
      reinterpret_cast<uintptr_t>(qkv.data_ptr()) % 16)
    qkv = qkv.clone();
  Tensor out = at::empty({G, N, nh * kd}, on(qkv, qkv.scalar_type()));
  int rc = kernels->levit_attention(
      qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), int(G), int(N),
      int(nh), int(kd), code, float(std::pow(double(kd), -0.5)),
      current_stream());
  if (rc != 0)
    fail("CUDA kernel levit_window_attention failed to launch: cudaError " +
         std::to_string(rc));
  ++g_levit_attention_launches;
  return out;
}


// ---------------------------------------------------------------------------
// ops/flash_attention.py: the SAM ViT's rel-pos attention, routed to
// relpos_attention_windowed (K5) or relpos_attention_global (K4); each
// kernel on a CUDA tensor, attention_relpos_plain on a CPU tensor.
// ---------------------------------------------------------------------------

// _bias_halves: [q.rh | q.rw] (G, N, gh + gw) in q's dtype; out_scale
// multiplies the float32 result before the one rounding.
Tensor bias_halves(const Tensor& q, const Tensor& rh_g, const Tensor& rw_g,
                   int64_t gh, int64_t gw, double out_scale) {
  const int64_t G = q.size(0), N = q.size(1), hd = q.size(2);
  Tensor q4 = q.to(at::kFloat).reshape({G, gh, gw, hd});
  Tensor bh = at::einsum("ghwd,hyd->ghwy",
                         {q4, rh_g.to(q.scalar_type()).to(at::kFloat)});
  Tensor bw = at::einsum("ghwd,wyd->ghwy",
                         {q4, rw_g.to(q.scalar_type()).to(at::kFloat)});
  Tensor b = at::cat({bh, bw}, -1).reshape({G, N, gh + gw});
  if (out_scale != 1.0) b = b * out_scale;
  return b.to(q.scalar_type());
}

// _skip_rows: (first group with the pad-query skip, query rows it keeps).
std::pair<int64_t, int64_t> skip_rows(int64_t G, int64_t N, int64_t gh,
                                      int64_t gw, int64_t heads, int64_t n_w,
                                      int64_t valid_rows) {
  if (heads == kNone || n_w == kNone || valid_rows == kNone) return {G, N};
  const int64_t Wn = G / heads;
  if (0 < valid_rows && valid_rows < gh && 0 < n_w && n_w < Wn)
    return {(Wn - n_w) * heads, valid_rows * gw};
  return {G, N};
}

Tensor attention_relpos_plain(const Tensor& q, const Tensor& k,
                              const Tensor& v, const Tensor& bhw, int64_t gh,
                              int64_t gw, bool folded, int64_t heads,
                              int64_t n_w, int64_t valid_rows) {
  const int64_t G = q.size(0), N = q.size(1), hd = q.size(2);
  const double scale = std::pow(double(hd), -0.5);
  Tensor tok = at::arange(N, on(q, at::kLong));
  Tensor b = bhw.to(at::kFloat);
  Tensor bias =
      b.index({Slice(), Slice(), Slice(at::indexing::None, gh)})
          .index({Slice(), Slice(), at::floor_divide(tok, gw)}) +
      b.index({Slice(), Slice(), Slice(gh)})
          .index({Slice(), Slice(), at::remainder(tok, gw)});
  Tensor qk = at::matmul(q.to(at::kFloat), k.to(at::kFloat).transpose(1, 2));
  Tensor s = folded ? (qk + bias) * scale : qk * scale + bias;
  Tensor p = at::softmax(s, -1).to(q.scalar_type());
  Tensor out = at::matmul(p.to(at::kFloat), v.to(at::kFloat))
                   .to(q.scalar_type());
  auto [g_skip, n_valid] = skip_rows(G, N, gh, gw, heads, n_w, valid_rows);
  if (g_skip < G) out.index({Slice(g_skip), Slice(n_valid)}).fill_(0);
  return out;
}

// _check_relpos's CUDA conditions, for K4 and K5.
void check_relpos_kernel(const char* name, const Tensor& q, const Tensor& k,
                         const Tensor& v, const Tensor& bhw) {
  const int code = dtype_code(q.scalar_type());
  bool same = true, contiguous = true;
  for (const Tensor* t : {&q, &k, &v, &bhw}) {
    same &= t->scalar_type() == q.scalar_type();
    contiguous &= t->is_contiguous();
  }
  if (code < 0 || !same)
    fail(std::string(name) + ": the CUDA kernel takes float32 or bfloat16 "
         "inputs of one dtype");
  bool hd_ok = false;
  for (int64_t hd : kRelposHeadDims) hd_ok |= hd == q.size(2);
  if (!hd_ok)
    fail(std::string(name) + ": no CUDA kernel for head width " +
         std::to_string(q.size(2)));
  if (!contiguous) fail(std::string(name) + ": inputs must be contiguous");
}

void check_relpos_shapes(const char* name, const Tensor& q, const Tensor& k,
                         const Tensor& v, const Tensor& bhw, int64_t gh,
                         int64_t gw) {
  if (q.dim() != 3 || k.sizes() != q.sizes() || v.sizes() != q.sizes())
    fail(std::string(name) + ": q, k, v must be (G, N, hd) of one shape");
  if (q.size(1) != gh * gw)
    fail(std::string(name) + ": N is not grid_h * grid_w");
  if (bhw.dim() != 3 || bhw.size(0) != q.size(0) || bhw.size(1) != q.size(1) ||
      bhw.size(2) != gh + gw)
    fail(std::string(name) + ": bias halves must be (G, N, gh + gw)");
  for (const Tensor* t : {&k, &v, &bhw})
    if (t->device() != q.device())
      fail(std::string(name) + ": all inputs must share a device");
}

Tensor relpos_attention_global(const Tensor& q, const Tensor& k,
                               const Tensor& v, const Tensor& bhw, int64_t gh,
                               int64_t gw, const Kernels* kernels) {
  const char* name = "relpos_attention_global";
  check_relpos_shapes(name, q, k, v, bhw, gh, gw);
  if (q.is_cpu())
    return attention_relpos_plain(q, k, v, bhw, gh, gw, false, kNone, kNone,
                                  kNone);
  if (!q.is_cuda()) fail("relpos_attention_global: unsupported device");
  check_relpos_kernel(name, q, k, v, bhw);
  if (kernels == nullptr || kernels->relpos_attention_global == nullptr)
    fail("relpos_attention_global: the kernel library is not loaded");
  const int64_t G = q.size(0), N = q.size(1), hd = q.size(2);
  Tensor out = at::empty_like(q);
  int rc = kernels->relpos_attention_global(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), bhw.data_ptr(),
      out.data_ptr(), int(G), int(N), int(hd), int(gh), int(gw),
      dtype_code(q.scalar_type()), float(std::pow(double(hd), -0.5)),
      current_stream());
  if (rc != 0)
    fail("CUDA kernel relpos_attention_global failed to launch: cudaError " +
         std::to_string(rc));
  ++g_relpos_global_launches;
  return out;
}

Tensor relpos_attention_windowed(const Tensor& q, const Tensor& k,
                                 const Tensor& v, const Tensor& bhw,
                                 int64_t gh, int64_t gw, int64_t heads,
                                 bool folded, int64_t n_w, int64_t valid_rows,
                                 const Kernels* kernels) {
  const char* name = "relpos_attention_windowed";
  check_relpos_shapes(name, q, k, v, bhw, gh, gw);
  if (q.size(0) % heads)
    fail("relpos_attention_windowed: G is not a multiple of heads");
  if (q.is_cpu())
    return attention_relpos_plain(q, k, v, bhw, gh, gw, folded, heads, n_w,
                                  valid_rows);
  if (!q.is_cuda()) fail("relpos_attention_windowed: unsupported device");
  check_relpos_kernel(name, q, k, v, bhw);
  if (q.scalar_type() == at::kBFloat16 && std::max(gh, gw) > kWindowMaxSide)
    fail("relpos_attention_windowed: the bf16 CUDA kernel takes windows of "
         "at most 16 x 16 tokens");
  if (kernels == nullptr || kernels->relpos_attention_windowed == nullptr)
    fail("relpos_attention_windowed: the kernel library is not loaded");
  const int64_t G = q.size(0), N = q.size(1), hd = q.size(2);
  auto [g_skip, n_valid] = skip_rows(G, N, gh, gw, heads, n_w, valid_rows);
  Tensor out = at::empty_like(q);
  int rc = kernels->relpos_attention_windowed(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), bhw.data_ptr(),
      out.data_ptr(), int(G), int(N), int(hd), int(gh), int(gw), int(folded),
      int(g_skip), int(n_valid), dtype_code(q.scalar_type()),
      float(std::pow(double(hd), -0.5)), current_stream());
  if (rc != 0)
    fail("CUDA kernel relpos_attention_windowed failed to launch: "
         "cudaError " + std::to_string(rc));
  ++g_relpos_windowed_launches;
  return out;
}

// _jax_window: JAX's condition for its windowed kernel.
bool jax_window(int64_t G, int64_t N, int64_t heads) {
  return heads != kNone && N <= 256 && G % heads == 0;
}

// relpos_route == "windowed": JAX's windowed kernel, and the window fits
// K5 (the bf16 body takes sides of at most 16).
bool windowed_route(at::ScalarType dtype, int64_t G, int64_t gh, int64_t gw,
                    int64_t heads) {
  return jax_window(G, gh * gw, heads) &&
         (dtype != at::kBFloat16 || std::max(gh, gw) <= kWindowMaxSide);
}

// flash_attention_relpos with gathered (g, g, hd) tables.
Tensor flash_attention_relpos(Tensor q, Tensor k, Tensor v, const Tensor& rh,
                              const Tensor& rw, int64_t gh, int64_t gw,
                              int64_t heads, int64_t n_w, int64_t valid_rows,
                              const Kernels* kernels) {
  const int64_t G = q.size(0), N = q.size(1), hd = q.size(2);
  Tensor rh_g = rh.to(q.scalar_type()), rw_g = rw.to(q.scalar_type());
  q = q.contiguous();
  k = k.contiguous();
  v = v.contiguous();
  if (windowed_route(q.scalar_type(), G, gh, gw, heads)) {
    const bool folded = hd + gh + gw <= 128;
    Tensor bhw = bias_halves(
        q, rh_g, rw_g, gh, gw,
        folded ? 1.0 / std::pow(double(hd), -0.5) : 1.0);
    return relpos_attention_windowed(q, k, v, bhw, gh, gw, heads, folded, n_w,
                                     valid_rows, kernels);
  }
  Tensor bhw = bias_halves(q, rh_g, rw_g, gh, gw, 1.0);
  Tensor out = relpos_attention_global(q, k, v, bhw, gh, gw, kernels);
  if (jax_window(G, N, heads)) {
    auto [g_skip, n_valid] = skip_rows(G, N, gh, gw, heads, n_w, valid_rows);
    out.index({Slice(g_skip), Slice(n_valid)}).fill_(0);
  }
  return out;
}

// ---------------------------------------------------------------------------
// models/tinyvit.py; the kernel route is the bundle's (use_fused_norm, K1,
// and use_flash_attention, K2, which the Environment turns on together for
// CUDA devices).
// ---------------------------------------------------------------------------

Tensor tv_ln(const Weights& w, const std::string& p, const Tensor& x,
             const ProgramConfig& c, double eps = 1e-5) {
  if (!c.kernel_route)
    return layer_norm_plain(x, W(w, p + ".scale"), W(w, p + ".bias"), eps);
  return fused_layer_norm(x, W(w, p + ".scale"), W(w, p + ".bias"), eps,
                          c.kernels);
}

Tensor tv_attention(const Weights& w, const std::string& p, Tensor x,
                    const ProgramConfig& c) {
  x = tv_ln(w, p + ".norm", x, c);
  Tensor qkv = linear(w, p + ".qkv", x, c.kernels);
  const Tensor& biases = W(w, p + ".attention_biases");
  Tensor bias = biases.index({Slice(), W(w, p + ".bias_idxs")});
  Tensor out =
      c.kernel_route
          ? levit_window_attention(qkv, bias, biases.size(0), c.kernels)
          : levit_window_attention_plain(qkv, bias, biases.size(0));
  return linear(w, p + ".proj", out, c.kernels);
}

Tensor tv_mbconv(const Weights& w, const std::string& p, Tensor x) {
  Tensor shortcut = x;
  x = gelu_(conv_bn(w, p + ".conv1", x, 1, 0));
  x = gelu_(conv_bn(w, p + ".conv2", x, 1, 1));
  x = conv_bn(w, p + ".conv3", x, 1, 0);
  return gelu_(x + shortcut);
}

Tensor tv_patch_merging(const Weights& w, const std::string& p, Tensor x,
                        int64_t stride) {
  x = gelu_(conv_bn(w, p + ".conv1", x, 1, 0));
  x = gelu_(conv_bn(w, p + ".conv2", x, stride, 1));
  return conv_bn(w, p + ".conv3", x, 1, 0);
}

Tensor tv_mlp_ln(const Weights& w, const std::string& p, const Tensor& x,
                 const ProgramConfig& c) {
  Tensor y = tv_ln(w, p + ".norm", x, c);
  y = gelu_(linear(w, p + ".fc1", y, c.kernels));
  return linear(w, p + ".fc2", y, c.kernels);
}

// Block.forward, with attend's window partition (_window_partition /
// _window_unpartition): bottom and right zero padding before the
// attention's LayerNorm.
// models/tinyvit.py _window_partition / _window_unpartition (also the ViT's).
struct WindowMeta {
  int64_t B, pH, pW, nH, nW, pad_b, pad_r;
};

// (B, H, W, C) -> (B*nH*nW, ws*ws, C) with bottom and right zero padding.
Tensor window_partition(const Tensor& x, int64_t ws, WindowMeta* meta) {
  const int64_t B = x.size(0), H = x.size(1), Wd = x.size(2), C = x.size(3);
  const int64_t pad_b = (ws - H % ws) % ws, pad_r = (ws - Wd % ws) % ws;
  Tensor xp = x;
  if (pad_b || pad_r) xp = at::pad(x, {0, 0, 0, pad_r, 0, pad_b});
  const int64_t pH = H + pad_b, pW = Wd + pad_r;
  const int64_t nH = pH / ws, nW = pW / ws;
  xp = xp.reshape({B, nH, ws, nW, ws, C}).permute({0, 1, 3, 2, 4, 5});
  *meta = {B, pH, pW, nH, nW, pad_b, pad_r};
  return xp.reshape({B * nH * nW, ws * ws, C});
}

Tensor window_unpartition(const Tensor& x, int64_t ws, const WindowMeta& m,
                          int64_t H, int64_t Wd, int64_t C) {
  Tensor y = x.reshape({m.B, m.nH, m.nW, ws, ws, C})
                 .permute({0, 1, 3, 2, 4, 5});
  y = y.reshape({m.B, m.pH, m.pW, C});
  if (m.pad_b || m.pad_r)
    y = y.index({Slice(), Slice(at::indexing::None, H),
                 Slice(at::indexing::None, Wd), Slice()});
  return y.contiguous();
}

Tensor tv_block(const Weights& w, const std::string& p, Tensor x,
                const ProgramConfig& c) {
  const int64_t B = x.size(0), H = x.size(1), Wd = x.size(2), C = x.size(3);
  const int64_t ws = int64_t(
      std::lround(std::sqrt(double(W(w, p + ".attn.bias_idxs").size(0)))));
  Tensor shortcut = x;
  Tensor att;
  if (H == ws && Wd == ws) {
    att = tv_attention(w, p + ".attn", x.reshape({B, H * Wd, C}), c)
              .reshape({B, H, Wd, C});
  } else {
    WindowMeta meta;
    Tensor wx = window_partition(x, ws, &meta);
    att = window_unpartition(tv_attention(w, p + ".attn", wx, c), ws, meta,
                             H, Wd, C);
  }
  x = shortcut + att;
  const int64_t ks = W(w, p + ".local_conv.w").size(2);
  x = conv_bn(w, p + ".local_conv", x, 1, ks / 2);
  return x + tv_mlp_ln(w, p + ".mlp", x, c);
}

// TinyViT.forward; the stage layout comes from the weights' names.
Tensor tinyvit(const Weights& w, Tensor x, const ProgramConfig& c) {
  x = gelu_(conv_bn(w, "encoder.patch_embed.conv1", x, 2, 1));
  x = conv_bn(w, "encoder.patch_embed.conv2", x, 2, 1);
  for (int i = 0;; ++i) {
    const std::string s = "encoder.stages." + std::to_string(i);
    if (i == 0 ? !has(w, s + ".blocks.0.conv1.w")
               : !has_linear(w, s + ".blocks.0.attn.qkv"))
      break;
    for (int j = 0;; ++j) {
      const std::string b = s + ".blocks." + std::to_string(j);
      if (i == 0) {
        if (!has(w, b + ".conv1.w")) break;
        x = tv_mbconv(w, b, x);
      } else {
        if (!has_linear(w, b + ".attn.qkv")) break;
        x = tv_block(w, b, x, c);
      }
    }
    if (has(w, s + ".downsample.conv1.w")) {
      // merge_stride: the merge into the last stage keeps 64 x 64.
      const int64_t out = W(w, s + ".downsample.conv1.w").size(0);
      const int64_t stride = (out == 320 || out == 448 || out == 576) ? 1 : 2;
      x = tv_patch_merging(w, s + ".downsample", x, stride);
    }
  }
  x = conv2d_(x, W(w, "encoder.neck.conv1.w"));
  x = tv_ln(w, "encoder.neck.ln1", x, c, 1e-6);
  x = conv2d_(x, W(w, "encoder.neck.conv2.w"), 1, 1);
  return tv_ln(w, "encoder.neck.ln2", x, c, 1e-6);
}


// ---------------------------------------------------------------------------
// models/vit_sam.py (SAM ViT-B / L / H); on the kernel route
// (use_flash_attention) the attention takes K4 / K5 and the block
// LayerNorms K1 (block 0's norm1) and K3, else the dense path (JAX's CPU
// reference).
// ---------------------------------------------------------------------------

// gather_rel_pos with the block's rel_pos_idx buffer (made with the model,
// a weight of the bundle: no index is made in a program).
Tensor gather_rel_pos(const Tensor& table, int64_t size, const Tensor& idx) {
  if (idx.size(0) != size)
    fail("gather_rel_pos: the block's rel_pos_idx is for size " +
         std::to_string(idx.size(0)) + ", not " + std::to_string(size));
  return table.index({idx});
}

// _decomposed_rel_pos_bias: q (B*, nh, h*w, hd) -> float32 (B*, nh, hw, hw).
Tensor decomposed_rel_pos_bias(const Weights& w, const std::string& p,
                               const Tensor& q, int64_t h, int64_t wd) {
  const Tensor& idx = W(w, p + ".rel_pos_idx");
  Tensor rh = gather_rel_pos(W(w, p + ".rel_pos_h"), h, idx)
                  .to(q.scalar_type()).to(at::kFloat);
  Tensor rw = gather_rel_pos(W(w, p + ".rel_pos_w"), wd, idx)
                  .to(q.scalar_type()).to(at::kFloat);
  const int64_t Bn = q.size(0), nh = q.size(1), hd = q.size(3);
  Tensor qr = q.to(at::kFloat).reshape({Bn, nh, h, wd, hd});
  Tensor bias_h = at::einsum("bnhwc,hkc->bnhwk", {qr, rh});
  Tensor bias_w = at::einsum("bnhwc,wkc->bnhwk", {qr, rw});
  Tensor bias = bias_h.unsqueeze(-1) + bias_w.unsqueeze(-2);
  return bias.reshape({Bn, nh, h * wd, h * wd});
}

// _vit_attention: x (B*, h, w, C) -> (B*, h, w, C); apply_proj false
// returns the output before proj; n_w / valid_rows: the pad-query skip.
Tensor vit_attention(const Weights& w, const std::string& p, const Tensor& x,
                     const ProgramConfig& c, bool apply_proj, int64_t n_w,
                     int64_t valid_rows) {
  const int64_t Bn = x.size(0), h = x.size(1), wd = x.size(2), C = x.size(3);
  const int64_t nh = c.num_heads, hd = C / nh;
  const bool rel = has(w, p + ".rel_pos_h");
  Tensor qkv = linear(w, p + ".qkv", x.reshape({Bn, h * wd, C}), c.kernels);
  qkv = qkv.reshape({Bn, h * wd, 3, nh, hd}).permute({2, 0, 3, 1, 4});
  Tensor q = qkv.select(0, 0), k = qkv.select(0, 1), v = qkv.select(0, 2);
  Tensor out;
  if (c.kernel_route && rel) {
    const Tensor& idx = W(w, p + ".rel_pos_idx");
    Tensor rh = gather_rel_pos(W(w, p + ".rel_pos_h"), h, idx)
                    .to(q.scalar_type());
    Tensor rw = gather_rel_pos(W(w, p + ".rel_pos_w"), wd, idx)
                    .to(q.scalar_type());
    out = flash_attention_relpos(q.reshape({Bn * nh, h * wd, hd}),
                                 k.reshape({Bn * nh, h * wd, hd}),
                                 v.reshape({Bn * nh, h * wd, hd}), rh, rw, h,
                                 wd, nh, n_w, valid_rows, c.kernels);
    out = out.reshape({Bn, nh, h * wd, hd});
  } else {
    Tensor attn = at::matmul(q.to(at::kFloat),
                             k.to(at::kFloat).transpose(-1, -2)) *
                  std::pow(double(hd), -0.5);
    if (rel) attn = attn + decomposed_rel_pos_bias(w, p, q, h, wd);
    attn = at::softmax(attn, -1).to(v.scalar_type());
    out = at::matmul(attn.to(at::kFloat), v.to(at::kFloat))
              .to(v.scalar_type());
  }
  out = out.permute({0, 2, 1, 3}).reshape({Bn, h, wd, C});
  if (!apply_proj) return out;
  return linear(w, p + ".proj", out, c.kernels);
}

// _vit_attn_branch on the normed x: a global block whole, a windowed one
// partitioned after the LayerNorm (zero pad tokens take part as keys),
// the pad-query skip at batch 1 only, proj after the crop.
Tensor vit_attn_branch(const Weights& w, const std::string& p,
                       const Tensor& x, const ProgramConfig& c,
                       int64_t window) {
  const int64_t B = x.size(0), H = x.size(1), Wd = x.size(2), C = x.size(3);
  if (window == 0) return vit_attention(w, p, x, c, true, kNone, kNone);
  WindowMeta meta;
  Tensor wx = window_partition(x, window, &meta);
  const bool skip_ok = B == 1 && meta.pad_b > 0;
  wx = vit_attention(w, p, wx.reshape({-1, window, window, C}), c, false,
                     skip_ok ? meta.nW : kNone,
                     skip_ok ? window - meta.pad_b : kNone);
  Tensor y = window_unpartition(wx.reshape({-1, window * window, C}), window,
                                meta, H, Wd, C);
  return linear(w, p + ".proj", y, c.kernels);
}

// _layer_norm / _add_layer_norm: K1 / K3 on the kernel route.
Tensor vit_layer_norm(const Weights& w, const std::string& p, const Tensor& x,
                      const ProgramConfig& c) {
  if (c.kernel_route)
    return fused_layer_norm(x, W(w, p + ".scale"), W(w, p + ".bias"),
                            c.layer_norm_eps, c.kernels);
  return layer_norm_plain(x, W(w, p + ".scale"), W(w, p + ".bias"),
                          c.layer_norm_eps);
}

std::pair<Tensor, Tensor> vit_add_layer_norm(const Weights& w,
                                             const std::string& p,
                                             const Tensor& x,
                                             const Tensor& delta,
                                             const ProgramConfig& c) {
  if (c.kernel_route)
    return fused_add_layer_norm(x, delta, W(w, p + ".scale"),
                                W(w, p + ".bias"), c.layer_norm_eps,
                                c.kernels);
  Tensor s = x + delta;
  return {s, layer_norm_plain(s, W(w, p + ".scale"), W(w, p + ".bias"),
                              c.layer_norm_eps)};
}

// _vit_block_carry: the stream is base + delta (delta undefined for block
// 0); -> (h, mlp_out), the block output h + mlp_out.
std::pair<Tensor, Tensor> vit_block_carry(const Weights& w,
                                          const std::string& p,
                                          const Tensor& base,
                                          const Tensor& delta,
                                          const ProgramConfig& c,
                                          int64_t window) {
  Tensor x, y1;
  if (!delta.defined()) {
    x = base;
    y1 = vit_layer_norm(w, p + ".norm1", x, c);
  } else {
    std::tie(x, y1) = vit_add_layer_norm(w, p + ".norm1", base, delta, c);
  }
  Tensor a = vit_attn_branch(w, p, y1, c, window);
  auto [h, y2] = vit_add_layer_norm(w, p + ".norm2", x, a, c);
  Tensor m = linear(w, p + ".mlp.lin2",
                    gelu_(linear(w, p + ".mlp.lin1", y2, c.kernels)),
                    c.kernels);
  return {h, m};
}

// sam_vit_apply; the depth comes from the weights' names.
Tensor sam_vit(const Weights& w, Tensor x, const ProgramConfig& c) {
  if (c.num_heads <= 0) fail("sam_vit: the bundle names no num_heads");
  x = conv2d_(x, W(w, "encoder.patch_embed.w"), c.patch_size) +
      W(w, "encoder.patch_embed.b").to(x.scalar_type());
  if (has(w, "encoder.pos_embed"))
    x = x + W(w, "encoder.pos_embed").to(x.scalar_type());
  Tensor delta;
  for (int i = 0;; ++i) {
    const std::string b = "encoder.blocks." + std::to_string(i);
    if (!has_linear(w, b + ".qkv")) break;
    const bool global =
        std::find(c.global_attn_indexes.begin(), c.global_attn_indexes.end(),
                  i) != c.global_attn_indexes.end();
    std::tie(x, delta) =
        vit_block_carry(w, b, x, delta, c, global ? 0 : c.window_size);
  }
  if (delta.defined()) x = x + delta;
  x = conv2d_(x, W(w, "encoder.neck.conv1.w"));
  x = layer_norm(w, "encoder.neck.ln1", x, 1e-6);
  x = conv2d_(x, W(w, "encoder.neck.conv2.w"), 1, 1);
  return layer_norm(w, "encoder.neck.ln2", x, 1e-6);
}

// ---------------------------------------------------------------------------
// ops/resample.py, ops/preprocess.py sam_preprocess
// ---------------------------------------------------------------------------

// _scalar: a 0-d device tensor is cast; a number is filled on the device.
Tensor scalar_of(const Tensor& v, const Tensor& like) {
  return v.to(like.device(), at::kFloat);
}
Tensor scalar_of(double v, const Tensor& like) {
  return at::full(at::IntArrayRef{}, v, on(like, at::kFloat));
}

// resample_matrix: (out_bucket, in_bucket) bilinear weights.
Tensor resample_matrix(int64_t out_bucket, int64_t in_bucket,
                       const Tensor& out_size, const Tensor& in_size,
                       bool antialias) {
  const Tensor& dev = out_size;
  Tensor i = at::arange(out_bucket, on(dev, at::kFloat)).unsqueeze(1);
  Tensor j = at::arange(in_bucket, on(dev, at::kFloat)).unsqueeze(0);
  Tensor scale = in_size / out_size;
  Tensor src = clamp_min((i + 0.5) * scale - 0.5, 0.0);
  src = at::minimum(src, in_size - 1.0);
  Tensor kscale = antialias
                      ? clamp_max(out_size / in_size, 1.0)
                      : at::ones(at::IntArrayRef{}, on(dev, at::kFloat));
  Tensor wt = clamp_min(at::rsub(at::abs(src - j) * kscale, 1.0), 0.0);
  Tensor valid = at::bitwise_and(at::lt(i, out_size), at::lt(j, in_size));
  wt = at::where(valid, wt, zeros0(dev));
  Tensor denom = at::sum(wt, at::IntArrayRef{1}, true);
  return at::where(at::gt(denom, 0), wt / clamp_min(denom, 1e-20),
                   zeros0(dev));
}

Tensor sam_preprocess(const Tensor& canvas, const Tensor& in_h,
                      const Tensor& in_w, const Tensor& out_h,
                      const Tensor& out_w, const ProgramConfig& c) {
  const int64_t S = canvas.size(0);
  const int64_t n = c.image_size;
  Tensor img = canvas.to(at::kFloat);
  Tensor R = resample_matrix(n, S, scalar_of(out_h, canvas),
                             scalar_of(in_h, canvas), true);
  Tensor C = resample_matrix(n, S, scalar_of(out_w, canvas),
                             scalar_of(in_w, canvas), true);
  // apply_resample
  Tensor x = at::einsum("ih,hwc->iwc", {R, img});
  x = at::einsum("iwc,jw->ijc", {x, C});
  x = (x - c.pixel_mean) / c.pixel_std;
  Tensor i = at::arange(n, on(canvas, at::kLong)).view({n, 1, 1});
  Tensor j = at::arange(n, on(canvas, at::kLong)).view({1, n, 1});
  Tensor inside = at::bitwise_and(at::lt(i, out_h), at::lt(j, out_w));
  x = at::where(inside, x, zeros0(canvas));
  return x.unsqueeze(0).to(c.compute_dtype);
}

// ---------------------------------------------------------------------------
// models/prompt_encoder.py
// ---------------------------------------------------------------------------

Tensor pe_encoding(const Weights& w, const Tensor& coords01) {
  Tensor coords = coords01.to(at::kFloat) * 2.0 - 1.0;
  Tensor g = W(w, "prompt_encoder.pe_gaussian").to(at::kFloat);
  coords = coords.index({Ellipsis, Slice(0, 1)}) * g.select(0, 0) +
           coords.index({Ellipsis, Slice(1, 2)}) * g.select(0, 1);
  coords = coords * kTwoPi;
  return at::cat({at::sin(coords), at::cos(coords)}, -1);
}

Tensor dense_pe(const Weights& w, int64_t s) {
  const Tensor& g = W(w, "prompt_encoder.pe_gaussian");
  Tensor r = (at::arange(s, on(g, at::kFloat)) + 0.5) / s;
  Tensor y = r.unsqueeze(1).expand({s, s});
  Tensor x = r.unsqueeze(0).expand({s, s});
  return pe_encoding(w, at::stack({x, y}, -1));
}

Tensor embed_points(const Weights& w, const ProgramConfig& c,
                    const Tensor& point_coords, const Tensor& point_labels) {
  Tensor coords = (point_coords.to(at::kFloat) + 0.5) / double(c.image_size);
  Tensor emb = pe_encoding(w, coords);
  Tensor labels = point_labels.to(at::kFloat).unsqueeze(-1);
  emb = emb * at::ne(labels, -1);
  emb = emb + W(w, "prompt_encoder.not_a_point_embed").select(0, 0)
                      .to(at::kFloat) * at::eq(labels, -1);
  const Tensor& pts = W(w, "prompt_encoder.point_embeddings");
  for (int64_t i = 0; i < 4; ++i)
    emb = emb + pts.select(0, i).to(at::kFloat) * at::eq(labels, i);
  return emb;
}

Tensor embed_masks(const Weights& w, const Tensor& mask_input,
                   const Tensor& has_mask) {
  const std::string md = "prompt_encoder.mask_downscaling";
  Tensor x = mask_input;
  x = conv2d_(x, W(w, md + ".conv1.w"), 2) +
      W(w, md + ".conv1.b").to(x.scalar_type());
  x = gelu_(layer_norm(w, md + ".ln1", x, 1e-6));
  x = conv2d_(x, W(w, md + ".conv2.w"), 2) +
      W(w, md + ".conv2.b").to(x.scalar_type());
  x = gelu_(layer_norm(w, md + ".ln2", x, 1e-6));
  x = conv2d_(x, W(w, md + ".conv3.w")) +
      W(w, md + ".conv3.b").to(x.scalar_type());
  Tensor no_mask = W(w, "prompt_encoder.no_mask_embed").select(0, 0)
                       .to(x.scalar_type());
  Tensor hm = has_mask.to(x.scalar_type()).reshape({-1, 1, 1, 1});
  return hm * x + at::rsub(hm, 1.0) * no_mask;
}

// ---------------------------------------------------------------------------
// models/mask_decoder.py
// ---------------------------------------------------------------------------

struct DecoderContext {
  Tensor keys, key_pe, t2i_k, t2i_v, i2t_q;
  int64_t H = 0, Wd = 0;
  at::ScalarType dtype = at::kFloat;
};

// _attn; a projection given stands for its input's.
Tensor attn(const Weights& w, const std::string& p, const Tensor& q_in,
            const Tensor& k_in, const Tensor& v_in, int64_t nh,
            const Tensor* q_proj = nullptr, const Tensor* k_proj = nullptr,
            const Tensor* v_proj = nullptr) {
  Tensor q = q_proj ? *q_proj : linear(w, p + ".q", q_in);
  Tensor k = k_proj ? *k_proj : linear(w, p + ".k", k_in);
  Tensor v = v_proj ? *v_proj : linear(w, p + ".v", v_in);
  const int64_t B = q.size(0), Nq = q.size(1), C = q.size(2);
  const int64_t Nk = k.size(1);
  const int64_t hd = C / nh;
  q = q.reshape({B, Nq, nh, hd});
  k = k.reshape({B, Nk, nh, hd});
  v = v.reshape({B, Nk, nh, hd});
  Tensor a = at::einsum("bnhd,bmhd->bhnm",
                        {q.to(at::kFloat), k.to(at::kFloat)}) /
             std::sqrt(double(hd));
  a = at::softmax(a, -1).to(v.scalar_type());
  Tensor out = at::einsum("bhnm,bmhd->bnhd", {a, v}).to(v.scalar_type());
  return linear(w, p + ".out", out.reshape({B, Nq, C}));
}

Tensor mlp_block(const Weights& w, const std::string& p, const Tensor& x) {
  return linear(w, p + ".lin2", at::relu(linear(w, p + ".lin1", x)));
}

Tensor mlp_chain(const Weights& w, const std::string& p, Tensor x) {
  int n = 0;
  while (has(w, p + ".layers." + std::to_string(n) + ".w")) ++n;
  for (int i = 0; i < n; ++i) {
    x = linear(w, p + ".layers." + std::to_string(i), x);
    if (i < n - 1) x = at::relu(x);
  }
  return x;
}

DecoderContext decoder_context(const Weights& w, const Tensor& emb,
                               const Tensor& image_pe, const Tensor& dense) {
  const int64_t B = emb.size(0), H = emb.size(1), Wd = emb.size(2),
                C = emb.size(3);
  DecoderContext ctx;
  Tensor src = emb + dense;
  ctx.keys = src.reshape({B, H * Wd, C});
  ctx.key_pe = image_pe.unsqueeze(0).expand({B, H, Wd, C})
                   .to(src.scalar_type()).reshape({B, H * Wd, C});
  Tensor k = ctx.keys + ctx.key_pe;
  const std::string b0 = "decoder.transformer.blocks.0";
  ctx.t2i_k = linear(w, b0 + ".cross_attn_t2i.k", k);
  ctx.t2i_v = linear(w, b0 + ".cross_attn_t2i.v", ctx.keys);
  ctx.i2t_q = linear(w, b0 + ".cross_attn_i2t.q", k);
  ctx.H = H;
  ctx.Wd = Wd;
  ctx.dtype = emb.scalar_type();
  return ctx;
}

// _twoway_block; with ctx (block 0) its projections of the keys are used.
void twoway_block(const Weights& w, const std::string& p, Tensor& queries,
                  Tensor& keys, const Tensor& query_pe, const Tensor& key_pe,
                  int64_t nh, bool skip_first_layer_pe,
                  const DecoderContext* ctx) {
  if (skip_first_layer_pe) {
    queries = attn(w, p + ".self_attn", queries, queries, queries, nh);
  } else {
    Tensor q = queries + query_pe;
    queries = queries + attn(w, p + ".self_attn", q, q, queries, nh);
  }
  queries = layer_norm(w, p + ".norm1", queries);

  Tensor q = queries + query_pe;
  if (ctx == nullptr) {
    Tensor k = keys + key_pe;
    queries = queries + attn(w, p + ".cross_attn_t2i", q, k, keys, nh);
  } else {
    queries = queries + attn(w, p + ".cross_attn_t2i", q, Tensor(), Tensor(),
                             nh, nullptr, &ctx->t2i_k, &ctx->t2i_v);
  }
  queries = layer_norm(w, p + ".norm2", queries);

  queries = queries + mlp_block(w, p + ".mlp", queries);
  queries = layer_norm(w, p + ".norm3", queries);

  q = queries + query_pe;
  if (ctx == nullptr) {
    Tensor k = keys + key_pe;
    keys = keys + attn(w, p + ".cross_attn_i2t", k, q, queries, nh);
  } else {
    keys = keys + attn(w, p + ".cross_attn_i2t", Tensor(), q, queries, nh,
                       &ctx->i2t_q);
  }
  keys = layer_norm(w, p + ".norm4", keys);
}

// predict_masks_from -> (masks (B, nmt, 4H, 4W), iou_pred (B, nmt)).
std::pair<Tensor, Tensor> predict_masks_from(const Weights& w,
                                             const DecoderContext& ctx,
                                             const Tensor& sparse, int64_t nh) {
  const int64_t B = ctx.keys.size(0);
  const int64_t H = ctx.H, Wd = ctx.Wd, C = ctx.keys.size(2);
  const Tensor& mask_tokens = W(w, "decoder.mask_tokens");
  const int64_t nmt = mask_tokens.size(0);
  Tensor output_tokens = at::cat({W(w, "decoder.iou_token"), mask_tokens}, 0)
                             .to(sparse.scalar_type());
  Tensor tokens = at::cat(
      {output_tokens.unsqueeze(0).expand({B, 1 + nmt, C}), sparse}, 1);

  // _twoway_transformer
  Tensor keys = ctx.keys;
  const Tensor& key_pe = ctx.key_pe;
  Tensor queries = tokens;
  for (int i = 0;; ++i) {
    const std::string b = "decoder.transformer.blocks." + std::to_string(i);
    if (!has(w, b + ".norm1.scale")) break;
    twoway_block(w, b, queries, keys, tokens, key_pe, nh, i == 0,
                 i == 0 ? &ctx : nullptr);
  }
  {
    Tensor q = queries + tokens;
    Tensor k = keys + key_pe;
    queries = queries +
              attn(w, "decoder.transformer.final_attn", q, k, keys, nh);
    queries = layer_norm(w, "decoder.transformer.norm_final", queries);
  }
  Tensor hs = queries, src = keys;
  Tensor iou_token_out = hs.select(1, 0);
  Tensor mask_tokens_out = hs.index({Slice(), Slice(1, 1 + nmt)});

  src = src.reshape({B, H, Wd, C});
  Tensor x = conv_transpose2d_(src, W(w, "decoder.upscale.conv1.w")) +
             W(w, "decoder.upscale.conv1.b").to(src.scalar_type());
  x = gelu_(layer_norm(w, "decoder.upscale.ln", x, 1e-6));
  x = conv_transpose2d_(x, W(w, "decoder.upscale.conv2.w")) +
      W(w, "decoder.upscale.conv2.b").to(x.scalar_type());
  x = gelu_(x);

  std::vector<Tensor> hyper;
  for (int64_t i = 0; i < nmt; ++i)
    hyper.push_back(mlp_chain(w, "decoder.hypernet_mlps." + std::to_string(i),
                              mask_tokens_out.select(1, i)));
  Tensor hyper_in = at::stack(hyper, 1);
  Tensor masks = at::einsum("btc,bhwc->bthw",
                            {hyper_in.to(at::kFloat), x.to(at::kFloat)});
  Tensor iou_pred = mlp_chain(w, "decoder.iou_head",
                              iou_token_out.to(at::kFloat));
  return {masks, iou_pred};
}

// select_single_mask (ONNX select_masks) at num_points == 2.
std::pair<Tensor, Tensor> select_single_mask(const Tensor& masks,
                                             const Tensor& iou_pred,
                                             int64_t num_points) {
  Tensor token = at::arange(masks.size(1), on(masks, at::kLong));
  Tensor penalty = at::eq(token, 0).to(at::kFloat) * 1000.0;
  Tensor score = iou_pred + penalty * (double(num_points) - 2.5);
  Tensor best = at::argmax(score, 1);
  Tensor b = at::arange(masks.size(0), on(masks, at::kLong));
  return {masks.index({b, best}).unsqueeze(1),
          iou_pred.index({b, best}).unsqueeze(1)};
}

// ---------------------------------------------------------------------------
// ops/postprocess.py
// ---------------------------------------------------------------------------

Tensor composed_axis_matrix(int64_t bucket, int64_t low, int64_t model_size,
                            const Tensor& orig, const Tensor& crop) {
  Tensor up = resample_matrix(model_size, low, scalar_of(double(model_size),
                                                         orig),
                              scalar_of(double(low), orig), false);
  Tensor down = resample_matrix(bucket, model_size, scalar_of(orig, orig),
                                scalar_of(crop, orig), false);
  return at::matmul(down, up);
}

Tensor upsample_with(const Tensor& R, const Tensor& C,
                     const Tensor& low_res) {
  Tensor x = at::einsum("ih,bthw->btiw", {R, low_res.to(at::kFloat)});
  return at::einsum("btiw,jw->btij", {x, C});
}

Tensor pack_mask_bits(const Tensor& logits) {
  const int64_t w = logits.size(-1);
  if (w % 8) fail("pack_mask_bits: width not a multiple of 8");
  std::vector<int64_t> shape(logits.sizes().begin(), logits.sizes().end());
  shape.back() = w / 8;
  shape.push_back(8);
  Tensor bits = at::gt(logits, 0).to(at::kByte).reshape(shape);
  Tensor weights = at::pow(2, at::arange(7, -1, -1, on(bits, at::kLong)));
  return at::sum(bits * weights.to(at::kByte), at::IntArrayRef{-1}, false,
                 at::kByte);
}

// runtime/segmentation.py _each_prompt: [fn(i) for i < n]; on the card
// each call on a fork stream of the calling thread (ProgramConfig::
// fork_streams), forked from the current stream and joined back to it
// through events recorded on it: parallel branches of the one graph.
template <class F>
auto each_prompt(int64_t n, const Tensor& like, const ProgramConfig& c, F fn)
    -> std::vector<decltype(fn(int64_t(0)))> {
  std::vector<decltype(fn(int64_t(0)))> out;
  if (!like.is_cuda()) {
    for (int64_t i = 0; i < n; ++i) out.push_back(fn(i));
    return out;
  }
#ifdef DLIMG_SERVING_CUDA
  if (!c.fork_streams) fail("decode_batch: no fork streams on the card");
  const std::vector<void*> raw = c.fork_streams(n);
  if (int64_t(raw.size()) < n) fail("decode_batch: too few fork streams");
  at::cuda::CUDAStream main = at::cuda::getCurrentCUDAStream();
  std::vector<at::cuda::CUDAStream> streams;
  for (int64_t i = 0; i < n; ++i)
    streams.push_back(at::cuda::getStreamFromExternal(
        static_cast<cudaStream_t>(raw[i]), like.device().index()));
  for (int64_t i = 0; i < n; ++i) {
    at::cuda::CUDAEvent fork;
    fork.record(main);
    fork.block(streams[i]);
    c10::cuda::CUDAStreamGuard guard(streams[i]);
    out.push_back(fn(i));
  }
  for (int64_t i = 0; i < n; ++i) {
    at::cuda::CUDAEvent join;
    join.record(streams[i]);
    join.block(main);
  }
  return out;
#else
  fail("this serving library was built without CUDA");
#endif
}

// sam.decode_context with no mask prompt, at the embedding's batch.
DecoderContext no_mask_context(const Weights& w, const ProgramConfig& c,
                               const Tensor& emb) {
  const int64_t B = emb.size(0);
  const int64_t s = 4 * (c.image_size / 16);  // SamConfig.mask_input_size
  Tensor has_mask = at::zeros({B}, on(emb, emb.scalar_type()));
  Tensor mask_input = at::zeros({B, s, s, 1}, on(emb, emb.scalar_type()));
  Tensor dense = embed_masks(w, mask_input, has_mask);
  return decoder_context(w, emb, dense_pe(w, c.image_size / 16), dense);
}


// ---------------------------------------------------------------------------
// ops/amg.py and runtime/amg.py: automatic mask generation's selection
// ---------------------------------------------------------------------------

// point_grid: (n*n, 2) float32 (x, y) at the cell centres of the crop
// (crop_w / crop_h: 0-d int32 device tensors).
Tensor point_grid(int64_t n, const Tensor& crop_w, const Tensor& crop_h) {
  Tensor f = (at::arange(n, on(crop_w, at::kFloat)) + 0.5) / n;
  Tensor xs = f * crop_w;
  Tensor ys = f * crop_h;
  Tensor px = xs.unsqueeze(0).expand({n, n}).reshape({-1});
  Tensor py = ys.unsqueeze(1).expand({n, n}).reshape({-1});
  return at::stack({px, py}, -1);
}

// stability_scores: |m > +off| / |m > -off| over the valid pixels.
Tensor stability_scores(const Tensor& logits, const Tensor& valid,
                        double offset = 1.0) {
  Tensor hi = at::bitwise_and(at::gt(logits, offset), valid);
  Tensor lo = at::bitwise_and(at::gt(logits, -offset), valid);
  Tensor hi_a = at::sum(hi, at::IntArrayRef{-1, -2}).to(at::kFloat);
  Tensor lo_a = at::sum(lo, at::IntArrayRef{-1, -2}).to(at::kFloat);
  return hi_a / clamp_min(lo_a, 1.0);
}

// mask_boxes: (..., L, L) bool -> (..., 4) float32 [x0, y0, x1, y1].
Tensor mask_boxes(const Tensor& binary) {
  const int64_t L = binary.size(-1);
  Tensor idx = at::arange(L, on(binary, at::kLong));
  Tensor rows = at::any(binary, -1);
  Tensor cols = at::any(binary, -2);
  Tensor y0 = at::amin(at::where(rows, idx, L), -1);
  Tensor y1 = at::amax(at::where(rows, idx, -1), -1);
  Tensor x0 = at::amin(at::where(cols, idx, L), -1);
  Tensor x1 = at::amax(at::where(cols, idx, -1), -1);
  return at::stack({x0, y0, x1, y1}, -1).to(at::kFloat);
}

// box_iou_matrix: (M, 4) inclusive pixel boxes -> (M, M) IoU.
Tensor box_iou_matrix(const Tensor& boxes) {
  std::vector<Tensor> b = boxes.unbind(1);
  const Tensor &x0 = b[0], &y0 = b[1], &x1 = b[2], &y1 = b[3];
  Tensor area = clamp_min(x1 - x0 + 1, 0.0) * clamp_min(y1 - y0 + 1, 0.0);
  Tensor ix0 = at::maximum(x0.unsqueeze(1), x0.unsqueeze(0));
  Tensor iy0 = at::maximum(y0.unsqueeze(1), y0.unsqueeze(0));
  Tensor ix1 = at::minimum(x1.unsqueeze(1), x1.unsqueeze(0));
  Tensor iy1 = at::minimum(y1.unsqueeze(1), y1.unsqueeze(0));
  Tensor inter = clamp_min(ix1 - ix0 + 1, 0.0) * clamp_min(iy1 - iy0 + 1, 0.0);
  Tensor uni = area.unsqueeze(1) + area.unsqueeze(0) - inter;
  return inter / clamp_min(uni, 1.0);
}

// greedy_nms_plain: JAX's row loop over the IoU matrix.
Tensor greedy_nms_plain(const Tensor& boxes, const Tensor& scores,
                        const Tensor& thresh) {
  const int64_t M = boxes.size(0);
  Tensor over = at::gt(box_iou_matrix(boxes), thresh);
  Tensor later = at::arange(M, on(boxes, at::kLong));
  Tensor keep = at::gt(scores, 0.0);
  for (int64_t i = 0; i < M; ++i)
    keep = at::bitwise_and(
        keep, at::bitwise_not(at::bitwise_and(
                  at::bitwise_and(keep.select(0, i), over.select(0, i)),
                  at::gt(later, i))));
  return keep;
}

// nms_scratch_words: ceil(M / 64) words a row for 64 * ceil(M / 64) rows
// at an even stride, then the live flags.
int64_t nms_scratch_words(int64_t M) {
  const int64_t nw = (M + 63) / 64;
  return nw * 64 * (nw + nw % 2) + nw;
}

// ops/amg.py greedy_nms (P1): the kernels of csrc/greedy_nms.cu on a CUDA
// tensor (one call, counted once; the threshold read through its pointer,
// so a replay sees its current value), greedy_nms_plain on a CPU tensor.
Tensor greedy_nms(const Tensor& boxes, const Tensor& scores,
                  const Tensor& thresh, const ProgramConfig& c) {
  const int64_t M = boxes.size(0);
  if (boxes.dim() != 2 || boxes.size(1) != 4 || scores.dim() != 1 ||
      scores.size(0) != M)
    fail("greedy_nms: boxes must be (M, 4) and scores (M,)");
  if (boxes.is_cpu()) return greedy_nms_plain(boxes, scores, thresh);
  if (!boxes.is_cuda()) fail("greedy_nms: unsupported device");
  if (thresh.numel() != 1 || thresh.scalar_type() != at::kFloat ||
      thresh.device() != boxes.device())
    fail("greedy_nms: on CUDA the threshold must be a one-element float32 "
         "tensor on the boxes' device");
  if (boxes.scalar_type() != at::kFloat || scores.scalar_type() != at::kFloat ||
      !boxes.is_contiguous() || !scores.is_contiguous())
    fail("greedy_nms: boxes and scores must be contiguous float32");
  if (scores.device() != boxes.device())
    fail("greedy_nms: boxes and scores must share a device");
  if (reinterpret_cast<uintptr_t>(boxes.data_ptr()) % 16)
    fail("greedy_nms: boxes must be 16-byte aligned");
  if (c.kernels == nullptr || c.kernels->greedy_nms == nullptr)
    fail("greedy_nms: the kernel library is not loaded");
  Tensor keep = at::empty({M}, on(boxes, at::kBool));
  if (M == 0) return keep;
  const int64_t words = nms_scratch_words(M);
  Tensor& scratch = *c.nms_scratch;
  if (!scratch.defined() || scratch.numel() < words ||
      scratch.device() != boxes.device()) {
#ifdef DLIMG_SERVING_CUDA
    cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
    cudaStreamIsCapturing(at::cuda::getCurrentCUDAStream().stream(), &status);
    if (status != cudaStreamCaptureStatusNone)
      fail("greedy_nms: its scratch is made by the eager warm-up, not in a "
           "capture");
#endif
    scratch = at::empty({words}, on(boxes, at::kLong));
  }
  int rc = c.kernels->greedy_nms(boxes.data_ptr(), scores.data_ptr(),
                                 thresh.data_ptr(), keep.data_ptr(),
                                 scratch.data_ptr(), words, int(M),
                                 current_stream());
  if (rc != 0)
    fail("CUDA kernel greedy_nms failed to launch: cudaError " +
         std::to_string(rc));
  ++g_greedy_nms_launches;
  return keep;
}

// _chunk_size: the largest divisor of `total` that is <= cap.
int64_t chunk_size(int64_t total, int64_t cap = 64) {
  int64_t c = std::min(cap, total);
  while (total % c) --c;
  return c;
}

// _grid_and_valid: the (G, 2) prompt grid and the (L, L) low-res pixels
// whose centres fall inside the crop.
std::pair<Tensor, Tensor> grid_and_valid(const ProgramConfig& c,
                                         const Tensor& sizes, int64_t grid) {
  const int64_t L = 4 * (c.image_size / 16);  // SamConfig.mask_input_size
  Tensor crop_h = sizes.select(0, 2), crop_w = sizes.select(0, 3);
  Tensor pts = point_grid(grid, crop_w, crop_h);
  Tensor centre = (at::arange(L, on(sizes, at::kFloat)) + 0.5) *
                  (double(c.image_size) / double(L));
  Tensor valid = at::bitwise_and(at::lt(centre.unsqueeze(1), crop_h.to(at::kFloat)),
                                 at::lt(centre.unsqueeze(0), crop_w.to(at::kFloat)));
  return {pts, valid};
}

// _decode3: N positive points (each with the (0, 0) pad point, label -1)
// through decode_prompt_batch (the embedding expanded to N, multimask) ->
// tokens 1..3: (N, 3, L, L) logits, (N, 3) predicted IoU.
std::pair<Tensor, Tensor> decode3(const Weights& w, const ProgramConfig& c,
                                  const Tensor& emb, const Tensor& pts) {
  const int64_t n = pts.size(0);
  Tensor coords = at::stack({pts, at::zeros_like(pts)}, 1);
  Tensor labels = at::ones({n, 2}, on(pts, at::kFloat));
  labels.select(1, 1).fill_(-1.0);
  Tensor e = emb.expand({n, emb.size(1), emb.size(2), emb.size(3)});
  DecoderContext ctx = no_mask_context(w, c, e);
  Tensor sparse = embed_points(w, c, coords, labels).to(ctx.dtype);
  auto [m, iou] = predict_masks_from(w, ctx, sparse, c.decoder_heads);
  return {m.index({Slice(), Slice(1, 4)}), iou.index({Slice(), Slice(1, 4)})};
}

// _top_k: the k largest, descending, the lower index first on ties.
std::pair<Tensor, Tensor> top_k(const Tensor& x, int64_t k) {
  auto [values, idx] = at::sort(x, /*stable=*/true, /*dim=*/-1,
                                /*descending=*/true);
  return {values.index({Slice(at::indexing::None, k)}),
          idx.index({Slice(at::indexing::None, k)})};
}

// ---------------------------------------------------------------------------
// models/swin.py (BiRefNet's backbone); the relative-position index and the
// shift masks are weights of the bundle ("tables.rel_pos_index",
// "tables.shift_mask.<pH>x<pW>")
// ---------------------------------------------------------------------------

const Tensor& table(const Weights& w, const std::string& name) {
  return W(w, "tables." + name);
}

std::string by(int64_t a, int64_t b) {
  return std::to_string(a) + "x" + std::to_string(b);
}

// _window_attention: x (B, nW, w^2, C); mask (nW, w^2, w^2) or null.
Tensor swin_window_attention(const Weights& w, const std::string& p,
                             const Tensor& x, int64_t nh, const Tensor* mask) {
  const int64_t B = x.size(0), nW = x.size(1), N = x.size(2), C = x.size(3);
  const int64_t hd = C / nh;
  Tensor qkv = linear(w, p + ".qkv", x).reshape({B, nW, N, 3, nh, hd});
  Tensor q = qkv.select(3, 0), k = qkv.select(3, 1), v = qkv.select(3, 2);
  Tensor attn = at::einsum("bwnhd,bwmhd->bwhnm",
                           {q.to(at::kFloat), k.to(at::kFloat)}) *
                std::pow(double(hd), -0.5);
  Tensor bias = W(w, p + ".rel_bias")
                    .index({table(w, "rel_pos_index").reshape({-1})})
                    .reshape({N, N, nh})
                    .permute({2, 0, 1});
  attn = attn + bias.to(at::kFloat).unsqueeze(0).unsqueeze(0);
  if (mask) attn = attn + mask->unsqueeze(0).unsqueeze(2);
  attn = at::softmax(attn, -1).to(v.scalar_type());
  Tensor out = at::einsum("bwhnm,bwmhd->bwnhd",
                          {attn.to(at::kFloat), v.to(at::kFloat)})
                   .to(v.scalar_type());
  return linear(w, p + ".proj", out.reshape({B, nW, N, C}));
}

int64_t padded(int64_t n, int64_t window) {
  return n + (window - n % window) % window;
}

// _attend_rows: window attention over whole rows of windows (rows already
// padded and rolled by `shift`; the columns are padded and rolled here).
Tensor swin_attend_rows(const Weights& w, const std::string& p, Tensor x,
                        int64_t nh, int64_t window, int64_t shift,
                        const Tensor* mask) {
  const int64_t B = x.size(0), h = x.size(1), Wd = x.size(2), C = x.size(3);
  const int64_t pad_r = (window - Wd % window) % window;
  if (pad_r) x = at::pad(x, {0, 0, 0, pad_r});
  const int64_t pW = Wd + pad_r;
  if (shift > 0) x = at::roll(x, {-shift}, {2});
  const int64_t nH = h / window, nW = pW / window;
  x = x.reshape({B, nH, window, nW, window, C}).permute({0, 1, 3, 2, 4, 5});
  x = x.reshape({B, nH * nW, window * window, C});
  x = swin_window_attention(w, p, x, nh, mask);
  x = x.reshape({B, nH, nW, window, window, C}).permute({0, 1, 3, 2, 4, 5});
  x = x.reshape({B, h, pW, C});
  if (shift > 0) x = at::roll(x, {shift}, {2});
  return x.index({Slice(), Slice(), Slice(at::indexing::None, Wd)});
}

// _swin_tail: residual, norm2, MLP, residual.
Tensor swin_tail(const Weights& w, const std::string& p,
                 const Tensor& shortcut, const Tensor& attn, double eps) {
  Tensor x = shortcut + attn;
  Tensor y = layer_norm(w, p + ".norm2", x, eps);
  y = linear(w, p + ".mlp.lin2", gelu_(linear(w, p + ".mlp.lin1", y)));
  return x + y;
}

// _swin_block
Tensor swin_block(const Weights& w, const std::string& p, const Tensor& x,
                  int64_t nh, int64_t window, int64_t shift, double eps) {
  const int64_t H = x.size(1);
  Tensor y = layer_norm(w, p + ".norm1", x, eps);
  const int64_t pad_b = (window - H % window) % window;
  if (pad_b) y = at::pad(y, {0, 0, 0, 0, 0, pad_b});
  Tensor mask;
  if (shift > 0) {
    y = at::roll(y, {-shift}, {1});
    mask = table(w, "shift_mask." + by(H + pad_b, padded(y.size(2), window)));
  }
  y = swin_attend_rows(w, p, y, nh, window, shift,
                       shift > 0 ? &mask : nullptr);
  if (shift > 0) y = at::roll(y, {shift}, {1});
  return swin_tail(w, p, x, y.index({Slice(), Slice(at::indexing::None, H)}),
                   eps);
}

// _patch_merge: torch Swin-v1 PatchMerging's (h0w0, h1w0, h0w1, h1w1).
Tensor swin_patch_merge(const Weights& w, const std::string& p, Tensor x,
                        double eps) {
  int64_t B = x.size(0), H = x.size(1), Wd = x.size(2), C = x.size(3);
  const int64_t pad_b = H % 2, pad_r = Wd % 2;
  if (pad_b || pad_r) {
    x = at::pad(x, {0, 0, 0, pad_r, 0, pad_b});
    H += pad_b;
    Wd += pad_r;
  }
  x = x.reshape({B, H / 2, 2, Wd / 2, 2, C}).permute({0, 1, 3, 4, 2, 5});
  x = x.reshape({B, H / 2, Wd / 2, 4 * C});
  x = layer_norm(w, p + ".norm", x, eps);
  return linear(w, p + ".reduction", x);
}

// swin_apply: the 4-stage pyramid, each stage's output layer-normed.
std::vector<Tensor> swin_apply(const Weights& w, Tensor x,
                               const BirefConfig& b) {
  const std::string pe = "backbone.patch_embed";
  x = conv2d_(x, W(w, pe + ".w"), b.patch_size);
  x = x + W(w, pe + ".b").to(x.scalar_type());
  x = layer_norm(w, pe + ".norm", x, b.layer_norm_eps);
  std::vector<Tensor> feats;
  for (int i = 0; i < 4; ++i) {
    const std::string s = "backbone.stages." + std::to_string(i);
    for (int j = 0; j < b.depths.at(i); ++j) {
      const int64_t shift = j % 2 == 0 ? 0 : b.window / 2;
      x = swin_block(w, s + ".blocks." + std::to_string(j), x,
                     b.num_heads.at(i), b.window, shift, b.layer_norm_eps);
    }
    feats.push_back(layer_norm(w, s + ".out_norm", x, b.layer_norm_eps));
    if (has(w, s + ".downsample.reduction.w"))
      x = swin_patch_merge(w, s + ".downsample", x, b.layer_norm_eps);
  }
  return feats;
}

// ---------------------------------------------------------------------------
// ops/deform.py: modulated deformable conv v2, one gather a tap
// ---------------------------------------------------------------------------

struct CornerStack {
  Tensor stack;  // (B, (H+2) * (W+2), 4C)
  int64_t H, W, Ws;
  Tensor scale;  // an int8 stack's 0-d float32 scale, else undefined
};

// _corner_stack: x padded (1 top / left, 2 bottom / right) and its four
// 2x2-corner shifts concatenated on channels; int8 quantises the stack
// symmetrically, scale = max|x| / 127 on the device.
CornerStack corner_stack(const Tensor& x, bool int8) {
  const int64_t B = x.size(0), H = x.size(1), Wd = x.size(2), C = x.size(3);
  using at::indexing::None;
  Tensor xp = at::pad(x, {0, 0, 1, 2, 1, 2});
  Tensor stack = at::cat({xp.index({Slice(), Slice(None, -1), Slice(None, -1)}),
                          xp.index({Slice(), Slice(None, -1), Slice(1)}),
                          xp.index({Slice(), Slice(1), Slice(None, -1)}),
                          xp.index({Slice(), Slice(1), Slice(1)})},
                         -1);
  stack = stack.reshape({B, (H + 2) * (Wd + 2), 4 * C});
  Tensor scale;
  if (int8) {
    Tensor absmax = at::amax(at::abs(x.to(at::kFloat)));
    scale = clamp_min(absmax, 1e-12) / 127.0;
    stack = at::clamp(at::round(stack.to(at::kFloat) / scale),
                      std::optional<at::Scalar>(int64_t(-127)),
                      std::optional<at::Scalar>(int64_t(127)))
                .to(at::kChar);
  }
  return {stack, H, Wd, Wd + 2, scale};
}

// _bilinear_sample_stacked: an int8 stack is dequantised after the gather.
Tensor bilinear_sample_stacked(const CornerStack& cs, const Tensor& py,
                               const Tensor& px, int64_t C,
                               at::ScalarType dtype) {
  const int64_t B = cs.stack.size(0), oh = py.size(-2), ow = py.size(-1);
  Tensor y0 = at::floor(py), x0 = at::floor(px);
  Tensor wy = (py - y0).unsqueeze(-1), wx = (px - x0).unsqueeze(-1);
  Tensor box = at::bitwise_and(
      at::bitwise_and(at::bitwise_and(at::gt(py, -1.0), at::lt(py, cs.H)),
                      at::gt(px, -1.0)),
      at::lt(px, cs.W));
  Tensor yc = (at::clamp(y0, std::optional<at::Scalar>(int64_t(-1)),
                         std::optional<at::Scalar>(cs.H - 1)) + 1)
                  .to(at::kLong);
  Tensor xc = (at::clamp(x0, std::optional<at::Scalar>(int64_t(-1)),
                         std::optional<at::Scalar>(cs.W - 1)) + 1)
                  .to(at::kLong);
  const int64_t rows = cs.stack.size(1);
  Tensor idx = (yc * cs.Ws + xc).reshape({B, oh * ow});
  idx = idx + at::arange(B, on(idx, at::kLong)).unsqueeze(1) * rows;
  Tensor v4 = cs.stack.reshape({B * rows, 4 * C})
                  .index_select(0, idx.reshape({-1}))
                  .reshape({B, oh, ow, 4, C});
  if (cs.scale.defined()) v4 = v4.to(at::kFloat) * cs.scale;
  Tensor w00 = at::rsub(wy, 1) * at::rsub(wx, 1);
  Tensor w01 = at::rsub(wy, 1) * wx;
  Tensor w10 = wy * at::rsub(wx, 1);
  Tensor w11 = wy * wx;
  Tensor out = v4.select(3, 0) * w00 + v4.select(3, 1) * w01 +
               v4.select(3, 2) * w10 + v4.select(3, 3) * w11;
  return (out * box.unsqueeze(-1).to(out.scalar_type())).to(dtype);
}

// deform_conv2d: stride 1, dilation 1, one offset group, every row;
// int8_gather: from an int8 corner stack.
Tensor deform_conv2d(const Tensor& x, const Tensor& offset, const Tensor& mask,
                     const Tensor& wk, const Tensor* bias, int64_t padding,
                     bool int8_gather) {
  const int64_t B = x.size(0), H = x.size(1), Wd = x.size(2), C = x.size(3);
  const int64_t cout = wk.size(0), kh = wk.size(2), kw = wk.size(3);
  CornerStack cs = corner_stack(x, int8_gather);
  Tensor wmat = wk.to(at::kFloat).permute({2, 3, 1, 0});
  Tensor ys = at::arange(0, H, on(x, offset.scalar_type())).unsqueeze(1);
  Tensor xs = at::arange(Wd, on(x, offset.scalar_type())).unsqueeze(0);
  Tensor acc = at::zeros({B * H * Wd, cout}, on(x, at::kFloat));
  for (int64_t ky = 0; ky < kh; ++ky)
    for (int64_t kx = 0; kx < kw; ++kx) {
      const int64_t k = ky * kw + kx;
      Tensor py = ys + (ky - padding) + offset.select(-1, 2 * k);
      Tensor px = xs + (kx - padding) + offset.select(-1, 2 * k + 1);
      Tensor val = bilinear_sample_stacked(cs, py, px, C, at::kFloat) *
                   mask.index({Ellipsis, Slice(k, k + 1)});
      acc.addmm_(val.reshape({B * H * Wd, C}), wmat.select(0, ky).select(0, kx));
    }
  Tensor out = acc.reshape({B, H, Wd, cout});
  if (bias) out = out + bias->to(at::kFloat);
  return out.to(x.scalar_type());
}

// ---------------------------------------------------------------------------
// models/birefnet.py; the align-corners matrices are weights of the bundle
// ("tables.ac.<n_out>x<n_in>")
// ---------------------------------------------------------------------------

// _conv: conv2d (+ b where the tree holds it).
Tensor bconv(const Weights& w, const std::string& p, const Tensor& x,
             int64_t padding = 0) {
  Tensor y = conv2d_(x, W(w, p + ".w"), 1, padding);
  if (has(w, p + ".b")) y = y + W(w, p + ".b").to(y.scalar_type());
  return y;
}

// resize_align_corners: (B, H, W, C) -> (B, h, w, C) in float32, cast back.
Tensor resize_align_corners(const Weights& w, const Tensor& x, int64_t h,
                            int64_t wd) {
  const int64_t H = x.size(1), Wd = x.size(2);
  if (H == h && Wd == wd) return x;
  Tensor y = at::einsum("ih,bhwc->biwc", {table(w, "ac." + by(h, H)),
                                          x.to(at::kFloat)});
  y = at::einsum("biwc,jw->bijc", {y, table(w, "ac." + by(wd, Wd))});
  return y.to(x.scalar_type());
}

// _apply_deform: offsets and modulator in float32, the deform conv, ReLU.
Tensor apply_deform(const Weights& w, const std::string& p, const Tensor& x,
                    int64_t ks, bool int8_gather) {
  const int64_t pad = ks / 2;
  Tensor offset = bconv(w, p + ".offset", x, pad).to(at::kFloat);
  Tensor modulator =
      at::sigmoid(bconv(w, p + ".modulator", x, pad).to(at::kFloat)) * 2.0;
  const std::string b = p + ".conv.b";
  return at::relu(deform_conv2d(x, offset, modulator, W(w, p + ".conv.w"),
                                has(w, b) ? &W(w, b) : nullptr, pad,
                                int8_gather));
}

// _aspp_project: each branch's slice of the 1x1 projection summed in
// float32, the global average branch a 1x1-pixel product, bias, ReLU.
Tensor aspp_project(const Weights& w, const std::string& p,
                    const std::vector<Tensor>& branches, const Tensor& mean,
                    at::ScalarType dtype) {
  Tensor gap = at::relu(bconv(w, p + ".gap", mean.to(dtype)));
  const Tensor& pw = W(w, p + ".proj.w");
  const int64_t cs = gap.size(-1);
  Tensor y = conv2d_(branches[0], pw.index({Slice(), Slice(at::indexing::None,
                                                           cs)}))
                 .to(at::kFloat);
  for (size_t i = 1; i < branches.size(); ++i)
    y = y + conv2d_(branches[i],
                    pw.index({Slice(), Slice(int64_t(i) * cs,
                                             int64_t(i + 1) * cs)}))
                .to(at::kFloat);
  y = y + conv2d_(gap, pw.index({Slice(), Slice(int64_t(branches.size()) *
                                                cs)}))
              .to(at::kFloat);
  y = y + W(w, p + ".proj.b").to(at::kFloat);
  return at::relu(y).to(dtype);
}

// _apply_aspp: the 1x1 deform and the K deform branches, then the tail.
Tensor apply_aspp(const Weights& w, const std::string& p, const Tensor& x,
                  const BirefConfig& b) {
  std::vector<Tensor> branches{
      apply_deform(w, p + ".aspp1", x, 1, b.deform8)};
  for (size_t i = 0; i < b.aspp_kernel_sizes.size(); ++i)
    branches.push_back(apply_deform(w, p + ".deforms." + std::to_string(i), x,
                                    b.aspp_kernel_sizes[i], b.deform8));
  return aspp_project(w, p, branches,
                      at::mean(x.to(at::kFloat), at::IntArrayRef{1, 2}, true),
                      x.scalar_type());
}

// _apply_dec_blk: conv3x3 + ReLU, ASPPDeformable, conv3x3.
Tensor dec_blk(const Weights& w, const std::string& p, Tensor x,
               const BirefConfig& b) {
  x = at::relu(bconv(w, p + ".conv_in", x, 1));
  x = apply_aspp(w, p + ".aspp", x, b);
  return bconv(w, p + ".conv_out", x, 1);
}

Tensor simple_convs(const Weights& w, const std::string& p, const Tensor& x) {
  return bconv(w, p + ".conv_out", bconv(w, p + ".conv1", x, 1), 1);
}

// _gdt_gate: p * sigmoid(attn(relu(gdt conv(p)))).
Tensor gdt_gate(const Weights& w, int idx, const Tensor& p) {
  const std::string i = std::to_string(idx);
  Tensor g = at::relu(bconv(w, "decoder.gdt" + i, p, 1));
  Tensor attn = at::sigmoid(bconv(w, "decoder.gdt_attn" + i, g).to(at::kFloat));
  return p * attn.to(p.scalar_type());
}

// _head_fold with _head_weights and _head_sum: the level-1 tail, the 1x1
// head folded through the resize and the last SimpleConvs conv.
Tensor head_fold(const Weights& w, const Tensor& p, const Tensor& x,
                 int64_t S) {
  const int64_t cp = p.size(-1);
  const Tensor& head_w = W(w, "decoder.head.w");
  Tensor wb = head_w.index({0, Slice(cp), 0, 0}).to(at::kFloat);
  Tensor w_fold = at::einsum("cikl,c->ikl",
                             {W(w, "decoder.ipt_blk1.conv_out.w").to(at::kFloat),
                              wb})
                      .unsqueeze(0);
  Tensor bias;
  if (has(w, "decoder.ipt_blk1.conv_out.b"))
    bias = at::matmul(W(w, "decoder.ipt_blk1.conv_out.b").to(at::kFloat), wb);
  if (has(w, "decoder.head.b")) {
    Tensor hb = W(w, "decoder.head.b").to(at::kFloat);
    bias = bias.defined() ? bias + hb : hb;
  }
  Tensor wa = head_w.index({Slice(), Slice(at::indexing::None, cp)});
  Tensor a = resize_align_corners(w, conv2d_(p, wa), S, S);
  Tensor t = bconv(w, "decoder.ipt_blk1.conv1", x, 1);
  Tensor out = a + conv2d_(t, w_fold.to(t.scalar_type()), 1, 1)
                       .to(a.scalar_type());
  return bias.defined() ? out + bias.to(a.scalar_type()) : out;
}

// _get_patches: (tile x tile) patches stacked into channels, the W split
// outer.
Tensor get_patches(const Tensor& x, int64_t tile) {
  const int64_t B = x.size(0), H = x.size(1), Wd = x.size(2), C = x.size(3);
  const int64_t nh = H / tile, nw = Wd / tile;
  Tensor y = x.reshape({B, nh, tile, nw, tile, C})
                 .index({Slice(), Slice(), Slice(0, tile)});
  y = y.permute({0, 2, 4, 3, 1, 5});
  return y.reshape({B, tile, tile, nw * nh * C});
}

// birefnet_apply: (B, S, S, 3) normalised pixels -> (B, S, S, 1) float32
// logits.
Tensor birefnet_apply(const Weights& w, const Tensor& x,
                      const BirefConfig& b) {
  const int64_t S = x.size(1);
  std::vector<Tensor> feats = swin_apply(w, x, b);
  if (b.mul_scl_ipt) {
    Tensor x_half = resize_align_corners(w, x, S / 2, S / 2);
    std::vector<Tensor> half = swin_apply(w, x_half, b);
    for (size_t i = 0; i < feats.size(); ++i)
      feats[i] = at::cat({feats[i],
                          resize_align_corners(w, half[i], feats[i].size(1),
                                               feats[i].size(2))},
                         -1);
  }
  Tensor x1 = feats[0], x2 = feats[1], x3 = feats[2], x4 = feats[3];
  if (b.cxt_num) {
    std::vector<Tensor> ctx;
    for (const Tensor& f : {x1, x2, x3})
      ctx.push_back(resize_align_corners(w, f, x4.size(1), x4.size(2)));
    std::vector<Tensor> parts(ctx.end() - b.cxt_num, ctx.end());
    parts.push_back(x4);
    x4 = at::cat(parts, -1);
  }
  x4 = dec_blk(w, "squeeze", x4, b);
  // Level 4 (1/32)
  Tensor pat = get_patches(x, x4.size(1));
  x4 = at::cat({x4, simple_convs(w, "decoder.ipt_blk5", pat)}, -1);
  Tensor p4 = gdt_gate(w, 4, dec_blk(w, "decoder.dec4", x4, b));
  Tensor p3_in = resize_align_corners(w, p4, x3.size(1), x3.size(2));
  p3_in = p3_in + bconv(w, "decoder.lat4", x3);
  // Level 3 (1/16)
  pat = get_patches(x, x3.size(1));
  p3_in = at::cat({p3_in, simple_convs(w, "decoder.ipt_blk4", pat)}, -1);
  Tensor p3 = gdt_gate(w, 3, dec_blk(w, "decoder.dec3", p3_in, b));
  Tensor p2_in = resize_align_corners(w, p3, x2.size(1), x2.size(2));
  p2_in = p2_in + bconv(w, "decoder.lat3", x2);
  // Level 2 (1/8)
  pat = get_patches(x, x2.size(1));
  p2_in = at::cat({p2_in, simple_convs(w, "decoder.ipt_blk3", pat)}, -1);
  Tensor p2 = gdt_gate(w, 2, dec_blk(w, "decoder.dec2", p2_in, b));
  Tensor p1_in = resize_align_corners(w, p2, x1.size(1), x1.size(2));
  p1_in = p1_in + bconv(w, "decoder.lat2", x1);
  // Level 1 (1/4 -> 1/1): the head folded through the resize and concat.
  pat = get_patches(x, x1.size(1));
  p1_in = at::cat({p1_in, simple_convs(w, "decoder.ipt_blk2", pat)}, -1);
  p1_in = dec_blk(w, "decoder.dec1", p1_in, b);
  return head_fold(w, p1_in, x, S).to(at::kFloat);
}

}  // namespace

// _build_embed_fn's run on one device: preprocess, encoder, float32.
std::vector<Tensor> embed_program(const Weights& w, const ProgramConfig& c,
                                  const std::vector<Tensor>& in) {
  const Tensor& canvas = in.at(0);
  const Tensor& sizes = in.at(1);
  Tensor x = sam_preprocess(canvas, sizes.select(0, 0), sizes.select(0, 1),
                            sizes.select(0, 2), sizes.select(0, 3), c);
  return {(c.vit ? sam_vit(w, x, c) : tinyvit(w, x, c)).to(at::kFloat)};
}

// _build_decode_fn's run (largest_component off): decode_masks, then the
// upsample, threshold and bit pack.
std::vector<Tensor> decode_program(const Weights& w, const ProgramConfig& c,
                                   const std::vector<Tensor>& in) {
  const Tensor& emb = in.at(0);
  const Tensor& points = in.at(1);
  const Tensor& labels = in.at(2);
  const Tensor& sizes = in.at(3);
  DecoderContext ctx = no_mask_context(w, c, emb);
  // sam.decode_prompts
  Tensor sparse = embed_points(w, c, points, labels).to(ctx.dtype);
  auto [masks, iou] = predict_masks_from(w, ctx, sparse, c.decoder_heads);
  if (!c.multimask) {
    std::tie(masks, iou) = select_single_mask(masks, iou, points.size(1));
  } else {  // the reference consumes decoder tokens 1..3
    masks = masks.index({Slice(), Slice(1, 4)});
    iou = iou.index({Slice(), Slice(1, 4)});
  }
  // upsample_mask_logits
  Tensor R = composed_axis_matrix(c.bucket, masks.size(-1), c.image_size,
                                  sizes.select(0, 0), sizes.select(0, 2));
  Tensor C = composed_axis_matrix(c.bucket, masks.size(-1), c.image_size,
                                  sizes.select(0, 1), sizes.select(0, 3));
  Tensor logits = upsample_with(R, C, masks);
  return {pack_mask_bits(logits).select(0, 0).reshape({-1}), iou.select(0, 0)};
}

// _build_batch_decode_fn's run (largest_component off): the context once,
// then each prompt's decode_prompts, and then each prompt's upsample and
// pack, at batch 1 (_each_prompt), as compute_mask runs them.
std::vector<Tensor> decode_batch_program(const Weights& w,
                                         const ProgramConfig& c,
                                         const std::vector<Tensor>& in) {
  const Tensor& emb = in.at(0);
  const Tensor& points = in.at(1);
  const Tensor& labels = in.at(2);
  const Tensor& sizes = in.at(3);
  const int64_t n = points.size(0);
  DecoderContext ctx = no_mask_context(w, c, emb);
  auto one = each_prompt(n, emb, c, [&](int64_t i) {
    Tensor pts = points.index({Slice(i, i + 1)});
    Tensor lbl = labels.index({Slice(i, i + 1)});
    Tensor sparse = embed_points(w, c, pts, lbl).to(ctx.dtype);
    auto [m, q] = predict_masks_from(w, ctx, sparse, c.decoder_heads);
    return select_single_mask(m, q, pts.size(1));
  });
  std::vector<Tensor> ms, qs;
  for (const auto& [m, q] : one) {
    ms.push_back(m.select(1, 0));
    qs.push_back(q.select(1, 0));
  }
  Tensor masks = at::cat(ms);  // (N, L, L)
  Tensor iou = at::cat(qs);    // (N,)
  // upsample_matrices
  Tensor R = composed_axis_matrix(c.bucket, masks.size(-1), c.image_size,
                                  sizes.select(0, 0), sizes.select(0, 2));
  Tensor C = composed_axis_matrix(c.bucket, masks.size(-1), c.image_size,
                                  sizes.select(0, 1), sizes.select(0, 3));
  auto packed = each_prompt(n, masks, c, [&](int64_t i) {
    Tensor m = masks.index({Slice(i, i + 1)}).unsqueeze(0);
    return pack_mask_bits(upsample_with(R, C, m)).reshape({-1});
  });
  return {at::cat(packed), iou};
}

// _build_amg_fn's run (refine off): pass A chunk by chunk, the filter and
// the pre-NMS pool, P1, the top K, pass B on the winners, upsample, pack.
std::vector<Tensor> amg_program(const Weights& w, const ProgramConfig& c,
                                const std::vector<Tensor>& in) {
  const Tensor& emb = in.at(0);
  const Tensor& sizes = in.at(1);
  const Tensor& thr = in.at(2);
  if (c.amg_grid <= 0 || c.amg_masks <= 0 || c.amg_prenms <= 0)
    fail("amg: the bundle names no grid, max_masks or pool");
  auto [pts, valid] = grid_and_valid(c, sizes, c.amg_grid);
  // _pass_a: (iou, stability, area, box) of every grid point's three masks,
  // candidate index = point * 3 + token.
  const int64_t G = pts.size(0), chunk = chunk_size(G);
  std::vector<Tensor> ious, stabs, areas, boxes;
  for (int64_t k = 0; k < G / chunk; ++k) {
    auto [m, iou] = decode3(w, c, emb, pts.index({Slice(k * chunk,
                                                         (k + 1) * chunk)}));
    Tensor binary = at::bitwise_and(at::gt(m, 0), valid);
    ious.push_back(iou);
    stabs.push_back(stability_scores(m, valid));
    areas.push_back(at::sum(binary, at::IntArrayRef{-1, -2}).to(at::kFloat));
    boxes.push_back(mask_boxes(binary));
  }
  Tensor iou = at::cat(ious).reshape({-1});
  Tensor stab = at::cat(stabs).reshape({-1});
  Tensor area = at::cat(areas).reshape({-1});
  Tensor box = at::cat(boxes).reshape({-1, 4});
  // amg_pool: the filter, then the top-prenms candidates by score.
  Tensor valid_area = at::sum(valid).to(at::kFloat);
  Tensor ok = at::bitwise_and(
      at::bitwise_and(
          at::bitwise_and(at::ge(iou, thr.select(0, 0)),
                          at::ge(stab, thr.select(0, 1))),
          at::ge(area, clamp_min(thr.select(0, 3) * valid_area, 1.0))),
      at::le(area, thr.select(0, 4) * valid_area));
  auto [sc_p, idx_p] = top_k(at::where(ok, iou, -1.0), c.amg_prenms);
  Tensor boxes_p = box.index({idx_p});
  // _select: the NMS, then the top K winners.
  Tensor keep = greedy_nms(boxes_p, sc_p, thr.index({Slice(2, 3)}), c);
  auto [sc_f, j] = top_k(at::where(keep, sc_p, -1.0), c.amg_masks);
  Tensor win = idx_p.index({j});
  // Pass B: re-decode only the winners; select each one's token.
  Tensor m3 = decode3(w, c, emb, pts.index({at::floor_divide(win, 3)})).first;
  Tensor m = at::take_along_dim(m3, at::remainder(win, 3).view({-1, 1, 1, 1}),
                                1)
                 .select(1, 0);
  // tail: upsample_mask_logits of m[None], pack_mask_bits, flattened.
  Tensor R = composed_axis_matrix(c.bucket, m.size(-1), c.image_size,
                                  sizes.select(0, 0), sizes.select(0, 2));
  Tensor C = composed_axis_matrix(c.bucket, m.size(-1), c.image_size,
                                  sizes.select(0, 1), sizes.select(0, 3));
  Tensor logits = upsample_with(R, C, m.unsqueeze(0));
  return {pack_mask_bits(logits).select(0, 0).reshape({-1}), sc_f,
          stab.index({win}), area.index({win})};
}

// _build_birefnet_fn's run with no mesh: birefnet_input, birefnet_apply,
// sigmoid_to_u8 of logits[0, :, :, 0].
std::vector<Tensor> birefnet_program(const Weights& w, const ProgramConfig& c,
                                     const std::vector<Tensor>& in) {
  const Tensor& canvas = in.at(0);
  const Tensor& sizes = in.at(1);
  const BirefConfig& b = c.biref;
  const int64_t S = b.resolution, bucket = canvas.size(0);
  Tensor img = canvas.to(at::kFloat) / 255.0;
  Tensor R = resample_matrix(S, bucket, scalar_of(double(S), canvas),
                             scalar_of(sizes.select(0, 0), canvas), true);
  Tensor C = resample_matrix(S, bucket, scalar_of(double(S), canvas),
                             scalar_of(sizes.select(0, 1), canvas), true);
  // apply_resample
  Tensor x = at::einsum("ih,hwc->iwc", {R, img});
  x = at::einsum("iwc,jw->ijc", {x, C});
  x = ((x - c.imagenet_mean) / c.imagenet_std).unsqueeze(0)
          .to(c.compute_dtype);
  Tensor logits = birefnet_apply(w, x, b);
  Tensor v = at::sigmoid(logits.select(0, 0).select(-1, 0).to(at::kFloat)) *
             255.0;
  return {at::floor(v).to(at::kByte)};
}

}  // namespace dlimg_torch
