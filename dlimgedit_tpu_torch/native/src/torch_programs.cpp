// The serving programs on ATen (see torch_programs.hpp). Each function
// names the Python function it mirrors; the operations, their order, their
// dtypes and their scalar arguments are the Python's, so that cuBLAS,
// cuDNN and the CPU kernels see the same calls. A Python float scalar is a
// double here too.
#include "torch_programs.hpp"

#include <ATen/TensorIndexing.h>

#include <cmath>
#include <stdexcept>

#ifdef DLIMG_SERVING_CUDA
#include <ATen/cuda/CUDAContext.h>
#endif

namespace dlimg_torch {

std::atomic<int64_t> g_layer_norm_launches{0};
std::atomic<int64_t> g_levit_attention_launches{0};

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

// linear: x @ w (+ b), the weight in x's dtype.
Tensor linear(const Weights& w, const std::string& p, const Tensor& x) {
  Tensor y = at::matmul(x, W(w, p + ".w").to(x.scalar_type()));
  if (has(w, p + ".b")) y = y + W(w, p + ".b").to(x.scalar_type());
  return y;
}

// ---------------------------------------------------------------------------
// ops/fused_norm.py fused_layer_norm (K1) and ops/flash_attention.py
// levit_window_attention (K2): the kernel on a CUDA tensor, the plain
// version on a CPU tensor.
// ---------------------------------------------------------------------------

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
  const int code = dtype_code(x.scalar_type());
  if (code < 0 || scale.scalar_type() != x.scalar_type() ||
      bias.scalar_type() != x.scalar_type())
    fail("fused_layer_norm: the CUDA kernel takes float32 or bfloat16 "
         "inputs of x's dtype");
  bool width_ok = false;
  for (int64_t c : kLayerNormWidths) width_ok |= c == C;
  if (!width_ok)
    fail("fused_layer_norm: no CUDA kernel for width " + std::to_string(C));
  if (!x.is_contiguous() || !scale.is_contiguous() || !bias.is_contiguous())
    fail("fused_layer_norm: inputs must be contiguous");
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
// models/tinyvit.py; the flags follow the device (the Environment turns
// K1 and K2 on for CUDA devices, and both wrappers take their plain
// versions on the CPU).
// ---------------------------------------------------------------------------

Tensor tv_ln(const Weights& w, const std::string& p, const Tensor& x,
             const ProgramConfig& c, double eps = 1e-5) {
  return fused_layer_norm(x, W(w, p + ".scale"), W(w, p + ".bias"), eps,
                          c.kernels);
}

Tensor tv_attention(const Weights& w, const std::string& p, Tensor x,
                    const ProgramConfig& c) {
  x = tv_ln(w, p + ".norm", x, c);
  Tensor qkv = linear(w, p + ".qkv", x);
  const Tensor& biases = W(w, p + ".attention_biases");
  Tensor bias = biases.index({Slice(), W(w, p + ".bias_idxs")});
  Tensor out = levit_window_attention(qkv, bias, biases.size(0), c.kernels);
  return linear(w, p + ".proj", out);
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
  y = gelu_(linear(w, p + ".fc1", y));
  return linear(w, p + ".fc2", y);
}

// Block.forward, with attend's window partition (_window_partition /
// _window_unpartition): bottom and right zero padding before the
// attention's LayerNorm.
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
    const int64_t pad_b = (ws - H % ws) % ws, pad_r = (ws - Wd % ws) % ws;
    Tensor xp = x;
    if (pad_b || pad_r) xp = at::pad(x, {0, 0, 0, pad_r, 0, pad_b});
    const int64_t pH = H + pad_b, pW = Wd + pad_r;
    const int64_t nH = pH / ws, nW = pW / ws;
    xp = xp.reshape({B, nH, ws, nW, ws, C}).permute({0, 1, 3, 2, 4, 5});
    Tensor wx = xp.reshape({B * nH * nW, ws * ws, C});
    Tensor y = tv_attention(w, p + ".attn", wx, c);
    y = y.reshape({B, nH, nW, ws, ws, C}).permute({0, 1, 3, 2, 4, 5});
    y = y.reshape({B, pH, pW, C});
    if (pad_b || pad_r)
      y = y.index({Slice(), Slice(at::indexing::None, H),
                   Slice(at::indexing::None, Wd), Slice()});
    att = y.contiguous();
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
    if (!has(w, s + ".blocks.0." + (i == 0 ? "conv1.w" : "attn.qkv.w")))
      break;
    for (int j = 0;; ++j) {
      const std::string b = s + ".blocks." + std::to_string(j);
      if (i == 0) {
        if (!has(w, b + ".conv1.w")) break;
        x = tv_mbconv(w, b, x);
      } else {
        if (!has(w, b + ".attn.qkv.w")) break;
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

}  // namespace

// _build_embed_fn's run on one device: preprocess, encoder, float32.
std::vector<Tensor> embed_program(const Weights& w, const ProgramConfig& c,
                                  const std::vector<Tensor>& in) {
  const Tensor& canvas = in.at(0);
  const Tensor& sizes = in.at(1);
  Tensor x = sam_preprocess(canvas, sizes.select(0, 0), sizes.select(0, 1),
                            sizes.select(0, 2), sizes.select(0, 3), c);
  return {tinyvit(w, x, c).to(at::kFloat)};
}

// _build_decode_fn's run (largest_component off): decode_masks, then the
// upsample, threshold and bit pack.
std::vector<Tensor> decode_program(const Weights& w, const ProgramConfig& c,
                                   const std::vector<Tensor>& in) {
  const Tensor& emb = in.at(0);
  const Tensor& points = in.at(1);
  const Tensor& labels = in.at(2);
  const Tensor& sizes = in.at(3);
  // sam.decode_context: no mask prompt.
  const int64_t B = emb.size(0);
  const int64_t s = 4 * (c.image_size / 16);  // SamConfig.mask_input_size
  Tensor has_mask = at::zeros({B}, on(emb, emb.scalar_type()));
  Tensor mask_input = at::zeros({B, s, s, 1}, on(emb, emb.scalar_type()));
  Tensor dense = embed_masks(w, mask_input, has_mask);
  DecoderContext ctx =
      decoder_context(w, emb, dense_pe(w, c.image_size / 16), dense);
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

}  // namespace dlimg_torch
