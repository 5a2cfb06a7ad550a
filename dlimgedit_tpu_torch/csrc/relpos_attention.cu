// K4, K5 and K7: attention with the MViTv2 decomposed relative-position
// bias of the SAM ViT encoders, exact float32 softmax.
//
// This file holds the three C entry points, each of which picks its body by
// geometry and dtype. The tuned instances take head widths that are
// multiples of 8 up to 128 (and in bf16 / float16 K5 / K7 windows with
// sides up to 16): in bf16 (the ViT main paths' dtype) all three run on
// the tensor cores in relpos_attention_tc.cu, in float16 on the same bodies
// in relpos_attention_tc_f16.cu; in float32 all three run on the tensor
// cores in three TF32 passes (relpos_attention_f32tc.cu). Any other head
// width >= 1 and window runs the general body (attention_general.cuh,
// `attention_tuned`), in all three dtypes. Any group count: a tuned launch
// of more than 65535 groups (their grids put groups on gridDim.y) is split
// into launches of at most that many, K7's by whole windows, the operands
// offset; the general body puts groups on gridDim.x.
//
// K4 (`dlimg_relpos_attention_global`) replaces the TPU kernel
// dlimgedit_tpu/ops/flash_attention.py:139 `_attention_grouped` (Pallas
// body `_kernel`, :32): the global blocks, one group per head over the
// whole token grid (ViT-B at 1024: 12 groups of N = 4096, hd = 64).
// K5 (`dlimg_relpos_attention_windowed`) replaces :307
// `_attention_head_fused` (bodies `_head_loop_kernel` :264 and
// `_head_loop_kernel_folded` :248): the windowed blocks (25 windows x 12
// heads of N = 196), with the folded bias and the pad-query skip of the
// bottom window row in the same launch.
// K7 (`dlimg_relpos_attention_qkv`) replaces :382 `windowed_attention_qkv`
// (body `_head_loop_kernel_qkv`, :285): windows whose q, k and v are the
// three components of ONE (W, 3, nh, N, hd) tensor, addressed in place by
// per-group offsets; the bias halves are not folded and no query row is
// skipped.
//
// For group g (a head of an image or of a window) with token grid gh x gw,
// token i at (y_i, x_i) = divmod(i, gw), and bias halves
// bhw[g, i] = [q_i . rh[y_i, :] | q_i . rw[x_i, :]] (gh + gw values,
// computed and rounded to the activation dtype by the caller):
//   s[i, j] = (q_i . k_j) * scale + (bh[i, y_j] + bw[i, x_j])     plain
//   s[i, j] = (q_i . k_j + bh[i, y_j] + bw[i, x_j]) * scale       folded
//                       (the caller passed the halves divided by scale)
//   p = softmax_j(s) in float32, rounded to the activation dtype
//   out[g, i] = p . v in float32, rounded to the activation dtype
// and for groups g >= g_skip only the first n_valid query rows are
// computed; the others are written as zeros (K5's pad-query skip).
// The bias is added by index; the TPU kernel's one-hot selector matmul
// (`_selector_matrix`, :180) was a Mosaic workaround and is not ported.
//
// What bounds it on an H100: operations. K4 does 4 G N^2 hd = 51.5 GFLOP
// per launch at ViT-B 1024 (52 us at the bf16 tensor-core peak) against
// ~25 MB of q, k, v, bias halves and output (7.5 us at 3.35 TB/s). K5 is
// at N = 196 near the ridge: ~4 GFLOP against ~33 MB; K7 at ViT-B's
// windows: ~3.0 GFLOP against ~33 MB (qkv, bias halves, output).
#include "attention_general.cuh"
#include "relpos_attention.cuh"

namespace dlimg {

enum RelposKind { kRelposGlobal, kRelposWindowed, kRelposQkv };

template <int KIND>
int relpos_tuned(const RelposArgs& a, int g, int hd, int dtype, cudaStream_t s) {
  if (dtype == kDtypeF32) {
    // Three TF32 passes on the tensor cores (relpos_attention_f32tc.cu).
    if constexpr (KIND == kRelposGlobal) {
      return relpos_global_f32tc(a, g, hd, s);
    } else if constexpr (KIND == kRelposWindowed) {
      return relpos_windowed_f32tc(a, g, hd, s);
    } else {
      return relpos_qkv_f32tc(a, g, hd, s);
    }
  } else if (dtype == kDtypeBF16) {
    // bf16 runs on the tensor cores (relpos_attention_tc.cu); K7 is the
    // windowed body with a.qkv_heads set.
    if constexpr (KIND == kRelposGlobal) {
      return relpos_global_tc(a, g, hd, s);
    } else {
      return relpos_windowed_tc(a, g, hd, s);
    }
  } else if (dtype == kDtypeF16) {
    // float16 on the same bodies (relpos_attention_tc_f16.cu).
    if constexpr (KIND == kRelposGlobal) {
      return relpos_global_tc_f16(a, g, hd, s);
    } else {
      return relpos_windowed_tc_f16(a, g, hd, s);
    }
  }
  return cudaErrorInvalidValue;
}

template <int KIND>
int relpos_general(const RelposArgs& a, int g, int hd, int dtype, cudaStream_t s) {
  GeneralArgs b{};
  b.q = a.q;
  b.k = a.k;
  b.v = a.v;
  b.bias = a.bhw;
  b.out = a.out;
  b.groups = g;
  b.n = a.n;
  b.hd = hd;
  b.gh = a.gh;
  b.gw = a.gw;
  b.nh = a.qkv_heads;
  b.g_skip = a.g_skip;  // K4, K7: g (no skip)
  b.n_valid = a.n_valid;
  b.folded = a.folded;  // K4, K7: 0
  b.scale = a.scale;
  b.vec = general_vec(dtype == kDtypeF32 ? 4 : 2, hd, hd, a.q, a.k, a.v);
  return attention_general(b, kGenRelpos, dtype, s);
}

template <int KIND>
int relpos_entry(const RelposArgs& a, int g, int hd, int dtype, void* stream) {
  if (g <= 0 || a.n <= 0) return 0;
  if (a.gh <= 0 || a.gw <= 0 || static_cast<long long>(a.gh) * a.gw != a.n || a.n_valid < 0 ||
      hd != a.hd || hd <= 0 || (KIND == kRelposQkv && a.qkv_heads <= 0))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kernel = KIND == kRelposGlobal     ? kAttnGlobal
                     : KIND == kRelposWindowed ? kAttnWindowed
                                               : kAttnQkv;
  if (!attention_tuned(kernel, dtype, hd, a.n, a.gh, a.gw, a.qkv_heads))
    return relpos_general<KIND>(a, g, hd, dtype, s);
  // Launches of at most kMaxGridY groups (K7: whole windows), each on its
  // own groups' operands; K5's skip moves with them.
  const long long es = dtype == kDtypeF32 ? 4 : 2, n = a.n, ghw = a.gh + a.gw;
  const int step = KIND == kRelposQkv ? kMaxGridY / a.qkv_heads * a.qkv_heads : kMaxGridY;
  for (int g0 = 0; g0 < g; g0 += step) {
    RelposArgs b = a;
    const long long rows = static_cast<long long>(g0) * n;  // the chunk's first group's rows
    // K7: window g0 / nh starts 3 nh n rows into the qkv
    const long long in0 = (KIND == kRelposQkv ? 3 : 1) * rows * es * hd;
    b.q = static_cast<const char*>(a.q) + in0;
    b.k = static_cast<const char*>(a.k) + in0;
    b.v = static_cast<const char*>(a.v) + in0;
    b.out = static_cast<char*>(a.out) + rows * es * hd;
    b.bhw = static_cast<const char*>(a.bhw) + rows * es * ghw;
    b.g_skip = a.g_skip > g0 ? a.g_skip - g0 : 0;
    const int e = relpos_tuned<KIND>(b, g - g0 < step ? g - g0 : step, hd, dtype, s);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace dlimg

// q, k, v, out: (g, n, hd); bhw: (g, n, gh + gw); all contiguous and of one
// dtype; n == gh * gw; any hd >= 1 (tuned: multiples of 8 up to 128, 64 and
// 80 instances of their own, the others padded ones, relpos_attention.cuh
// `padded_head_width`; the general body the rest) and any g.
extern "C" int dlimg_relpos_attention_global(const void* q, const void* k,
                                             const void* v, const void* bhw,
                                             void* out, int g, int n, int hd, int gh,
                                             int gw, int dtype, float scale,
                                             void* stream) {
  const dlimg::RelposArgs a{q, k, v, bhw, out, n, gh, gw, g, n, scale, 0, 0, hd};
  return dlimg::relpos_entry<dlimg::kRelposGlobal>(a, g, hd, dtype, stream);
}

// The same with groups ordered (window, head); `folded` selects the folded
// bias, and groups >= g_skip compute only their first n_valid query rows.
extern "C" int dlimg_relpos_attention_windowed(const void* q, const void* k,
                                               const void* v, const void* bhw,
                                               void* out, int g, int n, int hd,
                                               int gh, int gw, int folded,
                                               int g_skip, int n_valid, int dtype,
                                               float scale, void* stream) {
  const dlimg::RelposArgs a{q, k, v, bhw, out, n, gh, gw, g_skip, n_valid, scale,
                            folded, 0, hd};
  return dlimg::relpos_entry<dlimg::kRelposWindowed>(a, g, hd, dtype, stream);
}

// qkv: (w, 3, nh, n, hd) contiguous; bhw: (w * nh, n, gh + gw), unfolded;
// out: (w, nh, n, hd); groups ordered (window, head) as for K5.
extern "C" int dlimg_relpos_attention_qkv(const void* qkv, const void* bhw, void* out,
                                          int w, int nh, int n, int hd, int gh, int gw,
                                          int dtype, float scale, void* stream) {
  if (nh <= 0 || static_cast<long long>(w) * nh > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int g = w * nh;
  const dlimg::RelposArgs a{qkv, qkv, qkv, bhw, out, n, gh, gw, g, n, scale, 0, nh, hd};
  return dlimg::relpos_entry<dlimg::kRelposQkv>(a, g, hd, dtype, stream);
}

// 0 where the tuned instances take a call of `kernel` (0 K2, 1 K4, 2 K5,
// 3 K7, 4 K6: ops/flash_attention.py ATTENTION_KERNELS) at this dtype and
// geometry, 1 where the general body runs it: the rule every entry point
// applies (`attention_tuned`), for the wrappers' counts to be checked
// against.
extern "C" int dlimg_attention_route(int kernel, int dtype, int hd, int n, int gh, int gw,
                                     int heads) {
  return dlimg::attention_tuned(kernel, dtype, hd, n, gh, gw, heads) ? 0 : 1;
}
