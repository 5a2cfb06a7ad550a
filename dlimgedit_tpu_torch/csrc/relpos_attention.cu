// K4, K5 and K7: attention with the MViTv2 decomposed relative-position
// bias of the SAM ViT encoders, exact float32 softmax.
//
// This file holds the three C entry points, each of which picks its body by
// dtype: in bf16 (the ViT main paths' dtype) all three run on the tensor
// cores in relpos_attention_tc.cu, in float16 on the same bodies in
// relpos_attention_tc_f16.cu; in float32 all three run on the tensor cores
// in three TF32 passes (relpos_attention_f32tc.cu).
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
#include "relpos_attention.cuh"

namespace dlimg {

enum RelposKind { kRelposGlobal, kRelposWindowed, kRelposQkv };

template <int KIND>
int relpos_entry(const RelposArgs& a, int g, int hd, int dtype, void* stream) {
  if (g <= 0 || a.n <= 0) return 0;
  if (g > 65535 || a.gh <= 0 || a.gw <= 0 || a.gh * a.gw != a.n || a.n_valid < 0 ||
      hd != a.hd || padded_head_width(hd) == 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
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

}  // namespace dlimg

// q, k, v, out: (g, n, hd); bhw: (g, n, gh + gw); all contiguous and of one
// dtype; n == gh * gw; hd a multiple of 8 from 8 to 128 (64 and 80 run
// instances of their own, the others padded ones: relpos_attention.cuh
// `padded_head_width`; ops/flash_attention.py KERNEL_HEAD_DIMS).
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
  if (nh <= 0) return cudaErrorInvalidValue;
  const int g = w * nh;
  const dlimg::RelposArgs a{qkv, qkv, qkv, bhw, out, n, gh, gw, g, n, scale, 0, nh, hd};
  return dlimg::relpos_entry<dlimg::kRelposQkv>(a, g, hd, dtype, stream);
}
