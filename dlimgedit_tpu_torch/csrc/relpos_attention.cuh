// Arguments shared by the tuned rel-pos attention kernels: K4, K5, K7
// (entry points in relpos_attention.cu) and K6 (entry point in
// window_strip_attention.cu). bf16 and float16 run on the tensor cores
// (relpos_attention_tc.cuh's bodies; relpos_attention_tc*.cu), float32 on
// the tensor cores in three TF32 passes in relpos_attention_f32tc.cu. Their
// tuned ranges: head widths that are multiples of 8 up to 128 (64 and 80
// instances of their own, the others padded ones: `padded_head_width`),
// 16-bit K5 / K7 windows with sides up to 16 and K6 windows of up to 208
// tokens; the entry points send every other geometry to the general body
// (attention_general.cuh).
#pragma once

#include "common.cuh"

namespace dlimg {

struct RelposArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* bhw;
  void* out;
  int n, gh, gw;
  int g_skip, n_valid;  // groups >= g_skip keep only n_valid query rows
  float scale;
  int folded;
  int qkv_heads;  // > 0: q, k, v are components of one (W, 3, qkv_heads, n, HD)
  int hd;         // the rows' head width (a padded instance computes at a wider HD)
};

// K6: windows read in place from padded NHWC tensors.
struct StripArgs {
  const void* q;   // (B, hp, wp, *) with token stride ts, head h at h * HD
  const void* k;
  const void* v;
  const void* rh;  // (ws, ws, HD) contiguous, activation dtype
  const void* rw;
  void* out;       // (B, hp, wp, c) contiguous
  int hp, wp, c, ts, ws, nh;  // head width c / nh
  float scale;
};

// The head widths the tuned instances take: hd 64 and 80 run instances of
// their own; every other multiple of 8 from 8 to 128 an instance at a
// padded width of 32, 96 or 128, which this returns (0 for a width they do
// not take: the general body's, attention_general.cuh).
inline int padded_head_width(int hd) {
  if (hd < 8 || hd > 128 || hd % 8 != 0) return 0;
  return hd <= 32 ? 32 : hd <= 96 ? 96 : 128;
}

// The head width a kernel body computes at (HD) and the one its rows hold:
// HD itself, or with PAD (a padded instance) the run-time hd < HD, whose
// columns past hd the body loads as zeros and does not store.
template <int HD, bool PAD>
struct HeadWidth {
  static constexpr bool kPad = PAD;
  int hd;
  __device__ __forceinline__ int width() const { return PAD ? hd : HD; }
};

// bf16 K4, K5 / K7 and K6 on the tensor cores (relpos_attention_tc.cu at
// hd 64 and 80, relpos_attention_tc_pad.cu, the `_pad` functions, at the
// other widths); g groups of a.n tokens (K6: `batch` images of windows),
// head width hd = a.hd. Each returns the launch's error.
cudaError_t relpos_global_tc(const RelposArgs& a, int g, int hd, cudaStream_t stream);
// K5, and K7 when a.qkv_heads > 0.
cudaError_t relpos_windowed_tc(const RelposArgs& a, int g, int hd, cudaStream_t stream);
cudaError_t window_strip_tc(const StripArgs& a, int batch, int hd, cudaStream_t stream);
cudaError_t relpos_global_tc_pad(const RelposArgs& a, int g, int hd, cudaStream_t stream);
cudaError_t relpos_windowed_tc_pad(const RelposArgs& a, int g, int hd, cudaStream_t stream);
cudaError_t window_strip_tc_pad(const StripArgs& a, int batch, int hd, cudaStream_t stream);

// float16 K4, K5 / K7 and K6: the same bodies with .f16 products
// (relpos_attention_tc_f16.cu at hd 64 and 80, relpos_attention_tc_f16_pad.cu
// at the other widths); the same arguments.
cudaError_t relpos_global_tc_f16(const RelposArgs& a, int g, int hd, cudaStream_t stream);
cudaError_t relpos_windowed_tc_f16(const RelposArgs& a, int g, int hd, cudaStream_t stream);
cudaError_t window_strip_tc_f16(const StripArgs& a, int batch, int hd, cudaStream_t stream);
cudaError_t relpos_global_tc_f16_pad(const RelposArgs& a, int g, int hd, cudaStream_t stream);
cudaError_t relpos_windowed_tc_f16_pad(const RelposArgs& a, int g, int hd, cudaStream_t stream);
cudaError_t window_strip_tc_f16_pad(const StripArgs& a, int batch, int hd, cudaStream_t stream);

// float32 K4, K5, K7 and K6 on the tensor cores in three TF32 passes
// (relpos_attention_f32tc.cu at hd 64 and 80, relpos_attention_f32tc_pad.cu
// at the other widths); the same arguments. q, k, v and out must start on
// 16 bytes (K7: the qkv tensor; K6: also rh and rw, and ts a multiple of 4
// floats).
cudaError_t relpos_global_f32tc(const RelposArgs& a, int g, int hd, cudaStream_t stream);
cudaError_t relpos_windowed_f32tc(const RelposArgs& a, int g, int hd, cudaStream_t stream);
// K7: a.q (= a.k = a.v) is the (W, 3, a.qkv_heads, n, HD) qkv, a.qkv_heads > 0.
cudaError_t relpos_qkv_f32tc(const RelposArgs& a, int g, int hd, cudaStream_t stream);
cudaError_t window_strip_f32tc(const StripArgs& a, int batch, int hd, cudaStream_t stream);
cudaError_t relpos_global_f32tc_pad(const RelposArgs& a, int g, int hd, cudaStream_t stream);
cudaError_t relpos_windowed_f32tc_pad(const RelposArgs& a, int g, int hd, cudaStream_t stream);
cudaError_t relpos_qkv_f32tc_pad(const RelposArgs& a, int g, int hd, cudaStream_t stream);
cudaError_t window_strip_f32tc_pad(const StripArgs& a, int batch, int hd, cudaStream_t stream);

}  // namespace dlimg
