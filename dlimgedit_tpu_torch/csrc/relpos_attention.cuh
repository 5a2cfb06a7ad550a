// Arguments shared by the rel-pos attention kernels: K4, K5, K7 (entry
// points in relpos_attention.cu) and K6 (entry point in
// window_strip_attention.cu). bf16 runs on the tensor cores in
// relpos_attention_tc.cu, float32 on the tensor cores in three TF32 passes
// in relpos_attention_f32tc.cu.
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
};

// K6: windows read in place from padded NHWC tensors.
struct StripArgs {
  const void* q;   // (B, hp, wp, *) with token stride ts, head h at h * HD
  const void* k;
  const void* v;
  const void* rh;  // (ws, ws, HD) contiguous, activation dtype
  const void* rw;
  void* out;       // (B, hp, wp, c) contiguous
  int hp, wp, c, ts, ws, nh;
  float scale;
};

// bf16 K4, K5 / K7 and K6 on the tensor cores (relpos_attention_tc.cu); g
// groups of a.n tokens (K6: `batch` images of windows), head width hd in
// {64, 80}. Each returns the launch's error.
cudaError_t relpos_global_tc(const RelposArgs& a, int g, int hd, cudaStream_t stream);
// K5, and K7 when a.qkv_heads > 0.
cudaError_t relpos_windowed_tc(const RelposArgs& a, int g, int hd, cudaStream_t stream);
cudaError_t window_strip_tc(const StripArgs& a, int batch, int hd, cudaStream_t stream);

// float32 K4, K5, K7 and K6 on the tensor cores in three TF32 passes
// (relpos_attention_f32tc.cu); the same arguments, hd in {64, 80}. q, k, v
// and out must start on 16 bytes (K7: the qkv tensor; K6: also rh and rw,
// and ts a multiple of 4 floats).
cudaError_t relpos_global_f32tc(const RelposArgs& a, int g, int hd, cudaStream_t stream);
cudaError_t relpos_windowed_f32tc(const RelposArgs& a, int g, int hd, cudaStream_t stream);
// K7: a.q (= a.k = a.v) is the (W, 3, a.qkv_heads, n, HD) qkv, a.qkv_heads > 0.
cudaError_t relpos_qkv_f32tc(const RelposArgs& a, int g, int hd, cudaStream_t stream);
cudaError_t window_strip_f32tc(const StripArgs& a, int batch, int hd, cudaStream_t stream);

}  // namespace dlimg
