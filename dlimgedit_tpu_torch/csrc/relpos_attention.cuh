// Arguments shared by the rel-pos attention kernels: K4, K5, K7 of
// relpos_attention.cu (float32 CUDA-core body) and K6 of
// window_strip_attention.cu (float32 CUDA-core body), whose bf16 routes run
// on the tensor cores in relpos_attention_tc.cu.
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

}  // namespace dlimg
