// Arguments shared by the rel-pos attention kernels (K4, K5, K7) of
// relpos_attention.cu (float32 CUDA-core body, and K7 in both dtypes) and
// relpos_attention_tc.cu (bf16 tensor-core bodies of K4 and K5).
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

// bf16 K4 and K5 on the tensor cores (relpos_attention_tc.cu); g groups of
// a.n tokens, head width hd in {64, 80}. Each returns the launch's error.
cudaError_t relpos_global_tc(const RelposArgs& a, int g, int hd, cudaStream_t stream);
cudaError_t relpos_windowed_tc(const RelposArgs& a, int g, int hd, cudaStream_t stream);

}  // namespace dlimg
