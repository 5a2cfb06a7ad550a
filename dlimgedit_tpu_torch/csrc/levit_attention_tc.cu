// K2 in bfloat16 on Hopper's tensor cores: the bf16 instances of the body
// in levit_attention_tc.cuh, whose note gives the design. Float16 runs the
// same body from levit_attention_tc_f16.cu.
#include "levit_attention_tc.cuh"

namespace dlimg {

cudaError_t levit_attention_tc(const void* qkv, const void* bias, void* out, int g, int n,
                               int nh, float scale, cudaStream_t stream) {
  return levit_tc<bf16>(qkv, bias, out, g, n, nh, scale, stream);
}

}  // namespace dlimg
