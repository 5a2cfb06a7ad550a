// K2 in float16 on Hopper's tensor cores: the float16 instances of the body
// in levit_attention_tc.cuh (mma.sync m16n8k16 .f16, p rounded to float16),
// compiled apart from the bf16 ones so that the two build in parallel.
#include "levit_attention_tc.cuh"

namespace dlimg {

cudaError_t levit_attention_tc_f16(const void* qkv, const void* bias, void* out, int g, int n,
                                   int nh, float scale, cudaStream_t stream) {
  return levit_tc<__half>(qkv, bias, out, g, n, nh, scale, stream);
}

}  // namespace dlimg
