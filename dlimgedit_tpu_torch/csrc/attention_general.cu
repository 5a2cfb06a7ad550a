// The general attention body (attention_general.cuh, whose note gives the
// design) in bfloat16: K2, K4, K5, K7 and K6 at the geometries their tuned
// instances do not take. float16 is attention_general_f16.cu (its own
// source, so that the two compile side by side).
#include "attention_general.cuh"

namespace dlimg {

cudaError_t attention_general_bf16(const GeneralArgs& a, int policy, cudaStream_t s) {
  return general_by_policy<bf16>(a, policy, s);
}

}  // namespace dlimg
