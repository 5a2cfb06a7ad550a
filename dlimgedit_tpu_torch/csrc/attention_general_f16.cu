// The general attention body (attention_general.cuh, whose note gives the
// design) in float16, with bf16's rounding points: K2, K4, K5, K7 and K6 at
// the geometries their tuned instances do not take.
#include "attention_general.cuh"

namespace dlimg {

cudaError_t attention_general_f16(const GeneralArgs& a, int policy, cudaStream_t s) {
  return general_by_policy<__half>(a, policy, s);
}

}  // namespace dlimg
