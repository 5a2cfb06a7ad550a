// The general attention body (attention_general.cuh, whose note gives the
// design) in bfloat16 and float16: K2, K4, K5, K7 and K6 at the geometries
// their tuned instances do not take.
#include "attention_general.cuh"

namespace dlimg {

cudaError_t attention_general_16(const GeneralArgs& a, int policy, int dtype, cudaStream_t s) {
  if (dtype == kDtypeBF16) return general_by_policy<bf16>(a, policy, s);
  if (dtype == kDtypeF16) return general_by_policy<__half>(a, policy, s);
  return cudaErrorInvalidValue;
}

}  // namespace dlimg
