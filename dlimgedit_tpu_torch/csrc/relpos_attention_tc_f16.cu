// K4, K5, K7 and K6 in float16 on Hopper's tensor cores at hd 64 and 80:
// the float16 instances of the bodies in relpos_attention_tc.cuh (the bf16
// kernels with .f16 products and float16 roundings, as JAX rounds float16
// where it rounds bf16). Other head widths run the padded float16
// instances of relpos_attention_tc_f16_pad.cu. Compiled apart from the
// bf16 instances, so that they build in parallel.
#include "relpos_attention_tc.cuh"

namespace dlimg {

cudaError_t relpos_global_tc_f16(const RelposArgs& a, int g, int hd, cudaStream_t stream) {
  if (hd == 64 || hd == 80) return global_at_instance_width<__half>(a, g, hd, stream);
  return relpos_global_tc_f16_pad(a, g, hd, stream);
}

cudaError_t relpos_windowed_tc_f16(const RelposArgs& a, int g, int hd, cudaStream_t stream) {
  if (hd == 64 || hd == 80) return windowed_at_instance_width<__half>(a, g, hd, stream);
  return relpos_windowed_tc_f16_pad(a, g, hd, stream);
}

cudaError_t window_strip_tc_f16(const StripArgs& a, int batch, int hd, cudaStream_t stream) {
  if (hd == 64 || hd == 80) return strip_at_instance_width<__half>(a, batch, hd, stream);
  return window_strip_tc_f16_pad(a, batch, hd, stream);
}

}  // namespace dlimg
