// K4, K5, K7 and K6 in bfloat16 on Hopper's tensor cores at the ViTs' head
// widths, hd 64 (SAM ViT-B and ViT-L) and 80 (ViT-H): the bf16 instances
// of the bodies in relpos_attention_tc.cuh, whose note gives the design.
// Other head widths run the padded instances of relpos_attention_tc_pad.cu;
// float16 runs relpos_attention_tc_f16.cu and _f16_pad.cu.
#include "relpos_attention_tc.cuh"

namespace dlimg {

// hd 64 and 80 (the ViTs' widths) run instances of their own; every other
// head width of the range (relpos_attention.cuh `padded_head_width`) a
// padded instance, compiled apart in relpos_attention_tc_pad.cu.
cudaError_t relpos_global_tc(const RelposArgs& a, int g, int hd, cudaStream_t stream) {
  if (hd == 64 || hd == 80) return global_at_instance_width<bf16>(a, g, hd, stream);
  return relpos_global_tc_pad(a, g, hd, stream);
}

cudaError_t relpos_windowed_tc(const RelposArgs& a, int g, int hd, cudaStream_t stream) {
  if (hd == 64 || hd == 80) return windowed_at_instance_width<bf16>(a, g, hd, stream);
  return relpos_windowed_tc_pad(a, g, hd, stream);
}

cudaError_t window_strip_tc(const StripArgs& a, int batch, int hd, cudaStream_t stream) {
  if (hd == 64 || hd == 80) return strip_at_instance_width<bf16>(a, batch, hd, stream);
  return window_strip_tc_pad(a, batch, hd, stream);
}

}  // namespace dlimg
