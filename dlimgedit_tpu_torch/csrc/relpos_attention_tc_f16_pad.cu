// K4, K5, K7 and K6 in float16 on Hopper's tensor cores at every head
// width other than 64 and 80 that is a multiple of 8 from 8 to 128: the
// float16 instances of relpos_attention_tc.cuh at the padded widths 32, 96
// and 128, as relpos_attention_tc_pad.cu has them in bf16.
#include "relpos_attention_tc.cuh"

namespace dlimg {

cudaError_t relpos_global_tc_f16_pad(const RelposArgs& a, int g, int hd, cudaStream_t stream) {
  return global_at_padded_width<__half>(a, g, hd, stream);
}

cudaError_t relpos_windowed_tc_f16_pad(const RelposArgs& a, int g, int hd,
                                       cudaStream_t stream) {
  return windowed_at_padded_width<__half>(a, g, hd, stream);
}

cudaError_t window_strip_tc_f16_pad(const StripArgs& a, int batch, int hd, cudaStream_t stream) {
  return strip_at_padded_width<__half>(a, batch, hd, stream);
}

}  // namespace dlimg
