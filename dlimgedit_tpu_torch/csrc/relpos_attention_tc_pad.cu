// K4, K5, K7 and K6 in bfloat16 on Hopper's tensor cores at every head
// width other than 64 and 80 that is a multiple of 8 from 8 to 128: the
// bodies of relpos_attention_tc.cuh instantiated in bf16 at a padded width
// of 32, 96 or 128 (`padded_head_width`), the rows holding their own hd
// dims (the note there says how). Compiled apart from
// relpos_attention_tc.cu, whose hd 64 and 80 instances the ViTs' main paths
// run, so that the two build in parallel.
#include "relpos_attention_tc.cuh"

namespace dlimg {

cudaError_t relpos_global_tc_pad(const RelposArgs& a, int g, int hd, cudaStream_t stream) {
  return global_at_padded_width<bf16>(a, g, hd, stream);
}

cudaError_t relpos_windowed_tc_pad(const RelposArgs& a, int g, int hd, cudaStream_t stream) {
  return windowed_at_padded_width<bf16>(a, g, hd, stream);
}

cudaError_t window_strip_tc_pad(const StripArgs& a, int batch, int hd, cudaStream_t stream) {
  return strip_at_padded_width<bf16>(a, batch, hd, stream);
}

}  // namespace dlimg
