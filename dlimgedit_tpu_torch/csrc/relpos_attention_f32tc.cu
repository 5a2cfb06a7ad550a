// K4, K5, K6 and K7 in float32 on Hopper's tensor cores (three TF32
// passes) at the ViTs' head widths, hd 64 (SAM ViT-B and ViT-L) and 80
// (ViT-H): the instances of the bodies in relpos_attention_f32tc.cuh, whose
// note gives the design. Other head widths run the padded instances of
// relpos_attention_f32tc_pad.cu.
#include "relpos_attention_f32tc.cuh"

namespace dlimg {

// hd 64 and 80 (the ViTs' widths) run instances of their own; every other
// head width of the range (relpos_attention.cuh `padded_head_width`) a
// padded instance, compiled apart in relpos_attention_f32tc_pad.cu.
cudaError_t relpos_global_f32tc(const RelposArgs& a, int g, int hd, cudaStream_t stream) {
  if (hd == 64) return launch_global_f32tc<64, false>(a, g, stream);
  if (hd == 80) return launch_global_f32tc<80, false>(a, g, stream);
  return relpos_global_f32tc_pad(a, g, hd, stream);
}

cudaError_t relpos_windowed_f32tc(const RelposArgs& a, int g, int hd, cudaStream_t stream) {
  if (hd == 64) return launch_window_f32tc<64, false>(a, g, stream);
  if (hd == 80) return launch_window_f32tc<80, false>(a, g, stream);
  return relpos_windowed_f32tc_pad(a, g, hd, stream);
}

cudaError_t relpos_qkv_f32tc(const RelposArgs& a, int g, int hd, cudaStream_t stream) {
  if (hd == 64) return launch_qkv_f32tc<64, false>(a, g, stream);
  if (hd == 80) return launch_qkv_f32tc<80, false>(a, g, stream);
  return relpos_qkv_f32tc_pad(a, g, hd, stream);
}

cudaError_t window_strip_f32tc(const StripArgs& a, int batch, int hd, cudaStream_t stream) {
  if (hd == 64) return launch_strip_f32tc<64, false>(a, batch, stream);
  if (hd == 80) return launch_strip_f32tc<80, false>(a, batch, stream);
  return window_strip_f32tc_pad(a, batch, hd, stream);
}

}  // namespace dlimg
