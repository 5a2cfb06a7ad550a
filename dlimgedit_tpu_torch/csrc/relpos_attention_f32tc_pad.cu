// K4, K5, K6 and K7 in float32 on Hopper's tensor cores (three TF32
// passes) at every head width other than 64 and 80 that is a multiple of 8
// from 8 to 128: the bodies of relpos_attention_f32tc.cuh instantiated at a
// padded width of 32, 96 or 128 (`padded_head_width`), the rows holding
// their own hd dims (the note there says how). Compiled apart from
// relpos_attention_f32tc.cu, whose hd 64 and 80 instances the ViTs' main
// paths run, so that the two build in parallel.
#include "relpos_attention_f32tc.cuh"

namespace dlimg {

cudaError_t relpos_global_f32tc_pad(const RelposArgs& a, int g, int hd, cudaStream_t stream) {
  switch (padded_head_width(hd)) {
    case 32: return launch_global_f32tc<32, true>(a, g, stream);
    case 96: return launch_global_f32tc<96, true>(a, g, stream);
    case 128: return launch_global_f32tc<128, true>(a, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t relpos_windowed_f32tc_pad(const RelposArgs& a, int g, int hd, cudaStream_t stream) {
  switch (padded_head_width(hd)) {
    case 32: return launch_window_f32tc<32, true>(a, g, stream);
    case 96: return launch_window_f32tc<96, true>(a, g, stream);
    case 128: return launch_window_f32tc<128, true>(a, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t relpos_qkv_f32tc_pad(const RelposArgs& a, int g, int hd, cudaStream_t stream) {
  switch (padded_head_width(hd)) {
    case 32: return launch_qkv_f32tc<32, true>(a, g, stream);
    case 96: return launch_qkv_f32tc<96, true>(a, g, stream);
    case 128: return launch_qkv_f32tc<128, true>(a, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t window_strip_f32tc_pad(const StripArgs& a, int batch, int hd, cudaStream_t stream) {
  switch (padded_head_width(hd)) {
    case 32: return launch_strip_f32tc<32, true>(a, batch, stream);
    case 96: return launch_strip_f32tc<96, true>(a, batch, stream);
    case 128: return launch_strip_f32tc<128, true>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dlimg
