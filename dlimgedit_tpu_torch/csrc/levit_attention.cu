// K2: LeViT-bias window attention (TinyViT), exact softmax: the C entry
// point, which picks the body by geometry and dtype. The tuned instances
// take kd 32 and N <= 256 (every TinyViT window of the main paths): bf16 in
// levit_attention_tc.cu (mma.sync bf16), float16 on the same body in
// levit_attention_tc_f16.cu (mma.sync f16), float32 in
// levit_attention_f32tc.cu (mma.sync TF32 in three passes); all on one
// tiling, whose notes give the bound and the design. Any other kd >= 1 and
// N >= 1 (TinyViT's 384 and 512 variants' windows of 576 and 1024 tokens)
// runs the general body, attention_general.cuh (`attention_tuned`).
//
// Replaces the TPU kernel dlimgedit_tpu/ops/flash_attention.py:531
// `levit_window_attention` (Pallas body `_levit_kernel`, :500). For window
// g and head h:
//   q, k, v = qkv[g][:, h*3kd + [0, kd)], [+kd, +2kd), [+2kd, +3kd)
//   s = q k^T * kd^-1/2 + bias[h]            (float32)
//   p = softmax(s) (exact, float32), rounded to the activation dtype
//   out[g][:, h*kd + [0, kd)] = p v          (float32 accumulation)
// q, k and v are read in place from the qkv linear's output; no head
// transpose and no score tensor is ever written to device memory.
#include "attention_general.cuh"

namespace dlimg {

// bf16, float16 and float32 K2 on the tensor cores (levit_attention_tc.cu,
// levit_attention_tc_f16.cu, levit_attention_f32tc.cu); the launch's error.
cudaError_t levit_attention_tc(const void* qkv, const void* bias, void* out, int g, int n,
                               int nh, float scale, cudaStream_t stream);
cudaError_t levit_attention_tc_f16(const void* qkv, const void* bias, void* out, int g, int n,
                                   int nh, float scale, cudaStream_t stream);
cudaError_t levit_attention_f32tc(const void* qkv, const void* bias, void* out, int g, int n,
                                  int nh, float scale, cudaStream_t stream);

}  // namespace dlimg

// qkv: (g, n, nh * 3 * kd), bias: (nh, n, n), out: (g, n, nh * kd), all
// contiguous and of one dtype; the tuned instances want qkv and out on 16
// bytes (the wrapper's `kernel_operand`), the general body any element
// alignment.
extern "C" int dlimg_levit_attention(const void* qkv, const void* bias, void* out,
                                     int g, int n, int nh, int kd, int dtype,
                                     float scale, void* stream) {
  if (g <= 0) return 0;
  if (kd <= 0 || n <= 0 || nh <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dlimg::attention_tuned(dlimg::kAttnLevit, dtype, kd, n, 0, 0, nh)) {
    dlimg::GeneralArgs a{};
    a.q = a.k = a.v = qkv;
    a.bias = bias;
    a.out = out;
    a.groups = static_cast<long long>(g) * nh;
    a.n = n;
    a.hd = kd;
    a.nh = nh;
    a.scale = scale;
    a.vec = dlimg::general_vec(dtype == dlimg::kDtypeF32 ? 4 : 2, kd, 3LL * nh * kd, qkv, qkv,
                               qkv);
    return dlimg::attention_general(a, dlimg::kGenLevit, dtype, s);
  }
  if (dtype == dlimg::kDtypeF32)
    return dlimg::levit_attention_f32tc(qkv, bias, out, g, n, nh, scale, s);
  if (dtype == dlimg::kDtypeBF16)
    return dlimg::levit_attention_tc(qkv, bias, out, g, n, nh, scale, s);
  if (dtype == dlimg::kDtypeF16)
    return dlimg::levit_attention_tc_f16(qkv, bias, out, g, n, nh, scale, s);
  return cudaErrorInvalidValue;
}
