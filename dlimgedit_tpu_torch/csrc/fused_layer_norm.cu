// K1: LayerNorm over the last axis, one-pass statistics.
//
// Replaces the TPU kernel dlimgedit_tpu/ops/fused_norm.py:64
// `fused_layer_norm` (Pallas body `_ln_kernel`, :20). Same function:
// mean and mean of squares in float32 in one pass over the row,
// var = max(E[x^2] - E[x]^2, 0), y = (x - mean) * rsqrt(var + eps), then
// the affine, written in the activation dtype.
//
// What bounds it on an H100: bytes. Each row is read once and written once
// (2 * C * sizeof(T) bytes) for about 8 C float operations, far below the
// ~295 operations per byte where the tensor cores would become the limit;
// the least time is rows * C * 2 * sizeof(T) / 3.35 TB/s.
//
// Design: one warp per row. A row of C = 32 * VPL values sits in registers,
// VPL values per lane (C in {128, 160, 256, 320} on TinyViT: 4, 5, 8, 10),
// so the row is read from device memory exactly once; both sums are
// reduced with warp shuffles and no shared memory or block barrier is
// needed. Lane l owns columns l, l + 32, ..., so every load and store of a
// warp touches one contiguous span of the row. The TPU kernel's
// power-of-two row blocking (`_row_blocking`, a Mosaic tiling constraint)
// does not carry over: a warp per row needs no padding, and the last block
// simply has idle warps.
#include "common.cuh"

namespace dlimg {

constexpr int kLnWarpsPerBlock = 8;

template <typename T, int VPL>
__global__ void __launch_bounds__(kLnWarpsPerBlock * 32)
layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                  const T* __restrict__ bias, T* __restrict__ out, int rows,
                  float eps) {
  constexpr int C = VPL * 32;
  const int row = blockIdx.x * kLnWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const T* xr = x + static_cast<size_t>(row) * C;
  float v[VPL];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    v[i] = to_float(xr[lane + 32 * i]);
    s += v[i];
    s2 += v[i] * v[i];
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = s / C;
  const float var = fmaxf(s2 / C - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
  T* orow = out + static_cast<size_t>(row) * C;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    const float y = (v[i] - mean) * inv;
    orow[c] = from_float<T>(y * to_float(scale[c]) + to_float(bias[c]));
  }
}

template <typename T, int VPL>
cudaError_t launch_layer_norm(const void* x, const void* scale, const void* bias,
                              void* out, int rows, float eps, cudaStream_t stream) {
  const int blocks = (rows + kLnWarpsPerBlock - 1) / kLnWarpsPerBlock;
  layer_norm_kernel<T, VPL><<<blocks, kLnWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<T*>(out), rows, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_layer_norm(const void* x, const void* scale, const void* bias,
                                void* out, int rows, int cols, float eps,
                                cudaStream_t stream) {
  switch (cols) {
#define DLIMG_LN_CASE(VPL) \
  case VPL * 32:           \
    return launch_layer_norm<T, VPL>(x, scale, bias, out, rows, eps, stream);
    DLIMG_LN_CASE(4)
    DLIMG_LN_CASE(5)
    DLIMG_LN_CASE(8)
    DLIMG_LN_CASE(10)
#undef DLIMG_LN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace dlimg

// Widths the kernel is instantiated for; the Python wrapper checks against
// the same list (ops/fused_norm.py KERNEL_WIDTHS).
extern "C" int dlimg_layer_norm(const void* x, const void* scale, const void* bias,
                                void* out, int rows, int cols, int dtype,
                                float eps, void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dlimg::kDtypeF32)
    return dlimg::dispatch_layer_norm<float>(x, scale, bias, out, rows, cols, eps, s);
  if (dtype == dlimg::kDtypeBF16)
    return dlimg::dispatch_layer_norm<__nv_bfloat16>(x, scale, bias, out, rows, cols,
                                                     eps, s);
  return cudaErrorInvalidValue;
}
