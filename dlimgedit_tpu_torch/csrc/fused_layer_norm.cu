// K1: LayerNorm over the last axis, one-pass statistics, and
// K3: residual add + LayerNorm in one pass.
//
// K1 replaces the TPU kernel dlimgedit_tpu/ops/fused_norm.py:64
// `fused_layer_norm` (Pallas body `_ln_kernel`, :20). Same function:
// mean and mean of squares in float32 in one pass over the row,
// var = max(E[x^2] - E[x]^2, 0), y = (x - mean) * rsqrt(var + eps), then
// the affine, written in the activation dtype.
//
// K3 replaces dlimgedit_tpu/ops/fused_norm.py:98 `fused_add_layer_norm`
// (Pallas body `_add_ln_kernel`, :30): s = x + d is summed in float32,
// rounded to the activation dtype and written (it is the residual stream),
// and the statistics are taken on the ROUNDED s, so (s, LN(s)) bit-match
// the plain `x + d` followed by K1.
//
// What bounds both on an H100: bytes. K1 reads and writes each row once
// (2 * C * sizeof(T) bytes), K3 reads x and d and writes s and y
// (4 * C * sizeof(T)); either does about 8 C float operations per row,
// far below the ~295 operations per byte where the tensor cores would
// become the limit.
//
// Design: one warp per row. A row of C = 32 * VPL values sits in registers,
// VPL values per lane (TinyViT's C in {128, 160, 256, 320}: 4, 5, 8, 10;
// the SAM ViT's C in {768, 1024, 1280}: 24, 32, 40), so the row is read
// from device memory exactly once; both sums are reduced with warp
// shuffles and no shared memory or block barrier is needed. Lane l owns
// columns l, l + 32, ..., so every load and store of a warp touches one
// contiguous span of the row. The TPU kernel's power-of-two row blocking
// (`_row_blocking`, a Mosaic tiling constraint) does not carry over: a warp
// per row needs no padding, and the last block simply has idle warps.
#include "common.cuh"

namespace dlimg {

constexpr int kLnWarpsPerBlock = 8;

// Normalises one row held as v[i] = row[lane + 32 i] and writes the affine
// result to orow.
template <typename T, int VPL>
__device__ __forceinline__ void normalize_row(const float (&v)[VPL], int lane,
                                              const T* __restrict__ scale,
                                              const T* __restrict__ bias,
                                              T* __restrict__ orow, float eps) {
  constexpr int C = VPL * 32;
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    s += v[i];
    s2 += v[i] * v[i];
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = s / C;
  const float var = fmaxf(s2 / C - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    const float y = (v[i] - mean) * inv;
    orow[c] = from_float<T>(y * to_float(scale[c]) + to_float(bias[c]));
  }
}

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
#pragma unroll
  for (int i = 0; i < VPL; ++i) v[i] = to_float(xr[lane + 32 * i]);
  normalize_row<T, VPL>(v, lane, scale, bias, out + static_cast<size_t>(row) * C,
                        eps);
}

template <typename T, int VPL>
__global__ void __launch_bounds__(kLnWarpsPerBlock * 32)
add_layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ d,
                      const T* __restrict__ scale, const T* __restrict__ bias,
                      T* __restrict__ s_out, T* __restrict__ out, int rows,
                      float eps) {
  constexpr int C = VPL * 32;
  const int row = blockIdx.x * kLnWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * C;
  float v[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const size_t c = base + lane + 32 * i;
    const T s = from_float<T>(to_float(x[c]) + to_float(d[c]));
    s_out[c] = s;
    v[i] = to_float(s);  // statistics of the rounded sum
  }
  normalize_row<T, VPL>(v, lane, scale, bias, out + base, eps);
}

// One launch of K1 (d == nullptr) or K3 for rows of width VPL * 32.
template <typename T, int VPL>
cudaError_t launch_layer_norm(const void* x, const void* d, const void* scale,
                              const void* bias, void* s_out, void* out, int rows,
                              float eps, cudaStream_t stream) {
  const int blocks = (rows + kLnWarpsPerBlock - 1) / kLnWarpsPerBlock;
  if (d == nullptr) {
    layer_norm_kernel<T, VPL><<<blocks, kLnWarpsPerBlock * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale),
        static_cast<const T*>(bias), static_cast<T*>(out), rows, eps);
  } else {
    add_layer_norm_kernel<T, VPL><<<blocks, kLnWarpsPerBlock * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(d),
        static_cast<const T*>(scale), static_cast<const T*>(bias),
        static_cast<T*>(s_out), static_cast<T*>(out), rows, eps);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_layer_norm(const void* x, const void* d, const void* scale,
                                const void* bias, void* s_out, void* out, int rows,
                                int cols, float eps, cudaStream_t stream) {
  switch (cols) {
#define DLIMG_LN_CASE(VPL) \
  case VPL * 32:           \
    return launch_layer_norm<T, VPL>(x, d, scale, bias, s_out, out, rows, eps, stream);
    DLIMG_LN_CASE(4)
    DLIMG_LN_CASE(5)
    DLIMG_LN_CASE(8)
    DLIMG_LN_CASE(10)
    DLIMG_LN_CASE(24)
    DLIMG_LN_CASE(32)
    DLIMG_LN_CASE(40)
#undef DLIMG_LN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

int layer_norm_entry(const void* x, const void* d, const void* scale,
                     const void* bias, void* s_out, void* out, int rows, int cols,
                     int dtype, float eps, void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return dispatch_layer_norm<float>(x, d, scale, bias, s_out, out, rows, cols, eps, s);
  if (dtype == kDtypeBF16)
    return dispatch_layer_norm<__nv_bfloat16>(x, d, scale, bias, s_out, out, rows,
                                              cols, eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace dlimg

// Widths the kernels are instantiated for; the Python wrappers check
// against the same list (ops/fused_norm.py KERNEL_WIDTHS).
extern "C" int dlimg_layer_norm(const void* x, const void* scale, const void* bias,
                                void* out, int rows, int cols, int dtype,
                                float eps, void* stream) {
  return dlimg::layer_norm_entry(x, nullptr, scale, bias, nullptr, out, rows, cols,
                                 dtype, eps, stream);
}

// K3: s_out = x + d (rounded to the dtype), out = LN(s_out).
extern "C" int dlimg_add_layer_norm(const void* x, const void* d, const void* scale,
                                    const void* bias, void* s_out, void* out,
                                    int rows, int cols, int dtype, float eps,
                                    void* stream) {
  if (d == nullptr) return cudaErrorInvalidValue;
  return dlimg::layer_norm_entry(x, d, scale, bias, s_out, out, rows, cols, dtype,
                                 eps, stream);
}
