// P2: dynamic per-token int8 quantisation of activation rows, and
// P3: the dequantising epilogue of an s8 x s8 -> s32 product.
//
// Port-only kernels: no TPU kernel stands behind them. They are the two
// passes over the activations of dlimgedit_tpu/ops/quant.py:67
// `int8_linear` (the s8 x s8 encoder linears of
// `Options.quantize_activations`), which XLA fuses on the TPU:
//
//   P2 (`quantize_activations_int8`, quant.py:57), per row of C values:
//     scale = max(max|x|, 1e-8) / 127,
//     q = clamp(round_half_even(x / scale), -127, 127) as int8;
//   P3 (quant.py:75-79), per element of the (M, N) int32 product:
//     y = round_to_dtype((float(acc) * x_scale[m]) * w_scale[n]),
//     y = round_to_dtype(float(y) + float(b[n])).
//
// Both are bit-equal to their plain PyTorch versions (ops/quant.py) and to
// JAX's functions: every product, quotient and sum is an explicitly
// rounded intrinsic (__fmul_rn, __fdiv_rn, __fadd_rn), which nvcc never
// contracts into an FMA nor replaces by a reciprocal, and rintf rounds half
// to even as torch.round and jnp.round do. Nothing here may be built with
// --use_fast_math (ops/cuda_build.py does not).
//
// What bounds both on an H100: bytes. P2 reads each row once (2 or 4 bytes
// a value) and writes one byte a value and a float32 scale a row; P3 reads
// the int32 product and writes the result (4 + 2 or 4 bytes an element).
// Neither does more than a few operations a byte.
//
// Design. P2 keeps a whole row in registers, so it is read from device
// memory once: one warp per row for C = 32 * VPT (the TinyViT and ViT
// token widths and TinyViT's MLP widths, 128 ... 1280), one block of four
// warps per row for C = 128 * VPT (the ViT MLP widths 3072, 4096, 5120);
// the row's absmax is a warp shuffle reduction (and, across four warps, a
// reduction through shared memory). Thread t owns columns t, t + T, ...
// (T threads a row), so each load of a warp is one contiguous span. P3 is
// an elementwise pass: each thread takes four consecutive elements of one
// row (N a multiple of 4, so a group never crosses a row) with one 16-byte
// load of the product.
//
// Any other width (JAX's int8_linear takes any C and N). P2: one warp a
// row, lane t taking columns t, t + 32, ... up to C (the last pass of the
// row masked), the row read twice, for its absmax and then for its quanta
// (the second read from L1 / L2); the absmax and every quantum are the
// same values whatever the order, so it stays bit-equal. P3: one element
// a thread where N is not a multiple of 4 (or the product does not start
// on 16 bytes). These bodies are right first; their speed is later work.
//
// Element types: float32, bf16 and float16. P2 reads x in its dtype; P3
// rounds y to the dtype and adds b in it, as JAX's
// `y.astype(x.dtype) + b.astype(x.dtype)`.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace dlimg {

// Blocks an SM that P2's float16 instances ask of ptxas (the second
// argument of `__launch_bounds__`): with none, ptxas held the C = 4096
// instance to 48 registers and spilled 4 bytes (as it does the bf16 one).
// 0, which nvcc emits as no bound at all, keeps the float32 and bf16
// instances as they are.
template <typename T>
constexpr int kQuantMinBlocks = std::is_same<T, __half>::value ? 2 : 0;

constexpr int kQuantThreads = 256;
constexpr int kEpilogueThreads = 256;
constexpr int kEpilogueMaxBlocks = 132 * 16;

__device__ __forceinline__ int8_t quantize_one(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// WPR warps a row, VPT values a thread: rows of C = 32 * WPR * VPT.
template <typename T, int VPT, int WPR>
__global__ void __launch_bounds__(kQuantThreads, kQuantMinBlocks<T>)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale_out, int rows) {
  constexpr int kRowThreads = 32 * WPR;
  constexpr int C = VPT * kRowThreads;
  constexpr int kRowsPerBlock = kQuantThreads / kRowThreads;
  const int r = threadIdx.x / kRowThreads;
  const int t = threadIdx.x % kRowThreads;
  const int row = blockIdx.x * kRowsPerBlock + r;
  const bool valid = row < rows;
  const size_t base = static_cast<size_t>(row) * C;
  float v[VPT];
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    v[i] = valid ? to_float(x[base + t + kRowThreads * i]) : 0.f;
    m = fmaxf(m, fabsf(v[i]));
  }
  m = warp_max(m);
  if constexpr (WPR > 1) {
    // Every thread reaches the barrier: rows past the end hold zeros.
    __shared__ float part[kQuantThreads / 32];
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = m;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WPR; ++w) m = fmaxf(m, part[r * WPR + w]);
  }
  if (!valid) return;
  const float s = __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
#pragma unroll
  for (int i = 0; i < VPT; ++i) q[base + t + kRowThreads * i] = quantize_one(v[i], s);
  if (t == 0) scale_out[row] = s;
}

template <typename T, int VPT, int WPR>
cudaError_t launch_quantize_rows(const void* x, void* q, void* scale, int rows,
                                 cudaStream_t stream) {
  constexpr int kRowsPerBlock = kQuantThreads / (32 * WPR);
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  quantize_rows_kernel<T, VPT, WPR><<<blocks, kQuantThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale),
      rows);
  return cudaGetLastError();
}

// Any width: a warp a row, the row read twice (absmax, then quanta).
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_any_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scale_out, int rows, int cols) {
  const int row = blockIdx.x * (kQuantThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const T* xr = x + static_cast<size_t>(row) * cols;
  float m = 0.f;
  for (int c = lane; c < cols; c += 32) m = fmaxf(m, fabsf(to_float(xr[c])));
  m = warp_max(m);
  const float s = __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
  int8_t* qr = q + static_cast<size_t>(row) * cols;
  for (int c = lane; c < cols; c += 32) qr[c] = quantize_one(to_float(xr[c]), s);
  if (lane == 0) scale_out[row] = s;
}

template <typename T>
cudaError_t launch_quantize_rows_any(const void* x, void* q, void* scale, int rows,
                                     int cols, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kQuantThreads / 32;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  quantize_rows_any_kernel<T><<<blocks, kQuantThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale), rows,
      cols);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_quantize_rows(const void* x, void* q, void* scale, int rows,
                                   int cols, cudaStream_t stream) {
  switch (cols) {
#define DLIMG_QR_CASE(VPT, WPR) \
  case VPT * 32 * WPR:          \
    return launch_quantize_rows<T, VPT, WPR>(x, q, scale, rows, stream);
    DLIMG_QR_CASE(4, 1)    // 128
    DLIMG_QR_CASE(5, 1)    // 160
    DLIMG_QR_CASE(10, 1)   // 320
    DLIMG_QR_CASE(16, 1)   // 512
    DLIMG_QR_CASE(20, 1)   // 640
    DLIMG_QR_CASE(24, 1)   // 768
    DLIMG_QR_CASE(32, 1)   // 1024
    DLIMG_QR_CASE(40, 1)   // 1280
    DLIMG_QR_CASE(24, 4)   // 3072
    DLIMG_QR_CASE(32, 4)   // 4096
    DLIMG_QR_CASE(40, 4)   // 5120
#undef DLIMG_QR_CASE
    default:
      return launch_quantize_rows_any<T>(x, q, scale, rows, cols, stream);
  }
}

template <typename T>
__global__ void __launch_bounds__(kEpilogueThreads)
int8_epilogue_kernel(const int32_t* __restrict__ acc, const float* __restrict__ x_scale,
                     const float* __restrict__ w_scale, const T* __restrict__ b,
                     T* __restrict__ y, int cols, size_t groups) {
  for (size_t g = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t e = g * 4;
    const int row = static_cast<int>(e / cols);
    const int col = static_cast<int>(e % cols);
    const int4 a = reinterpret_cast<const int4*>(acc)[g];
    const int av[4] = {a.x, a.y, a.z, a.w};
    const float sx = x_scale[row];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      T out = from_float<T>(
          __fmul_rn(__fmul_rn(__int2float_rn(av[k]), sx), w_scale[col + k]));
      if (b != nullptr) out = from_float<T>(__fadd_rn(to_float(out), to_float(b[col + k])));
      y[e + k] = out;
    }
  }
}

// Any width: one element a thread.
template <typename T>
__global__ void __launch_bounds__(kEpilogueThreads)
int8_epilogue_any_kernel(const int32_t* __restrict__ acc, const float* __restrict__ x_scale,
                         const float* __restrict__ w_scale, const T* __restrict__ b,
                         T* __restrict__ y, int cols, size_t n) {
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(e / cols);
    const int col = static_cast<int>(e % cols);
    T out = from_float<T>(
        __fmul_rn(__fmul_rn(__int2float_rn(acc[e]), x_scale[row]), w_scale[col]));
    if (b != nullptr) out = from_float<T>(__fadd_rn(to_float(out), to_float(b[col])));
    y[e] = out;
  }
}

// Groups of four elements (16-byte loads of the product) where a row holds
// whole groups and the product starts on 16 bytes, else one element a
// thread.
template <typename T>
cudaError_t launch_int8_epilogue(const void* acc, const void* x_scale,
                                 const void* w_scale, const void* b, void* y,
                                 int rows, int cols, cudaStream_t stream) {
  const bool vec = cols % 4 == 0 && reinterpret_cast<uintptr_t>(acc) % 16 == 0;
  const size_t items = static_cast<size_t>(rows) * cols / (vec ? 4 : 1);
  size_t blocks = (items + kEpilogueThreads - 1) / kEpilogueThreads;
  if (blocks > kEpilogueMaxBlocks) blocks = kEpilogueMaxBlocks;
  const int32_t* a = static_cast<const int32_t*>(acc);
  const float* xs = static_cast<const float*>(x_scale);
  const float* ws = static_cast<const float*>(w_scale);
  const T* bt = static_cast<const T*>(b);
  T* yt = static_cast<T*>(y);
  if (vec)
    int8_epilogue_kernel<T><<<static_cast<int>(blocks), kEpilogueThreads, 0, stream>>>(
        a, xs, ws, bt, yt, cols, items);
  else
    int8_epilogue_any_kernel<T><<<static_cast<int>(blocks), kEpilogueThreads, 0, stream>>>(
        a, xs, ws, bt, yt, cols, items);
  return cudaGetLastError();
}

}  // namespace dlimg

// P2: x (rows, cols) float32, bf16 or float16 -> q (rows, cols) int8 and
// scale (rows,) float32. Any cols >= 1: the cases of dispatch_quantize_rows
// (ops/quant.py QUANT_ROW_WIDTHS) run instances of their own, other widths
// the width-generic body.
extern "C" int dlimg_quantize_rows_int8(const void* x, void* q, void* scale, int rows,
                                        int cols, int dtype, void* stream) {
  if (rows <= 0) return 0;
  if (cols <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dlimg::kDtypeF32)
    return dlimg::dispatch_quantize_rows<float>(x, q, scale, rows, cols, s);
  if (dtype == dlimg::kDtypeBF16)
    return dlimg::dispatch_quantize_rows<__nv_bfloat16>(x, q, scale, rows, cols, s);
  if (dtype == dlimg::kDtypeF16)
    return dlimg::dispatch_quantize_rows<__half>(x, q, scale, rows, cols, s);
  return cudaErrorInvalidValue;
}

// P3: acc (rows, cols) int32, x_scale (rows,) and w_scale (cols,) float32, b
// (cols,) in the output dtype or null -> y (rows, cols); any cols >= 1
// (16-byte loads of acc where cols % 4 == 0 and acc starts on 16 bytes).
extern "C" int dlimg_int8_epilogue(const void* acc, const void* x_scale,
                                   const void* w_scale, const void* b, void* y, int rows,
                                   int cols, int dtype, void* stream) {
  if (rows <= 0) return 0;
  if (cols <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dlimg::kDtypeF32)
    return dlimg::launch_int8_epilogue<float>(acc, x_scale, w_scale, b, y, rows, cols, s);
  if (dtype == dlimg::kDtypeBF16)
    return dlimg::launch_int8_epilogue<__nv_bfloat16>(acc, x_scale, w_scale, b, y, rows,
                                                      cols, s);
  if (dtype == dlimg::kDtypeF16)
    return dlimg::launch_int8_epilogue<__half>(acc, x_scale, w_scale, b, y, rows, cols, s);
  return cudaErrorInvalidValue;
}
