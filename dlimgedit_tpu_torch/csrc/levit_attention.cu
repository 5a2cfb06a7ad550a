// K2: LeViT-bias window attention (TinyViT), exact float32 softmax.
//
// Replaces the TPU kernel dlimgedit_tpu/ops/flash_attention.py:531
// `levit_window_attention` (Pallas body `_levit_kernel`, :500). For window
// g and head h, with kd = 32:
//   q, k, v = qkv[g][:, h*3kd + [0, kd)], [+kd, +2kd), [+2kd, +3kd)
//   s = q k^T * kd^-1/2 + bias[h]            (float32)
//   p = softmax(s) (exact, float32), rounded to the activation dtype
//   out[g][:, h*kd + [0, kd)] = p v          (float32 accumulation)
// q, k and v are read in place from the qkv linear's output; no head
// transpose and no score tensor is ever written to device memory.
//
// What bounds it on an H100: bytes. Per window and head it reads 3 N kd
// values and writes N kd values, while doing 4 N^2 kd operations: N / 2
// operations per byte in bf16 (25 at N = 49, 98 at N = 196), below the
// ~295 where the tensor cores would become the limit. The least time is
// (qkv + bias + out bytes) / 3.35 TB/s.
//
// Design: one block of 8 warps per (window, head, chunk of 32 query rows);
// the chunks keep the card busy where windows are few (stage 2 at 1024 has
// 25 windows x 5 heads = 125 (window, head) pairs for 132 SMs). K and V of
// that head are staged in shared memory (N x 32 each; K rows padded so that
// 32 lanes reading 32 different rows hit 32 different banks). Each warp
// takes query rows of the chunk in turn. Lane l holds q[l] and the scores
// of keys l, l+32, ... in registers (at most 8 per lane, N <= 256), so max,
// exp and sum are warp shuffles. For p v, each p_j is broadcast from the
// lane that owns key j with a shuffle and lane l accumulates output column
// l. No wgmma and no TMA: the arithmetic runs on the CUDA cores, which
// keeps the kernel simple and exact; moving the two products to the tensor
// cores is later work.
#include <math.h>

#include "common.cuh"

namespace dlimg {

constexpr int kKd = 32;
constexpr int kAttnWarps = 8;
constexpr int kRowsPerBlock = 32;

template <typename T>
__host__ __device__ constexpr int k_row_stride() {
  // Padded K row stride in elements: 17 words for bf16, 33 for float, so
  // that rows j and j + 1 start in different banks.
  return sizeof(T) == 2 ? kKd + 2 : kKd + 1;
}

template <typename T>
size_t attention_smem_bytes(int n) {
  return static_cast<size_t>(n) * (k_row_stride<T>() + kKd) * sizeof(T);
}

template <typename T, int NT>
__global__ void __launch_bounds__(kAttnWarps * 32)
levit_attention_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                       T* __restrict__ out, int n, int nh, float scale) {
  constexpr int KS = k_row_stride<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // n x KS
  T* vs = ks + n * KS;                     // n x kKd

  const int g = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const int row_stride = nh * 3 * kKd;  // qkv channels per token
  const T* base = qkv + static_cast<size_t>(g) * n * row_stride + h * 3 * kKd;

  for (int e = threadIdx.x; e < n * kKd; e += blockDim.x) {
    const int j = e / kKd, d = e % kKd;
    const T* src = base + static_cast<size_t>(j) * row_stride;
    ks[j * KS + d] = src[kKd + d];
    vs[j * kKd + d] = src[2 * kKd + d];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* bh = bias + static_cast<size_t>(h) * n * n;
  T* ob = out + static_cast<size_t>(g) * n * (nh * kKd) + h * kKd;

  const int row_end = min(n, (static_cast<int>(blockIdx.y) + 1) * kRowsPerBlock);
  for (int i = blockIdx.y * kRowsPerBlock + warp; i < row_end; i += kAttnWarps) {
    const float qv = to_float(base[static_cast<size_t>(i) * row_stride + lane]);
    float s[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) s[t] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kKd; ++d) {
      const float qd = __shfl_sync(kFullMask, qv, d);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int j = t * 32 + lane;
        if (j < n) s[t] += qd * to_float(ks[j * KS + d]);
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int j = t * 32 + lane;
      if (j < n) {
        s[t] = s[t] * scale + to_float(bh[static_cast<size_t>(i) * n + j]);
        m = fmaxf(m, s[t]);
      }
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int j = t * 32 + lane;
      s[t] = j < n ? expf(s[t] - m) : 0.f;
      sum += s[t];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < NT; ++t) s[t] = to_float(from_float<T>(s[t] / sum));

    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int valid = min(32, n - t * 32);  // the same on every lane
      for (int src = 0; src < valid; ++src) {
        const float pj = __shfl_sync(kFullMask, s[t], src);
        acc += pj * to_float(vs[(t * 32 + src) * kKd + lane]);
      }
    }
    ob[static_cast<size_t>(i) * (nh * kKd) + lane] = from_float<T>(acc);
  }
}

template <typename T, int NT>
cudaError_t launch_attention(const void* qkv, const void* bias, void* out, int g,
                             int n, int nh, float scale, cudaStream_t stream) {
  const size_t smem = attention_smem_bytes<T>(n);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        levit_attention_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(g * nh, (n + kRowsPerBlock - 1) / kRowsPerBlock);
  levit_attention_kernel<T, NT><<<grid, kAttnWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(bias), static_cast<T*>(out),
      n, nh, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_attention(const void* qkv, const void* bias, void* out, int g,
                               int n, int nh, float scale, cudaStream_t stream) {
  switch ((n + 31) / 32) {
#define DLIMG_ATTN_CASE(NT) \
  case NT:                  \
    return launch_attention<T, NT>(qkv, bias, out, g, n, nh, scale, stream);
    DLIMG_ATTN_CASE(1)
    DLIMG_ATTN_CASE(2)
    DLIMG_ATTN_CASE(3)
    DLIMG_ATTN_CASE(4)
    DLIMG_ATTN_CASE(5)
    DLIMG_ATTN_CASE(6)
    DLIMG_ATTN_CASE(7)
    DLIMG_ATTN_CASE(8)
#undef DLIMG_ATTN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace dlimg

// qkv: (g, n, nh * 3 * 32), bias: (nh, n, n), out: (g, n, nh * 32), all
// contiguous and of one dtype; 1 <= n <= 256.
extern "C" int dlimg_levit_attention(const void* qkv, const void* bias, void* out,
                                     int g, int n, int nh, int kd, int dtype,
                                     float scale, void* stream) {
  if (g <= 0) return 0;
  if (kd != dlimg::kKd || n <= 0 || nh <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dlimg::kDtypeF32)
    return dlimg::dispatch_attention<float>(qkv, bias, out, g, n, nh, scale, s);
  if (dtype == dlimg::kDtypeBF16)
    return dlimg::dispatch_attention<__nv_bfloat16>(qkv, bias, out, g, n, nh, scale, s);
  return cudaErrorInvalidValue;
}
