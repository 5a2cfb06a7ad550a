// K6: windowed attention with the MViTv2 decomposed relative-position bias
// of the SAM ViT encoders, read in place from the padded NHWC q, k and v
// (the three channel slices of the qkv linear's output), bias halves
// computed in the kernel, exact float32 softmax. This file's CUDA-core body
// runs float32 inputs; bf16 (the ViT's dtype) runs on the tensor cores
// (relpos_attention_tc.cu, `window_strip_kernel_tc`), picked by dtype in
// the C entry point below.
//
// Replaces the TPU kernel dlimgedit_tpu/ops/flash_attention.py:646
// `windowed_attention_fused` (Pallas body `_window_strip_kernel`, :575): the
// ViT's windowed blocks on the `fused_window_blocks` path. For a window
// (wy, wx) of ws x ws tokens, a head h of width HD, token i at window
// position (y_i, x_i) = divmod(i, ws) and the gathered tables rh, rw
// (ws, ws, HD) in the activation dtype:
//   bh[i, y] = sum_d q_i[d] rh[y_i, y, d]    rounded to the dtype
//   bw[i, x] = sum_d q_i[d] rw[x_i, x, d]    rounded to the dtype
//   s[i, j]  = ((q_i . k_j) * scale + bh[i, y_j]) + bw[i, x_j]   (float32)
//   p = softmax_j(s) in float32, rounded to the dtype
//   out[i] = p . v in float32, rounded to the dtype
// for every token of the padded grid (pad rows and columns included; the
// caller crops). The bias is added by index; the TPU kernel's one-hot
// selector matmuls were a Mosaic workaround and are not ported.
//
// What bounds it on an H100: operations. ViT-B at 1024 (q, k, v slices of a
// (1, 70, 70, 2304) bf16 qkv, 25 windows x 12 heads of 196 tokens) needs
// ~22.6 MB read and 7.5 MB written (~9 us at 3.35 TB/s) against ~3.0 GFLOP
// of q.k and p.v products.
//
// Design. The TPU kernel slices a strip of ws padded rows per program; on
// Hopper a block takes 64 query rows of one (batch, window, head), so that
// ViT-B gives 1200 blocks for 132 SMs. The block stages the window's K
// (transposed) and V in shared memory in the activation dtype, straight from
// the strided NHWC rows (token stride `ts`: 3C for the slices of the qkv
// output, so there is no partition copy and no `.contiguous()`) in 16-byte
// loads, and its 64 query rows in float32. The bias halves of those rows
// are computed there from the staged q and the tables (16 lanes per dot
// product, reading a table row coalesced, four dot products in flight per
// lane group so that table loads and shuffle reductions overlap), rounded
// and kept in shared memory. With N = 196
// keys a whole score row fits in registers: each thread owns 4 query rows
// x 13 keys (rows ty + 16 i, keys tx + 16 j), so the softmax is exact in
// one pass (max and sum by shuffles across the 16 lanes of a row), p is
// normalised and rounded where JAX rounds it, and p . v runs over 64-key
// chunks of p staged transposed in shared memory. Float32 on the CUDA
// cores throughout (2e-5 against the plain version needs float32 products).
#include <math.h>

#include "relpos_attention.cuh"

namespace dlimg {

constexpr int kWsThreads = 256;
constexpr int kWsBQ = 64;               // query rows per block
constexpr int kWsNJ = 13;               // keys per lane: tx + 16 j, j < 13
constexpr int kWsMaxN = 16 * kWsNJ;     // 208 >= 14 * 14 tokens per window
constexpr int kWsKS = kWsMaxN + 2;      // row stride of K^T (conflict-free stores)
constexpr int kWsPC = 64;               // keys per chunk of p^T
constexpr int kWsPS = kWsBQ + 2;        // row stride of p^T

template <typename T, int HD>
size_t strip_smem_bytes(int ws) {
  const size_t bias = (static_cast<size_t>(kWsBQ) * (2 * ws + 1) + 3) & ~static_cast<size_t>(3);
  return sizeof(float) * (static_cast<size_t>(kWsBQ) * (HD + 4) +
                          static_cast<size_t>(kWsPC) * kWsPS + bias) +
         sizeof(T) * static_cast<size_t>(HD) * (kWsKS + ws * ws);
}

// Reductions over the 16 lanes (tx = 0..15) that hold one query row.
__device__ __forceinline__ float strip_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float strip_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWsThreads, 2)
    window_strip_attention_kernel(StripArgs a) {
  static_assert(HD % 16 == 0, "head width must be a multiple of 16");
  constexpr int DJ = HD / 16;  // output columns per thread
  constexpr int QS = HD + 4;   // row stride of the staged q
  extern __shared__ __align__(16) float smem[];
  const int ws = a.ws, n = ws * ws, nb = 2 * ws, bstride = nb + 1;
  float* qs = smem;                      // kWsBQ x QS
  float* pT = qs + kWsBQ * QS;           // kWsPC x kWsPS
  float* bs = pT + kWsPC * kWsPS;        // kWsBQ x bstride
  T* kT = reinterpret_cast<T*>(bs + ((kWsBQ * bstride + 3) & ~3));  // HD x kWsKS
  T* vs = kT + HD * kWsKS;               // n x HD

  const int q0 = blockIdx.x * kWsBQ;
  const int head = blockIdx.y;
  const int n_wx = a.wp / ws, n_wy = a.hp / ws;
  const int b = blockIdx.z / (n_wy * n_wx);
  const int wy = (blockIdx.z / n_wx) % n_wy, wx = blockIdx.z % n_wx;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* qp = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const T* rh = static_cast<const T*>(a.rh);
  const T* rw = static_cast<const T*>(a.rw);
  T* out = static_cast<T*>(a.out);

  // Element offset of channel 0 of this head for window token t, in a
  // tensor of token stride `stride`.
  auto tok_off = [&](int t, int stride) -> size_t {
    const int y = wy * ws + t / ws, x = wx * ws + t % ws;
    return ((static_cast<size_t>(b) * a.hp + y) * a.wp + x) * stride +
           static_cast<size_t>(head) * HD;
  };

  // Stage K^T (keys past n are zero), V and the block's query rows, in
  // 16-byte chunks of a token's head (the wrapper checks the alignment).
  constexpr int VEC = 16 / sizeof(T);  // elements per chunk
  constexpr int CH = HD / VEC;         // chunks per token
  for (int e = tid; e < n * CH; e += kWsThreads) {
    const int t = e / CH, c = e % CH;
    const size_t off = tok_off(t, a.ts) + c * VEC;
    const uint4 k4 = *reinterpret_cast<const uint4*>(kp + off);
    *reinterpret_cast<uint4*>(vs + t * HD + c * VEC) =
        *reinterpret_cast<const uint4*>(vp + off);
    const T* ke = reinterpret_cast<const T*>(&k4);
#pragma unroll
    for (int u = 0; u < VEC; ++u) kT[(c * VEC + u) * kWsKS + t] = ke[u];
  }
  for (int e = tid; e < (kWsMaxN - n) * HD; e += kWsThreads)
    kT[(e % HD) * kWsKS + n + e / HD] = from_float<T>(0.f);
  for (int e = tid; e < kWsBQ * CH; e += kWsThreads) {
    const int r = e / CH, c = e % CH;
    float* qr = qs + r * QS + c * VEC;
    if (q0 + r < n) {
      const uint4 q4 =
          *reinterpret_cast<const uint4*>(qp + tok_off(q0 + r, a.ts) + c * VEC);
      const T* qe = reinterpret_cast<const T*>(&q4);
#pragma unroll
      for (int u = 0; u < VEC; ++u) qr[u] = to_float(qe[u]);
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u) qr[u] = 0.f;
    }
  }
  __syncthreads();

  // Bias halves of the block's rows: task (r, c) is bh[q0 + r, c] for
  // c < ws, bw[q0 + r, c - ws] else; the 16 lanes of a row group split the
  // head width and reduce by shuffles, four tasks at a time. kWsBQ * nb is
  // a multiple of 64, so every group runs the same number of tasks and the
  // shuffles stay whole.
  constexpr int kGroups = kWsThreads / 16;
  for (int t0 = ty; t0 < kWsBQ * nb; t0 += 4 * kGroups) {
    float acc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int task = t0 + u * kGroups;
      const int r = task / nb, c = task - (task / nb) * nb;
      const int i = q0 + r;
      acc[u] = 0.f;
      if (i < n) {
        const int yi = i / ws, xi = i - (i / ws) * ws;
        const T* tb = c < ws ? rh + (static_cast<size_t>(yi) * ws + c) * HD
                             : rw + (static_cast<size_t>(xi) * ws + (c - ws)) * HD;
        const float* qr = qs + r * QS;
#pragma unroll
        for (int d = tx; d < HD; d += 16) acc[u] = fmaf(qr[d], to_float(tb[d]), acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float sum = strip_sum16(acc[u]);
      const int task = t0 + u * kGroups;
      const int r = task / nb, c = task - (task / nb) * nb;
      if (tx == 0) bs[r * bstride + c] = q0 + r < n ? to_float(from_float<T>(sum)) : 0.f;
    }
  }
  __syncthreads();

  // Scores: this thread's rows ty + 16 i against keys tx + 16 j. A warp
  // (rows 2w, 2w + 1 mod 16) whose rows all lie past n skips the work.
  const int n_rows = min(kWsBQ, n - q0);
  const bool live = 2 * (tid / 32) < n_rows;
  float s[4][kWsNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kWsNJ; ++j) s[i][j] = 0.f;
  if (live) {
#pragma unroll 2
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[kWsNJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < kWsNJ; ++j) kv[j] = to_float(kT[d * kWsKS + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kWsNJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < kWsNJ; ++j) {
      const int key = tx + 16 * j;
      if (key >= n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;
        continue;
      }
      const int ky = key / ws, kx = key - (key / ws) * ws;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* br = bs + (ty + 16 * i) * bstride;
        s[i][j] = __fadd_rn(__fadd_rn(__fmul_rn(s[i][j], a.scale), br[ky]), br[ws + kx]);
      }
    }
    // Exact softmax over the whole row; p normalised, then rounded.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float m = s[i][0];
#pragma unroll
      for (int j = 1; j < kWsNJ; ++j) m = fmaxf(m, s[i][j]);
      m = strip_max16(m);
      float l = 0.f;
#pragma unroll
      for (int j = 0; j < kWsNJ; ++j) {
        s[i][j] = expf(s[i][j] - m);
        l += s[i][j];
      }
      l = strip_sum16(l);
#pragma unroll
      for (int j = 0; j < kWsNJ; ++j) s[i][j] = to_float(from_float<T>(s[i][j] / l));
    }
  }

  // out = p . v over 64-key chunks of p^T in shared memory.
  float o[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;
#pragma unroll
  for (int ch = 0; ch < (kWsNJ + 3) / 4; ++ch) {
    const int k0 = ch * kWsPC;
    if (k0 >= n) break;  // uniform across the block
    __syncthreads();     // the previous chunk's reads of p^T are done
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (ch * 4 + jj >= kWsNJ) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) pT[(tx + 16 * jj) * kWsPS + ty + 16 * i] = s[i][ch * 4 + jj];
    }
    __syncthreads();
    if (!live) continue;
    const int kc = min(kWsPC, n - k0);
#pragma unroll 4
    for (int c = 0; c < kc; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = pT[c * kWsPS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = to_float(vs[(k0 + c) * HD + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= n) continue;
    T* orow = out + tok_off(r, a.c);
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = from_float<T>(o[i][j]);
  }
}

template <typename T, int HD>
cudaError_t launch_strip(const StripArgs& a, int batch, cudaStream_t stream) {
  void (*kernel)(StripArgs) = &window_strip_attention_kernel<T, HD>;
  const size_t smem = strip_smem_bytes<T, HD>(a.ws);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int n = a.ws * a.ws;
  const dim3 grid((n + kWsBQ - 1) / kWsBQ, a.nh, batch * (a.hp / a.ws) * (a.wp / a.ws));
  kernel<<<grid, kWsThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace dlimg

// q, k, v: (b, hp, wp, *) of one dtype with token stride ts (>= c, unit
// channel stride, rows dense: the channel slices of a (b, hp, wp, 3c) qkv
// have ts = 3c), 16-byte aligned, ts a multiple of 16 bytes; rh, rw:
// (ws, ws, hd) contiguous; out: (b, hp, wp, c)
// contiguous; c == nh * hd, hp and wp multiples of ws, ws * ws <= 208, hd in
// {64, 80} (ops/flash_attention.py KERNEL_HEAD_DIMS).
extern "C" int dlimg_window_strip_attention(const void* q, const void* k, const void* v,
                                            const void* rh, const void* rw, void* out,
                                            int b, int hp, int wp, int c, int ts, int ws,
                                            int nh, int hd, int dtype, float scale,
                                            void* stream) {
  if (b <= 0 || hp <= 0 || wp <= 0) return 0;
  if (ws <= 0 || ws * ws > dlimg::kWsMaxN || hp % ws || wp % ws || nh <= 0 ||
      nh > 65535 || c != nh * hd || ts < c ||
      static_cast<long long>(b) * (hp / ws) * (wp / ws) > 65535)
    return cudaErrorInvalidValue;
  const dlimg::StripArgs a{q, k, v, rh, rw, out, hp, wp, c, ts, ws, nh, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DLIMG_WS_CASE(T, HD) \
  if (hd == HD) return dlimg::launch_strip<T, HD>(a, b, s);
  if (dtype == dlimg::kDtypeF32) {
    DLIMG_WS_CASE(float, 64)
    DLIMG_WS_CASE(float, 80)
  } else if (dtype == dlimg::kDtypeBF16) {
    return dlimg::window_strip_tc(a, b, hd, s);
  }
#undef DLIMG_WS_CASE
  return cudaErrorInvalidValue;
}
