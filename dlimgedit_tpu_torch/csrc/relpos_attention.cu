// K4, K5 and K7: attention with the MViTv2 decomposed relative-position
// bias of the SAM ViT encoders, exact float32 softmax.
//
// This file holds the three C entry points, each of which picks its body by
// dtype: in bf16 (the ViT main paths' dtype) all three run on the tensor
// cores in relpos_attention_tc.cu; in float32 K4 and K5 run on the tensor
// cores in three TF32 passes (relpos_attention_f32tc.cu) and K7 on this
// file's CUDA-core body (Design, below).
//
// K4 (`dlimg_relpos_attention_global`) replaces the TPU kernel
// dlimgedit_tpu/ops/flash_attention.py:139 `_attention_grouped` (Pallas
// body `_kernel`, :32): the global blocks, one group per head over the
// whole token grid (ViT-B at 1024: 12 groups of N = 4096, hd = 64).
// K5 (`dlimg_relpos_attention_windowed`) replaces :307
// `_attention_head_fused` (bodies `_head_loop_kernel` :264 and
// `_head_loop_kernel_folded` :248): the windowed blocks (25 windows x 12
// heads of N = 196), with the folded bias and the pad-query skip of the
// bottom window row in the same launch.
// K7 (`dlimg_relpos_attention_qkv`) replaces :382 `windowed_attention_qkv`
// (body `_head_loop_kernel_qkv`, :285): windows whose q, k and v are the
// three components of ONE (W, 3, nh, N, hd) tensor, addressed in place by
// per-group offsets; the bias halves are not folded and no query row is
// skipped.
//
// For group g (a head of an image or of a window) with token grid gh x gw,
// token i at (y_i, x_i) = divmod(i, gw), and bias halves
// bhw[g, i] = [q_i . rh[y_i, :] | q_i . rw[x_i, :]] (gh + gw values,
// computed and rounded to the activation dtype by the caller):
//   s[i, j] = (q_i . k_j) * scale + (bh[i, y_j] + bw[i, x_j])     plain
//   s[i, j] = (q_i . k_j + bh[i, y_j] + bw[i, x_j]) * scale       folded
//                       (the caller passed the halves divided by scale)
//   p = softmax_j(s) in float32, rounded to the activation dtype
//   out[g, i] = p . v in float32, rounded to the activation dtype
// and for groups g >= g_skip only the first n_valid query rows are
// computed; the others are written as zeros (K5's pad-query skip).
// The bias is added by index; the TPU kernel's one-hot selector matmul
// (`_selector_matrix`, :180) was a Mosaic workaround and is not ported.
//
// What bounds it on an H100: operations. K4 does 4 G N^2 hd = 51.5 GFLOP
// per launch at ViT-B 1024 (52 us at the bf16 tensor-core peak) against
// ~25 MB of q, k, v, bias halves and output (7.5 us at 3.35 TB/s). K5 is
// at N = 196 near the ridge: ~4 GFLOP against ~33 MB; K7 at ViT-B's
// windows: ~3.0 GFLOP against ~33 MB (qkv, bias halves, output).
//
// Design of the CUDA-core body (float32 K7): an EXACT two-pass softmax, so
// p is normalised before it is rounded, exactly where the JAX kernel rounds
// it (the identity in float32; the body was written for bf16 K4 too). K and V of a global head
// (4096 x 64 bf16 = 512 KB each) do not fit shared memory, so neither the
// TPU's whole-row score tile nor a row of 4096 float scores per query of a
// 64-row tile can stay on chip; instead key tiles are streamed twice. A
// block of 256 threads owns 64 query rows of one group:
//   pass 1 streams K in 64-key tiles and keeps each row's running max m and
//          sum l of exp(s - m) (statistics only, no probabilities);
//   pass 2 streams K and V again, recomputes the scores, forms
//          p = exp(s - m) / l, rounds it to the dtype, stages it in shared
//          memory and accumulates p . v in registers.
// Recomputing q . k costs 1.5x the minimal operations in exchange for the
// JAX rounding of p. Each thread owns a 4 x 4 cell of the 64 x 64 score
// tile (rows ty + 16 i, keys tx + 16 j) and 4 x hd/16 outputs; q and K sit
// transposed in shared memory with padded rows so that the inner products
// read without bank conflicts, and row reductions are shuffles across the
// 16 lanes that share a row. The block's bias halves (64 x (gh + gw)) are
// staged once. All arithmetic is float32 on the CUDA cores, which keeps the
// body exact for float32 (2e-5 against the plain version needs float32
// products, not TF32).
#include <math.h>

#include "relpos_attention.cuh"

namespace dlimg {

constexpr int kRpThreads = 256;
constexpr int kRpBQ = 64;         // query rows per block
constexpr int kRpBK = 64;         // keys per tile
constexpr int kRpQS = kRpBQ + 1;  // row stride of q^T in shared memory
constexpr int kRpKS = kRpBK + 1;  // row stride of K^T
constexpr int kRpPS = kRpBQ + 2;  // row stride of p^T (conflict-free stores)

template <int HD>
size_t relpos_smem_bytes(int ghw) {
  return sizeof(float) *
         (static_cast<size_t>(HD) * (kRpQS + kRpKS) + static_cast<size_t>(kRpBK) * HD +
          static_cast<size_t>(kRpBK) * kRpPS + static_cast<size_t>(kRpBQ) * (ghw + 1));
}

// Reductions over the 16 lanes (tx = 0..15) that hold one query row.
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// K7: group g = (window w, head h) reads q, k, v in place from the
// (W, 3, nh, n, HD) qkv; plain bias, every row kept.
template <int HD>
__device__ __forceinline__ void relpos_attention_body(const RelposArgs& a) {
  static_assert(HD % 16 == 0, "head width must be a multiple of 16");
  constexpr int DJ = HD / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  const int ghw = a.gh + a.gw;
  const int bs_stride = ghw + 1;
  float* qT = smem;               // HD x kRpQS
  float* kT = qT + HD * kRpQS;    // HD x kRpKS
  float* vs = kT + HD * kRpKS;    // kRpBK x HD
  float* pT = vs + kRpBK * HD;    // kRpBK x kRpPS
  float* bs = pT + kRpBK * kRpPS; // kRpBQ x bs_stride

  const int n = a.n;
  const int g = blockIdx.y;
  const int q0 = blockIdx.x * kRpBQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t gbase = static_cast<size_t>(g) * n;
  const size_t w = g / a.qkv_heads, h = g % a.qkv_heads;
  const size_t hn = static_cast<size_t>(a.qkv_heads) * n;
  const size_t qbase = w * 3 * hn + h * n;
  const float* q = static_cast<const float*>(a.q) + qbase * HD;
  const float* k = q + hn * HD;
  const float* v = k + hn * HD;
  const float* bhw = static_cast<const float*>(a.bhw) + gbase * ghw;
  float* out = static_cast<float*>(a.out) + gbase * HD;

  for (int e = tid; e < kRpBQ * HD; e += kRpThreads) {
    const int r = e / HD, d = e % HD;
    qT[d * kRpQS + r] =
        q0 + r < n ? q[static_cast<size_t>(q0 + r) * HD + d] : 0.f;
  }
  for (int e = tid; e < kRpBQ * ghw; e += kRpThreads) {
    const int r = e / ghw, c = e % ghw;
    bs[r * bs_stride + c] =
        q0 + r < n ? bhw[static_cast<size_t>(q0 + r) * ghw + c] : 0.f;
  }

  auto load_k = [&](int k0) {
    for (int e = tid; e < kRpBK * HD; e += kRpThreads) {
      const int c = e / HD, d = e % HD;
      kT[d * kRpKS + c] =
          k0 + c < n ? k[static_cast<size_t>(k0 + c) * HD + d] : 0.f;
    }
  };

  // This thread's 4 x 4 scores of the tile at key k0: rows ty + 16 i, keys
  // k0 + tx + 16 j; keys past n score -inf.
  auto scores = [&](int k0, float (&s)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qT[d * kRpQS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kT[d * kRpKS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      if (key >= n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;
        continue;
      }
      const int ky = key / a.gw;
      const int kx = key - ky * a.gw;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* br = bs + (ty + 16 * i) * bs_stride;
        const float b = br[ky] + br[a.gh + kx];
        s[i][j] = __fadd_rn(__fmul_rn(s[i][j], a.scale), b);
      }
    }
  };

  const int n_tiles = (n + kRpBK - 1) / kRpBK;

  // Pass 1: each row's max m and sum l of exp(s - m) over all keys.
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kRpBK;
    __syncthreads();
    load_k(k0);
    __syncthreads();
    float s[4][4];
    scores(k0, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float tmax =
          row_max16(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float mn = fmaxf(m[i], tmax);
      float ts = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) ts += expf(s[i][j] - mn);
      l[i] = l[i] * expf(m[i] - mn) + row_sum16(ts);
      m[i] = mn;
    }
  }

  // Pass 2: p = exp(s - m) / l rounded to the dtype, out = p . v.
  float o[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kRpBK;
    __syncthreads();
    load_k(k0);
    for (int e = tid; e < kRpBK * HD; e += kRpThreads) {
      const int c = e / HD;
      vs[e] = k0 + c < n ? v[static_cast<size_t>(k0) * HD + e] : 0.f;
    }
    __syncthreads();
    float s[4][4];
    scores(k0, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m[i]) / l[i];
        pT[(tx + 16 * j) * kRpPS + ty + 16 * i] = p;
      }
    __syncthreads();
    const int kc = min(kRpBK, n - k0);
#pragma unroll 4
    for (int c = 0; c < kc; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = pT[c * kRpPS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * HD + tx + 16 * j];
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
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      out[static_cast<size_t>(r) * HD + tx + 16 * j] = o[i][j];
  }
}

// float32 K7 (K4 and K5 run in relpos_attention_f32tc.cu).
template <int HD>
__global__ void __launch_bounds__(kRpThreads, 2) relpos_qkv_kernel(RelposArgs a) {
  relpos_attention_body<HD>(a);
}

enum RelposKind { kRelposGlobal, kRelposWindowed, kRelposQkv };

template <int HD>
cudaError_t launch_relpos_qkv(const RelposArgs& a, int g, cudaStream_t stream) {
  const size_t smem = relpos_smem_bytes<HD>(a.gh + a.gw);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        &relpos_qkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.n + kRpBQ - 1) / kRpBQ, g);
  relpos_qkv_kernel<HD><<<grid, kRpThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int KIND>
int relpos_entry(const RelposArgs& a, int g, int hd, int dtype, void* stream) {
  if (g <= 0 || a.n <= 0) return 0;
  if (g > 65535 || a.gh <= 0 || a.gw <= 0 || a.gh * a.gw != a.n || a.n_valid < 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32) {
    // K4 and K5 run in three TF32 passes on the tensor cores
    // (relpos_attention_f32tc.cu), K7 on the CUDA-core body above.
    if constexpr (KIND == kRelposGlobal) {
      return relpos_global_f32tc(a, g, hd, s);
    } else if constexpr (KIND == kRelposWindowed) {
      return relpos_windowed_f32tc(a, g, hd, s);
    } else {
      if (hd == 64) return launch_relpos_qkv<64>(a, g, s);
      if (hd == 80) return launch_relpos_qkv<80>(a, g, s);
    }
  } else if (dtype == kDtypeBF16) {
    // bf16 runs on the tensor cores (relpos_attention_tc.cu); K7 is the
    // windowed body with a.qkv_heads set.
    if constexpr (KIND == kRelposGlobal) {
      return relpos_global_tc(a, g, hd, s);
    } else {
      return relpos_windowed_tc(a, g, hd, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace dlimg

// q, k, v, out: (g, n, hd); bhw: (g, n, gh + gw); all contiguous and of one
// dtype; n == gh * gw; hd in {64, 80} (ops/flash_attention.py
// KERNEL_HEAD_DIMS).
extern "C" int dlimg_relpos_attention_global(const void* q, const void* k,
                                             const void* v, const void* bhw,
                                             void* out, int g, int n, int hd, int gh,
                                             int gw, int dtype, float scale,
                                             void* stream) {
  const dlimg::RelposArgs a{q, k, v, bhw, out, n, gh, gw, g, n, scale, 0, 0};
  return dlimg::relpos_entry<dlimg::kRelposGlobal>(a, g, hd, dtype, stream);
}

// The same with groups ordered (window, head); `folded` selects the folded
// bias, and groups >= g_skip compute only their first n_valid query rows.
extern "C" int dlimg_relpos_attention_windowed(const void* q, const void* k,
                                               const void* v, const void* bhw,
                                               void* out, int g, int n, int hd,
                                               int gh, int gw, int folded,
                                               int g_skip, int n_valid, int dtype,
                                               float scale, void* stream) {
  const dlimg::RelposArgs a{q, k, v, bhw, out, n, gh, gw, g_skip, n_valid, scale,
                            folded, 0};
  return dlimg::relpos_entry<dlimg::kRelposWindowed>(a, g, hd, dtype, stream);
}

// qkv: (w, 3, nh, n, hd) contiguous; bhw: (w * nh, n, gh + gw), unfolded;
// out: (w, nh, n, hd); groups ordered (window, head) as for K5.
extern "C" int dlimg_relpos_attention_qkv(const void* qkv, const void* bhw, void* out,
                                          int w, int nh, int n, int hd, int gh, int gw,
                                          int dtype, float scale, void* stream) {
  if (nh <= 0) return cudaErrorInvalidValue;
  const int g = w * nh;
  const dlimg::RelposArgs a{qkv, qkv, qkv, bhw, out, n, gh, gw, g, n, scale, 0, nh};
  return dlimg::relpos_entry<dlimg::kRelposQkv>(a, g, hd, dtype, stream);
}
