// K2 in float32 on Hopper's tensor cores: TinyViT's (LeViT) window
// attention with a static per-head bias, exact softmax, every product in
// three TF32 passes.
//
// Replaces the TPU kernel dlimgedit_tpu/ops/flash_attention.py:531
// `levit_window_attention` (Pallas body `_levit_kernel`, :500), which asks
// for `Precision.HIGHEST` on float32 operands (:510). The function is that
// of levit_attention.cu's note, for window g and head h, kd = 32:
//   s = (q . k) * kd^-1/2 + bias[h]   float32, the bias added after the scale
//   p = softmax(s), exact, normalised in float32
//   out = p . v                       float32 accumulation
// with q, k, v = the head's three kd-column slices of the qkv linear's
// output row, out the head's kd columns of an nh * kd row. bf16 runs in
// levit_attention_tc.cuh, on the same tiling.
//
// Three TF32 passes, as relpos_attention_f32tc.cu (float32 K4, K5, K6)
// does and for its reasons (tests/test_torch_tf32x3.py emulates them on
// the CPU): each operand split as hi = TF32(x) and lo = TF32(x - hi), a
// product lo.hi + hi.lo + hi.hi on `mma.sync.m16n8k8.f32.tf32.tf32.f32`.
// A row of at most 256 keys is 32 k-steps of p . v (96 mma), which hold
// the accumulator's truncation within 2e-5 as K5's rows do.
//
// What bounds it on an H100: bytes. Per (window, head) it reads 3 N kd
// and writes N kd floats, with the bias N^2 floats a head, for 4 N^2 kd
// products: at MobileSAM's shapes (G, N, nh) = (361, 49, 4), (25, 196, 5),
// (100, 49, 10), 36.2, 13.3 and 25.2 MB (10.8, 4.0 and 7.5 us at 3.35
// TB/s) against 0.44, 0.61 and 0.31 GFLOP (three passes at a third of the
// 495 TFLOP/s TF32 peak: 2.7, 3.7 and 1.9 us).
//
// Design (levit_attention_tc.cuh's tiling, f32tc's fragments):
// - One block of 4 warps per (window, head, up to 64 query rows); a warp
//   owns one 16-row stripe. N = 49 is one block of 4 stripes a group;
//   N = 196 has 13 stripes over 4 blocks, each staging the group's K and V
//   again (25 KB each, from L2).
// - K and V arrive raw by 16-byte cp.async from the qkv rows (token stride
//   nh 96 floats, k at h 96 + 32, v at + 64), rows past N zero up to NP
//   (64, 208 or 256 keys), into the region that then holds the split V.
//   The block splits them once: K into the other region as [hi x 4 | lo x
//   4] per group of 4 dims, V through registers into (hi, lo) pairs. Both
//   regions have rows of 2 kd + 4 floats (4 mod 32 words), so 544 NP bytes
//   in all: two blocks share an SM at NP = 208.
// - While K and V land, each lane splits its two rows of q into hi / lo A
//   fragments in registers (kd = 32: 4 k-steps, the head dims permuted
//   alike in q and K as in relpos_attention_f32tc.cu).
// - The whole score row stays in registers (NP / 8 tiles), so the softmax
//   is exact in one pass, as JAX's: the bias, read from L2 (the (nh, N, N)
//   table is not separable into halves), is added after the scale; exp
//   as ex2 with log2 e folded into the FMA; p normalised in float32, then
//   split straight from the score registers into the A fragments of p . v
//   (the keys of a k-step permuted alike in p and V).
// - Every key below N is real (TinyViT's window-partition pad tokens are
//   LN(0) = the norm's bias and take part as keys, as in JAX); only the
//   tile padding past N is masked. The output goes out as float2 pairs
//   straight from the accumulators (each store fills 32-byte sectors).
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace dlimg {
namespace {

constexpr int kLfKd = 32;                // head width (TinyViT's key_dim)
constexpr int kLfWarps = 4;              // a 16-row stripe each
constexpr int kLfThreads = 32 * kLfWarps;
constexpr int kLfS = 2 * kLfKd + 4;      // row stride (floats) of the split K and V

struct LevitArgs32 {
  const float* qkv;   // (g, n, nh * 3 kd)
  const float* bias;  // (nh, n, n)
  float* out;         // (g, n, nh * kd)
  int n, nh;
  int parts;          // blocks of one (window, head) group
  float scale;
  int bias_pairs;     // bias rows may be read as 8-byte pairs (n even, base aligned)
};

// Elements c and c + 1 of a bias row, -inf past n (a masked key's score).
__device__ __forceinline__ float2 bias_pair(const float* row, int c, int n, bool pairs) {
  if (pairs && c < n) return __ldg(reinterpret_cast<const float2*>(row + c));
  return make_float2(c < n ? __ldg(row + c) : -INFINITY, c + 1 < n ? __ldg(row + c + 1) : -INFINITY);
}

// Two blocks an SM in the launch bounds (the 208-key instance's shared
// memory allows two).
template <int NP>
__global__ void __launch_bounds__(kLfThreads, 2) levit_window_kernel_f32tc(LevitArgs32 a) {
  static_assert(NP % 16 == 0 && (NP * kLfKd / 4) % kLfThreads == 0, "tiles of 16 keys");
  constexpr int NT = NP / 8;                       // 8-key tiles of a score row
  constexpr int DT = kLfKd / 8;                    // 8-column tiles of the output
  constexpr int CPR = kLfKd / 4;                   // 16-byte pieces of a row
  constexpr int VPT = NP * CPR / kLfThreads;       // V pieces a thread splits
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;              // NP x kLfS: split K
  float* vs = ks + NP * kLfS;    // NP x kLfS: split V; first raw K, then raw V
  float* rawk = vs;
  float* rawv = vs + NP * kLfKd;

  const int n = a.n, nh = a.nh;
  const int group = blockIdx.x / a.parts, part = blockIdx.x - group * a.parts;
  const int g = group / nh, h = group - g * nh;
  const size_t ts = static_cast<size_t>(nh) * 3 * kLfKd;  // qkv token stride
  const float* q = a.qkv + static_cast<size_t>(g) * n * ts + h * 3 * kLfKd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, gq = lane & 3;

  for (int e = tid; e < NP * CPR; e += kLfThreads) {
    const int r = e / CPR, c = (e - r * CPR) * 4;
    const bool ok = r < n;
    const float* src = q + (ok ? r : 0) * ts + c;
    cp_async16(rawk + r * kLfKd + c, src + kLfKd, ok);
    cp_async16(rawv + r * kLfKd + c, src + 2 * kLfKd, ok);
  }
  cp_async_commit();

  // This warp's stripe and this lane's rows r0, r1 (rows past n repeat row
  // n - 1; their results are never stored). q's hi / lo fragments: in
  // k-step 2p the slots (gq, gq + 4) hold dims 16p + 4gq + (0, 1), in 2p +
  // 1 dims + (2, 3).
  const int st = part * kLfWarps + warp;
  const int r0 = 16 * st + gr, r1 = r0 + 8;
  const bool active = 16 * st < n;
  uint32_t qh[4][4], ql[4][4];
  if (active) {
    const float* qa = q + min(r0, n - 1) * ts + 4 * gq;
    const float* qb = q + min(r1, n - 1) * ts + 4 * gq;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(qa + 16 * p));
      const float4 y = __ldg(reinterpret_cast<const float4*>(qb + 16 * p));
      split(x.x, qh[2 * p][0], ql[2 * p][0]);
      split(y.x, qh[2 * p][1], ql[2 * p][1]);
      split(x.y, qh[2 * p][2], ql[2 * p][2]);
      split(y.y, qh[2 * p][3], ql[2 * p][3]);
      split(x.z, qh[2 * p + 1][0], ql[2 * p + 1][0]);
      split(y.z, qh[2 * p + 1][1], ql[2 * p + 1][1]);
      split(x.w, qh[2 * p + 1][2], ql[2 * p + 1][2]);
      split(y.w, qh[2 * p + 1][3], ql[2 * p + 1][3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // K split into its region; V's raw pieces into registers, then, once no
  // thread reads the raw rows any more, split over them.
  for (int e = tid; e < NP * CPR; e += kLfThreads) {
    const int r = e / CPR, c = (e - r * CPR) * 4;
    const float4 x = *reinterpret_cast<const float4*>(rawk + r * kLfKd + c);
    uint4 hi, lo;
    split(x.x, hi.x, lo.x);
    split(x.y, hi.y, lo.y);
    split(x.z, hi.z, lo.z);
    split(x.w, hi.w, lo.w);
    uint4* d = reinterpret_cast<uint4*>(ks + r * kLfS + 2 * c);
    d[0] = hi;
    d[1] = lo;
  }
  float4 vr[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int e = tid + i * kLfThreads, r = e / CPR, c = (e - r * CPR) * 4;
    vr[i] = *reinterpret_cast<const float4*>(rawv + r * kLfKd + c);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int e = tid + i * kLfThreads, r = e / CPR, c = (e - r * CPR) * 4;
    uint4 hi, lo;
    split(vr[i].x, hi.x, lo.x);
    split(vr[i].y, hi.y, lo.y);
    split(vr[i].z, hi.z, lo.z);
    split(vr[i].w, hi.w, lo.w);
    uint4* d = reinterpret_cast<uint4*>(vs + r * kLfS + 2 * c);
    d[0] = make_uint4(hi.x, lo.x, hi.y, lo.y);
    d[1] = make_uint4(hi.z, lo.z, hi.w, lo.w);
  }
  __syncthreads();
  if (!active) return;  // no barrier follows

  // s = q . k; key 8j + gr is B column gr of tile j.
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint4* w = reinterpret_cast<const uint4*>(ks + (8 * j + gr) * kLfS + 32 * p + 8 * gq);
      const uint4 hi = w[0], lo = w[1];
      mma_3xtf32(s[j], qh[2 * p], ql[2 * p], hi.x, hi.y, lo.x, lo.y);
      mma_3xtf32(s[j], qh[2 * p + 1], ql[2 * p + 1], hi.z, hi.w, lo.z, lo.w);
    }

  // s[j][e] (row r0) and s[j][2 + e] (row r1) are key 8j + 2gq + e:
  // s = (q.k) scale + bias, rounded after each step as JAX does; keys past
  // n -inf (their bias); the row max.
  const float* b0 = a.bias + (static_cast<size_t>(h) * n + min(r0, n - 1)) * n;
  const float* b1 = a.bias + (static_cast<size_t>(h) * n + min(r1, n - 1)) * n;
  const bool pairs = a.bias_pairs != 0;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 w0 = bias_pair(b0, 8 * j + 2 * gq, n, pairs);
    const float2 w1 = bias_pair(b1, 8 * j + 2 * gq, n, pairs);
    s[j][0] = __fadd_rn(__fmul_rn(s[j][0], a.scale), w0.x);
    s[j][1] = __fadd_rn(__fmul_rn(s[j][1], a.scale), w0.y);
    s[j][2] = __fadd_rn(__fmul_rn(s[j][2], a.scale), w1.x);
    s[j][3] = __fadd_rn(__fmul_rn(s[j][3], a.scale), w1.y);
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
  const float c0 = -quad_max(m0) * kLog2e, c1 = -quad_max(m1) * kLog2e;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = ex2(fmaf(s[j][0], kLog2e, c0));
    s[j][1] = ex2(fmaf(s[j][1], kLog2e, c0));
    s[j][2] = ex2(fmaf(s[j][2], kLog2e, c1));
    s[j][3] = ex2(fmaf(s[j][3], kLog2e, c1));
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
  const float i0 = 1.f / quad_sum(l0), i1 = 1.f / quad_sum(l1);

  // o = p . v, p normalised; k slots (gq, gq + 4) of step j are keys 8j +
  // 2gq + (0, 1), the score columns this lane holds.
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ph[4], pl[4];
    split(s[j][0] * i0, ph[0], pl[0]);
    split(s[j][2] * i1, ph[1], pl[1]);
    split(s[j][1] * i0, ph[2], pl[2]);
    split(s[j][3] * i1, ph[3], pl[3]);
    const float* v0 = vs + (8 * j + 2 * gq) * kLfS + 2 * gr;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const uint2 x0 = *reinterpret_cast<const uint2*>(v0 + 16 * dt);
      const uint2 x1 = *reinterpret_cast<const uint2*>(v0 + kLfS + 16 * dt);
      mma_3xtf32(o[dt], ph, pl, x0.x, x1.x, x0.y, x1.y);
    }
  }

  const size_t os_row = static_cast<size_t>(nh) * kLfKd;  // out token stride
  float* out = a.out + static_cast<size_t>(g) * n * os_row + h * kLfKd;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = 8 * dt + 2 * gq;
    if (r0 < n)
      *reinterpret_cast<float2*>(out + r0 * os_row + col) = make_float2(o[dt][0], o[dt][1]);
    if (r1 < n)
      *reinterpret_cast<float2*>(out + r1 * os_row + col) = make_float2(o[dt][2], o[dt][3]);
  }
}

template <int NP>
cudaError_t launch_levit_f32tc(const LevitArgs32& a, int g, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(g) * a.nh * a.parts;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = &levit_window_kernel_f32tc<NP>;
  const size_t smem = sizeof(float) * 2 * NP * kLfS;  // 34, 111 and 136 KB
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), kLfThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// qkv: (g, n, nh * 96), bias: (nh, n, n), out: (g, n, nh * 32), float32,
// contiguous, qkv and out 16-byte aligned; 1 <= n <= 256.
cudaError_t levit_attention_f32tc(const void* qkv, const void* bias, void* out, int g, int n,
                                  int nh, float scale, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorMisalignedAddress;
  const int stripes = (n + 15) / 16;
  const LevitArgs32 a{static_cast<const float*>(qkv), static_cast<const float*>(bias),
                      static_cast<float*>(out), n, nh, (stripes + kLfWarps - 1) / kLfWarps,
                      scale, n % 2 == 0 && reinterpret_cast<uintptr_t>(bias) % 8 == 0};
  if (n <= 64) return launch_levit_f32tc<64>(a, g, stream);    // N = 49: 4 stripes
  if (n <= 208) return launch_levit_f32tc<208>(a, g, stream);  // N = 196: 13 stripes
  if (n <= 256) return launch_levit_f32tc<256>(a, g, stream);
  return cudaErrorInvalidValue;
}

}  // namespace dlimg
