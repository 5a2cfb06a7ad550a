// K2 in bfloat16 on Hopper's tensor cores: TinyViT's (LeViT) window
// attention with a static per-head bias, exact softmax.
//
// Replaces the TPU kernel dlimgedit_tpu/ops/flash_attention.py:531
// `levit_window_attention` (Pallas body `_levit_kernel`, :500). The function
// and its rounding are JAX's (levit_attention.cu, whose CUDA-core body keeps
// the float32 route, gives the arithmetic): for window g and head h, kd = 32,
//   s = (q . k) * kd^-1/2 + bias[h]   float32, the bias added after the scale
//   p = softmax(s), exact, normalised in float32, then rounded to bf16
//   out = p . v                       float32 accumulation
// with q, k, v = the head's three kd-column slices of the qkv linear's
// output row, out the head's kd columns of an nh * kd row.
//
// What bounds it on an H100: bytes. Per (window, head) it reads 3 N kd and
// writes N kd values for 4 N^2 kd operations, N / 2 operations a byte (25
// at N = 49, 98 at N = 196), below the ~295 where the tensor cores would
// become the limit. The least time is (qkv + bias + out bytes) / 3.35 TB/s:
// 5.4, 2.0 and 3.8 us at MobileSAM's three shapes (G, N, nh 96) = (361, 49,
// 384), (25, 196, 480), (100, 49, 960).
//
// What held the CUDA-core body back (levit_attention.cu): K and V staged
// with 2-byte loads, q . k as 32 shuffles and scalar FMAs a row, and p . v
// broadcasting each of N probabilities with a shuffle. The design here
// (K5's mma.sync body in relpos_attention_tc.cu, at head width 32):
// - One block of 4 warps per (window, head, up to 64 query rows); a warp
//   owns one 16-row stripe. N = 49 is one block of 4 stripes per group
//   (1444 and 1000 blocks at the two N = 49 shapes); N = 196 has 13
//   stripes, split over 4 blocks (500 blocks, where one block a group
//   would give 125 for 132 SMs), each staging the group's K and V again
//   (12 KB each, from L2).
// - K and V are read in place from the qkv output (token stride nh 96, k at
//   h 96 + 32, v at + 64) by 16-byte cp.async into shared rows of kd + 8
//   elements, so the 8 rows an ldmatrix reads fall on distinct banks;
//   rows past N are zero up to NP (64, 208 or 256 keys). Nothing is
//   transposed or copied.
// - While they land, each lane loads its q fragments (4-byte loads from
//   device memory, as K5) and the bias of its two rows at its score
//   columns: bf16 pairs when N is even, single elements when N is odd (rows
//   then start at odd offsets and a pair load would be misaligned). The
//   bias is not separable into row and column halves, so K5's one-hot
//   depth steps do not apply; the table (4.8 KB a head at N = 49, 77 KB at
//   N = 196) stays in L2.
// - q . k: two depth steps of mma.sync m16n8k16 per 8-key tile, B
//   fragments by ldmatrix; the whole score row stays in registers (NP / 8
//   tiles), so the softmax is exact in one pass: exp as ex2 with log2 e
//   folded into the FMA (ex2.approx; the bf16 tolerance covers its last ulp
//   against expf). p is normalised in float32, rounded to bf16 straight
//   into the A fragments of p . v (4 output tiles of 8 columns, V by
//   ldmatrix.trans).
// - Every key below N is real: TinyViT's window-partition pad tokens are
//   LN(0) = the norm's bias and take part as keys, as in JAX. Only the tile
//   padding past N is masked.
// - The stripe's 16 x 32 output tile goes out through shared memory in
//   16-byte chunks: each row is a 64-byte slice of an nh * 32 row.
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace dlimg {
namespace {

constexpr int kLvKd = 32;                  // head width (TinyViT's key_dim)
constexpr int kLvWarps = 4;                // a 16-row stripe each
constexpr int kLvThreads = 32 * kLvWarps;
constexpr int kLvRows = 16 * kLvWarps;     // query rows a block
constexpr int kLvKS = kLvKd + 8;           // shared row stride (elements)

struct LevitArgs {
  const bf16* qkv;   // (g, n, nh * 3 kd)
  const bf16* bias;  // (nh, n, n)
  bf16* out;         // (g, n, nh * kd)
  int n, nh;
  int parts;         // blocks of one (window, head) group
  float scale;
  int bias_pairs;    // bias rows may be read as 4-byte pairs (n even, base aligned)
};

__device__ __forceinline__ uint32_t ldg_u16(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

// Elements c and c + 1 of a bias row as a bf16 pair (c in the low half),
// zero past n.
__device__ __forceinline__ uint32_t bias_pair(const bf16* row, int c, int n, bool pairs) {
  if (pairs) return c < n ? ldg_u32(row + c) : 0u;  // c even: c < n gives c + 1 < n
  const uint32_t lo = c < n ? ldg_u16(row + c) : 0u;
  const uint32_t hi = c + 1 < n ? ldg_u16(row + c + 1) : 0u;
  return lo | (hi << 16);
}

// Two blocks an SM in the launch bounds: the instances then take 75, 163
// and 193 registers and spill nothing. With no block count ptxas held the
// 64-key instance to 63 registers, and with 3 the 208-key one to 168;
// both spilled.
template <int NP>
__global__ void __launch_bounds__(kLvThreads, 2) levit_window_kernel_tc(LevitArgs a) {
  static_assert(NP % 16 == 0, "tiles of 16 keys");
  constexpr int NT = NP / 8;       // 8-key tiles of a score row
  constexpr int DT = kLvKd / 8;    // 8-column tiles of the output
  constexpr int CPR = kLvKd / 8;   // 16-byte chunks of a row
  __shared__ __align__(16) bf16 ks[NP * kLvKS];
  __shared__ __align__(16) bf16 vs[NP * kLvKS];
  __shared__ __align__(16) bf16 os[kLvRows * kLvKS];  // output tiles, 16 rows a warp

  const int n = a.n, nh = a.nh;
  const int group = blockIdx.x / a.parts, part = blockIdx.x - group * a.parts;
  const int g = group / nh, h = group - g * nh;
  const size_t ts = static_cast<size_t>(nh) * 3 * kLvKd;  // qkv token stride
  const bf16* q = a.qkv + static_cast<size_t>(g) * n * ts + h * 3 * kLvKd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, gq = lane & 3;

  for (int e = tid; e < NP * CPR; e += kLvThreads) {
    const int r = e / CPR, c = (e - r * CPR) * 8;
    const bool ok = r < n;
    const bf16* src = q + (ok ? r : 0) * ts + c;
    cp_async16(ks + r * kLvKS + c, src + kLvKd, ok);
    cp_async16(vs + r * kLvKS + c, src + 2 * kLvKd, ok);
  }
  cp_async_commit();

  // This warp's stripe and this lane's rows r0, r1 (rows past n repeat row
  // n - 1; their results are never stored). The q fragments and the rows'
  // bias come from device memory while K and V land.
  const int st = part * kLvWarps + warp;
  const int r0 = 16 * st + gr, r1 = r0 + 8;
  const bool active = 16 * st < n;
  uint32_t qa[2][4], bb[NT][2];
  if (active) {
    const bf16* q0 = q + min(r0, n - 1) * ts + 2 * gq;
    const bf16* q1 = q + min(r1, n - 1) * ts + 2 * gq;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      qa[kk][0] = ldg_u32(q0 + 16 * kk);
      qa[kk][1] = ldg_u32(q1 + 16 * kk);
      qa[kk][2] = ldg_u32(q0 + 16 * kk + 8);
      qa[kk][3] = ldg_u32(q1 + 16 * kk + 8);
    }
    const bf16* b0 = a.bias + (static_cast<size_t>(h) * n + min(r0, n - 1)) * n;
    const bf16* b1 = a.bias + (static_cast<size_t>(h) * n + min(r1, n - 1)) * n;
    const bool pairs = a.bias_pairs != 0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      bb[j][0] = bias_pair(b0, 8 * j + 2 * gq, n, pairs);
      bb[j][1] = bias_pair(b1, 8 * j + 2 * gq, n, pairs);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;  // no barrier follows

  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, ks + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * kLvKS + 16 * kk +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * jp], qa[kk], b[0], b[1]);
      mma_bf16(s[2 * jp + 1], qa[kk], b[2], b[3]);
    }

  // s = (q.k) scale + bias, rounded after each step as JAX does; keys past
  // n masked; row max.
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (8 * j + 2 * gq + e < n) {
        s[j][e] = __fadd_rn(__fmul_rn(s[j][e], a.scale),
                            e ? bf_hi(bb[j][0]) : bf_lo(bb[j][0]));
        s[j][2 + e] = __fadd_rn(__fmul_rn(s[j][2 + e], a.scale),
                                e ? bf_hi(bb[j][1]) : bf_lo(bb[j][1]));
      } else {
        s[j][e] = -INFINITY;
        s[j][2 + e] = -INFINITY;
      }
      m0 = fmaxf(m0, s[j][e]);
      m1 = fmaxf(m1, s[j][2 + e]);
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

  // p rounded to bf16, straight into the A fragments of p . v.
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NP / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0] * i0, s[2 * kk][1] * i0),
                            pack_bf16(s[2 * kk][2] * i1, s[2 * kk][3] * i1),
                            pack_bf16(s[2 * kk + 1][0] * i0, s[2 * kk + 1][1] * i0),
                            pack_bf16(s[2 * kk + 1][2] * i1, s[2 * kk + 1][3] * i1)};
#pragma unroll
    for (int dp = 0; dp < DT / 2; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLvKS +
                           16 * dp + (lane >> 4) * 8);
      mma_bf16(o[2 * dp], pa, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
    }
  }

  // The 16 x 32 tile through this warp's rows of `os`, then 16-byte chunks.
  bf16* stage = os + warp * 16 * kLvKS;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = 8 * dt + 2 * gq;
    st_u32(stage + gr * kLvKS + c, pack_bf16(o[dt][0], o[dt][1]));
    st_u32(stage + (gr + 8) * kLvKS + c, pack_bf16(o[dt][2], o[dt][3]));
  }
  __syncwarp();
  const size_t os_row = static_cast<size_t>(nh) * kLvKd;  // out token stride
  bf16* out = a.out + static_cast<size_t>(g) * n * os_row + h * kLvKd;
#pragma unroll
  for (int e = lane; e < 16 * CPR; e += 32) {
    const int rr = e / CPR, c = (e - rr * CPR) * 8, r = 16 * st + rr;
    if (r < n)
      *reinterpret_cast<uint4*>(out + r * os_row + c) =
          *reinterpret_cast<const uint4*>(stage + rr * kLvKS + c);
  }
}

// Static shared memory: K, V (NP rows each) and the output tiles, 15 KB at
// NP = 64, 38 KB at 208, 46 KB at 256.
template <int NP>
cudaError_t launch_levit_tc(const LevitArgs& a, int g, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(g) * a.nh * a.parts;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  levit_window_kernel_tc<NP><<<static_cast<unsigned>(blocks), kLvThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// qkv: (g, n, nh * 96), bias: (nh, n, n), out: (g, n, nh * 32), bf16,
// contiguous, qkv and out 16-byte aligned; 1 <= n <= 256.
cudaError_t levit_attention_tc(const void* qkv, const void* bias, void* out, int g, int n,
                               int nh, float scale, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorMisalignedAddress;
  const int stripes = (n + 15) / 16;
  const LevitArgs a{static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
                    static_cast<bf16*>(out), n, nh, (stripes + kLvWarps - 1) / kLvWarps,
                    scale, n % 2 == 0 && reinterpret_cast<uintptr_t>(bias) % 4 == 0};
  if (n <= 64) return launch_levit_tc<64>(a, g, stream);  // N = 49: 4 stripes
  if (n <= 208) return launch_levit_tc<208>(a, g, stream);  // N = 196: 13 stripes
  if (n <= 256) return launch_levit_tc<256>(a, g, stream);
  return cudaErrorInvalidValue;
}

}  // namespace dlimg
