// The bodies of the float32 tensor-core kernels K4, K5, K6 and K7: the
// design is the note below. relpos_attention_f32tc.cu instantiates them
// at hd 64 and 80, relpos_attention_f32tc_pad.cu at the padded widths.
//
// K4, K5, K6 and K7 in float32 on Hopper's tensor cores: attention with
// the MViTv2 decomposed relative-position bias of the SAM ViT encoders,
// every product in three TF32 passes.
//
// K4 (`relpos_global_f32tc`, kernel `relpos_global_kernel_f32tc`) replaces
// the TPU kernel dlimgedit_tpu/ops/flash_attention.py:139
// `_attention_grouped`: the global blocks, one group per head over the
// whole token grid (ViT-B at 1024: 12 groups of N = 4096, hd 64; ViT-H 16
// of hd 80). K5 (`relpos_windowed_f32tc`, kernel
// `relpos_window_kernel_f32tc`) replaces :307 `_attention_head_fused`: the
// windowed blocks (25 windows x heads of N = 196), folded or plain bias,
// the pad-query skip of the bottom window row. K6 (`window_strip_f32tc`,
// kernel `window_strip_kernel_f32tc`, C entry point in
// window_strip_attention.cu) replaces :646 `windowed_attention_fused`
// (body `_window_strip_kernel`, :575): K5's windows read in place from the
// padded NHWC q, k, v, the bias halves computed in the block. K7
// (`relpos_qkv_f32tc`, kernel `relpos_qkv_kernel_f32tc`) replaces :382
// `windowed_attention_qkv` (body `_head_loop_kernel_qkv`, :285): K5's
// windows with q, k and v read in place as the components of one (W, 3,
// nh, N, hd) tensor, the plain bias, every row kept. The TPU kernels
// request `Precision.HIGHEST` for float32 operands (:148, :295, :327,
// :606): float32-accurate products from several bf16 passes on the matrix
// unit. The arithmetic is that of relpos_attention.cu's and
// window_strip_attention.cu's notes (bf16 K4, K5, K6, K7 run in
// relpos_attention_tc.cu):
//   s[i, j] = (q_i . k_j) * scale + (bh[i, y_j] + bw[i, x_j])     plain
//   s[i, j] = (q_i . k_j + (bh[i, y_j] + bw[i, x_j])) * scale     folded
//   s[i, j] = ((q_i . k_j) * scale + bh[i, y_j]) + bw[i, x_j]     K6
//   out[g, i] = softmax_j(s) . v, float32 throughout
// and rows >= n_valid of groups >= g_skip written as zeros.
//
// Three TF32 passes. A TF32 operand keeps 10 of float32's 23 mantissa
// bits, so one pass (what `allow_tf32` gives) rounds each product by ~1e-3
// relative: q . k over 64 terms of large range is off by ~1e-2 and the
// output by ~1e-3, far outside the 2e-5 the float32 bodies are held to.
// Each operand x is split as hi = TF32(x) and lo = TF32(x - hi) (both
// `cvt.rna.tf32.f32`; x - hi is exact in float32), and a product is
// lo.hi + hi.lo + hi.hi, accumulated in float32 in that order (the small
// terms first) on `mma.sync.m16n8k8.f32.tf32.tf32.f32`, the instruction
// PyTorch's own float32 attention uses (CUTLASS's OpMultiplyAddFastF32).
// The dropped lo.lo term and the rounding of lo leave ~2^-21 of each
// product, float32's own order. The CPU test tests/test_torch_tf32x3.py
// emulates this arithmetic against the plain version. The tensor cores'
// float32 accumulation does not round to nearest (it truncates, as the card
// showed): each mma may drop up to an ulp of its accumulator. Over a row of N = 4096 keys a running p . v takes 1536 such
// steps, and with o kept in the mma accumulators across chunks K4 was off
// by up to 5.8e-5 on the card; so K4's p . v of each chunk (3 NT steps)
// starts from zero and joins o in one rounded FMA on the CUDA cores, as
// q . k starts from zero in every chunk. K5's rows of at most 256 keys
// (at most 105 steps) held 2e-5 with o in the mma accumulators, which
// leaves the registers that its hd-80 instance needs not to spill.
//
// One pass of softmax. The JAX kernels normalise p before they round it to
// the activation dtype. In float32 that rounding is the identity, so the
// online softmax (FlashAttention's: a running max m and sum l per row, the
// output rescaled by exp(m_old - m_new) and divided by l once at the end)
// is the same function up to the order of float32 roundings (~1e-7), and
// q . k is computed once. exp(x) is ex2(x log2 e - m log2 e), the row
// constant m log2 e one rounded value used for every term and every
// rescale of the row, so it cancels in the division by l.
//
// What bounds it on an H100: operations. K4 does 4 G N^2 hd products
// (51.5 GFLOP at ViT-B 1024; 85.9 at ViT-H), 0.31 / 0.52 ms at a third of
// the 495 TFLOP/s TF32 peak, against ~75 / ~117 MB of float32 q, k, v,
// bias halves and output (22 / 35 us at 3.35 TB/s). K5 at N = 196 is near
// the ridge: 2.7 GFLOP a ViT-B launch (with the skip; 16 us) against ~65 MB
// (19 us). K6 at ViT-B (300 windows x heads, no skip) does 3.2 GFLOP
// (19 us) against 60 MB of its float32 qkv and output (18 us). K7 at ViT-B's
// windows (no skip) does 3.0 GFLOP (18 us) against 67 MB (20 us).
// chip_smoke.py's float32 bound is that rule for every float32 body. The instruction itself, mma.sync m16n8k8 TF32, peaks at ~310 TFLOP/s
// on this card (tools/time_f32_attention.py --mma-rate), ~103 TFLOP/s of
// float32 products in three passes: wgmma is the way to the rest.
//
// Design. A block of WARPS warps owns 16 WARPS query rows of one group, a
// warp a 16-row stripe (its rows gr and gr + 8 of the mma fragments, gr =
// lane / 4). q of the stripe is read once from device memory and split
// into hi and lo A fragments held in registers. Keys stream in chunks of
// 8 NT: K and V arrive raw by 16-byte cp.async in a ring of two stages in
// dynamic shared memory; the whole block then splits the chunk once into
// hi / lo buffers (two, alternating) that every warp reads its B fragments
// from, so no warp splits K or V itself. One barrier a chunk: in step c the
// block loads chunk c + 2, splits chunk c + 1 (landed during step c - 1)
// and computes chunk c. K4: 8 warps (128 rows), 32-key chunks; when a grid
// row is 64 keys (gw == 64, every ViT grid at 1024) bh is one value a row
// and chunk and bw is read in float pairs, else each key's (y, x) is
// computed from its index. K5: 7 warps (112 rows: N = 196 is two blocks,
// 13 of their 14 stripes hold rows; the skipped groups' second block only
// writes zeros), 40-key chunks (5 of them cover 196 keys, 4 masked);
// windows of more than 256 keys take K4's body. K7 is K5's block (K4's
// above 256 keys, on the general grid path) with its group's q, k, v
// found in the qkv tensor. K6 is K5's block on a
// window's tokens (`WindowRows32`: row r at ((r / ws) wp + r % ws) ts
// floats from the window's first token), every row kept, its bias halves
// computed by a prologue while chunk 0 lands (`compute_bias`: 4 lanes a
// row half on the CUDA cores; with 16 lanes a row and 15-shuffle chains
// it took 0.15-0.22 ms of a 0.29-0.36 ms ViT-B launch, with 4 lanes 0.06
// of 0.21: tools/time_f32_attention.py `k6_no_bias`). K4's chunk products
// accumulate from zero (see above) in registers beside o, K5's and K6's
// in o.
// - q . k: the head dims are permuted alike in q and K (a dot product does
//   not care in which order its terms are summed): in k-steps 2p and 2p + 1
//   the lane's k slots (lane % 4, lane % 4 + 4) hold dims 16p + 4 (lane % 4)
//   + (0, 1) and (2, 3). The split K keeps each key's dims in groups of 4,
//   [hi x 4 | lo x 4], so two 16-byte loads give the B fragments of two
//   k-steps; rows are 2 HD + 4 floats apart (4 mod 32 words), so the 8 lanes
//   of a 16-byte load phase fall on 32 banks.
// - p . v: the score accumulator's columns (2 (lane % 4), + 1) are taken as
//   the k slots (lane % 4, lane % 4 + 4) of the p fragment, i.e. the keys of
//   a k-step are permuted alike in p and V, so p goes from the score
//   registers straight into the A fragments, no shuffle and no shared
//   memory. The split V keeps (hi, lo) of an element side by side (one
//   8-byte load), rows 2 HD + 4 floats apart, so a lane's two key rows fall
//   on distinct banks.
// - The bias halves of the block's rows are staged once in shared memory
//   (rows 8 mod 32 words apart: the float pairs of a half warp fall on 32
//   banks; read from device memory when a grid's halves leave no room) and
//   added by index.
// Later work (ROADMAP): wgmma, whose TF32 form wants both operands K-major
// in shared memory (V transposed there), and TMA loads from a producer
// warp.
//
// Head widths. hd 64 and 80 (ViT-B/L and ViT-H) have instances of their
// own (relpos_attention_f32tc.cu). Every other multiple of 8 from 8 to 128
// runs an instance at a padded width, 32, 96 or 128 (`PAD`, compiled apart
// in relpos_attention_f32tc_pad.cu so that the two build in parallel): the
// rows hold hd dims, their columns past hd load as zeros (cp.async's zero
// fill, zero q pieces, zero table pieces in K6's prologue), whose TF32
// split is zero and whose products add nothing, and the output columns past
// hd are not stored; the scale is the true hd^-1/2 (the wrapper's). Above
// hd 80 a stripe reads its q pieces again (from L1) and splits them in each
// chunk (hi and lo of 96 or 128 dims held beside the output tiles spilled),
// K4's chunk products join o 4 output tiles at a time, and the window blocks
// take 32-key chunks at hd 128 (40-key chunks of 128 dims do not fit in
// shared memory). These instances are right first; their speed is later
// work.
#pragma once

#include <math.h>
#include <stdint.h>

#include "relpos_attention.cuh"
#include "tensor_core.cuh"

namespace dlimg {
namespace {

// Row stride (floats) of the staged bias halves: at least ghw, 8 mod 32.
__host__ __device__ inline int f32_bias_stride(int ghw) { return (ghw + 23) / 32 * 32 + 8; }

template <int HD, int NT, int WARPS>
struct F32Layout {
  static constexpr int BQ = 16 * WARPS;  // query rows a block
  static constexpr int BK = 8 * NT;      // keys a chunk
  static constexpr int SK = 2 * HD + 4;  // row strides (floats) of the split K
  static constexpr int SV = 2 * HD + 4;  // and V
  static constexpr int RAW = 2 * BK * HD;  // floats: a raw K and V chunk
  static constexpr int SPLIT = BK * (SK + SV);  // floats: a split K and V chunk
  static size_t chunk_bytes() { return sizeof(float) * 2 * (RAW + SPLIT); }
  static size_t bias_bytes(int ghw) {
    return sizeof(float) * static_cast<size_t>(BQ) * f32_bias_stride(ghw);
  }
};

// Where a block's rows lie. K4 / K5 / K7 (`DenseRows32`): q, k, v and out
// rows r at r * HD from the group's first row; the caller's bias halves, n
// x (gh + gw), from the block's first row.
template <int HD, bool PAD>
struct DenseRows32 : HeadWidth<HD, PAD> {
  static constexpr bool kStrip = false;
  const float* q;
  const float* k;
  const float* v;
  float* out;
  const float* bhw;

  __device__ __forceinline__ size_t in(int r) const {
    return static_cast<size_t>(r) * this->width();
  }
  __device__ __forceinline__ size_t out_off(int r) const { return in(r); }
};

// c[0 .. 15] summed over the 4 lanes of a quad: lane q of the quad ends
// with the sums of columns 4q .. 4q + 3 in c[0 .. 3] (12 shuffles; each
// step keeps half the columns and adds the partner lane's copy of them).
__device__ __forceinline__ void quad_sum_scatter(float (&c)[16], int q) {
  const bool up2 = q & 2, up1 = q & 1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float send = up2 ? c[j] : c[j + 8];
    c[j] = (up2 ? c[j + 8] : c[j]) + __shfl_xor_sync(kFullMask, send, 2);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float send = up1 ? c[j] : c[j + 4];
    c[j] = (up1 ? c[j + 4] : c[j]) + __shfl_xor_sync(kFullMask, send, 1);
  }
}

// K6 (`WindowRows32`): the ws x ws tokens of one window of a padded (B,
// hp, wp, *) grid, read in place. Token t of the window is t / ws rows and
// t % ws columns from its first token; q, k, v rows are `ts` floats apart
// (3C for the channel slices of the qkv output), out rows `c`. Each pointer
// is at the window's first token and the head's first channel. The bias
// halves are computed in the block (`compute_bias`) from (ws, ws, hd)
// tables.
template <int HD, bool PAD>
struct WindowRows32 : HeadWidth<HD, PAD> {
  static constexpr bool kStrip = true;
  const float* q;
  const float* k;
  const float* v;
  float* out;
  const float* rh;  // gathered (ws, ws, HD) tables
  const float* rw;
  int ws, wp, ts, c;

  __device__ __forceinline__ size_t tok(int t) const {
    const int y = t / ws;
    return static_cast<size_t>(y) * wp + (t - y * ws);
  }
  __device__ __forceinline__ size_t in(int r) const { return tok(r) * ts; }
  __device__ __forceinline__ size_t out_off(int r) const { return tok(r) * c; }

  // bh[i, y] = q_i . rh[y_i, y] and bw[i, x] = q_i . rw[x_i, x] of the
  // block's rows q0 .. q0 + rows - 1, float32 on the CUDA cores, into
  // [bh (ws) | bw (ws)] rows of `bs`. A task is one half of one row, on the
  // 4 lanes of a quad: lane q holds q's dims 4 (q + 4j) .. + 3 (16-byte
  // pieces; a quad reads 64 contiguous bytes at a time) and forms its part
  // of the ws dot products, ws independent chains of HD / 4 FMAs; then
  // `quad_sum_scatter` leaves 4 columns' sums in each lane. The bh tasks go
  // in row order and the bw tasks in column order over the window
  // positions that cover the block, so that the 8 quads of a warp mostly
  // read one table row at a time (rh[y] or rw[x]). Every quad runs the same
  // number of tasks, so the shuffles stay whole; a task outside the block's
  // rows repeats its first row and stores nothing.
  __device__ __forceinline__ void compute_bias(float* bs, int bstr, int q0, int rows, int tid,
                                               int nthreads) const {
    constexpr int PL = HD / 16;  // 16-byte pieces a lane
    const int hd = this->width();
    const int qd = tid & 3, grp = tid >> 2, groups = nthreads >> 2;
    const int y0 = q0 / ws, ny = (q0 + rows - 1) / ws - y0 + 1;  // window rows touched
    const int tasks = ny * ws, padded = (tasks + groups - 1) / groups * groups;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const float* table = half ? rw : rh;
      for (int t = grp; t < padded; t += groups) {
        const int y = y0 + (half ? t % ny : t / ws), x = half ? t / ny : t % ws;
        const int r = y * ws + x - q0;
        const bool ok = t < tasks && r >= 0 && r < rows;
        const int i = q0 + (ok ? r : 0);
        const float4* qr = reinterpret_cast<const float4*>(q + in(i)) + qd;
        float4 qv[PL];
#pragma unroll
        for (int j = 0; j < PL; ++j) {
          if constexpr (PAD)
            qv[j] = 4 * (qd + 4 * j) < hd ? __ldg(qr + 4 * j) : make_float4(0.f, 0.f, 0.f, 0.f);
          else
            qv[j] = __ldg(qr + 4 * j);
        }
        const int yi = i / ws;
        const float* tb = table + static_cast<size_t>(half ? i - yi * ws : yi) * ws * hd;
        float cs[16];
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          cs[c] = 0.f;
          if (c < ws) {
            const float4* tr = reinterpret_cast<const float4*>(tb + c * hd) + qd;
#pragma unroll
            for (int j = 0; j < PL; ++j) {
              float4 a;
              if constexpr (PAD)
                a = 4 * (qd + 4 * j) < hd ? __ldg(tr + 4 * j) : make_float4(0.f, 0.f, 0.f, 0.f);
              else
                a = __ldg(tr + 4 * j);
              const float4 u = qv[j];
              cs[c] = fmaf(u.w, a.w, fmaf(u.z, a.z, fmaf(u.y, a.y, fmaf(u.x, a.x, cs[c]))));
            }
          }
        }
        quad_sum_scatter(cs, qd);
        if (ok) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * qd + e < ws) bs[r * bstr + half * ws + 4 * qd + e] = cs[e];
        }
      }
    }
  }
};

// The body of K4, K5 and K6 for the block of query rows q0 .. q0 + BQ - 1
// of one group of n keys on a gh x gw grid (`Rows` says where its rows
// lie and where its bias halves come from); rows below nq are computed,
// the rest written as zeros. OG: output tiles whose p . v products of a
// chunk accumulate from zero together (fewer, so fewer registers, at the
// cost of splitting p again for each group); OG = 0: p . v accumulates in
// o's mma registers (rows of at most 256 keys). GRID_ROW: a grid row is 64
// keys. bias_smem: the bias halves staged in shared memory (else read in
// place; K6 always stages the halves it computes).
template <int HD, int NT, int WARPS, int OG, bool GRID_ROW, class Rows>
__device__ __forceinline__ void f32tc_body(const Rows& g, const int n, const int gh,
                                           const int gw, const int nq, const int q0,
                                           const float scale, const bool folded,
                                           const bool bias_smem) {
  static_assert(HD % 16 == 0 && (HD / 8) % (OG == 0 ? 1 : OG) == 0, "head width");
  constexpr bool PAD = Rows::kPad;
  constexpr bool QLOAD = HD > 80;  // q read and split again in each chunk
  using L = F32Layout<HD, NT, WARPS>;
  constexpr int THREADS = 32 * WARPS;
  constexpr int BQ = L::BQ, BK = L::BK, SK = L::SK, SV = L::SV;
  constexpr int PAIRS = HD / 16;  // pairs of k-steps of q . k
  constexpr int DT = HD / 8;      // 8-column tiles of the output
  constexpr int CPR = HD / 4;     // 16-byte pieces of a row
  extern __shared__ __align__(16) float smem[];
  const int ghw = gh + gw;
  const int bstr = f32_bias_stride(ghw);
  float* raw = smem;                    // 2 x (K chunk, V chunk), rows of HD
  float* spl = raw + 2 * L::RAW;        // 2 x (K chunk, V chunk) split
  float* bs = spl + 2 * L::SPLIT;       // BQ rows of bias halves

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, gq = lane & 3;
  const int rows = min(BQ, n - q0);  // the block's rows below n
  const int hd = g.width();

  if (q0 >= nq) {  // a block of skipped pad queries: zeros, nothing else
    for (int e = tid; e < rows * CPR; e += THREADS) {
      const int r = e / CPR, col = (e - r * CPR) * 4;
      if (PAD && col >= hd) continue;
      *reinterpret_cast<float4*>(g.out + g.out_off(q0 + r) + col) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  const int n_chunks = (n + BK - 1) / BK;
  // Raw chunk c into stage c % 2: K rows, then V rows.
  auto load_chunk = [&](int c) {
    if (c < n_chunks) {
      float* rk = raw + (c & 1) * L::RAW;
      for (int e = tid; e < BK * CPR; e += THREADS) {
        const int r = e / CPR, col = (e - r * CPR) * 4;
        const int key = c * BK + r;
        const bool ok = key < n && (!PAD || col < hd);
        const size_t off = PAD ? (ok ? g.in(key) + col : 0) : g.in(ok ? key : 0) + col;
        cp_async16(rk + r * HD + col, g.k + off, ok);
        cp_async16(rk + (BK + r) * HD + col, g.v + off, ok);
      }
    }
    cp_async_commit();
  };
  // Raw chunk c split into buffer c % 2: K as [hi x 4 | lo x 4] per group of
  // 4 dims, V as (hi, lo) pairs.
  auto split_chunk = [&](int c) {
    const float* rk = raw + (c & 1) * L::RAW;
    float* sk = spl + (c & 1) * L::SPLIT;
    for (int e = tid; e < 2 * BK * CPR; e += THREADS) {
      const int r = e / CPR, col = (e - r * CPR) * 4;  // rows BK.. are V's
      const float4 x = *reinterpret_cast<const float4*>(rk + r * HD + col);
      uint4 h, lo;
      split(x.x, h.x, lo.x);
      split(x.y, h.y, lo.y);
      split(x.z, h.z, lo.z);
      split(x.w, h.w, lo.w);
      if (r < BK) {
        uint4* d = reinterpret_cast<uint4*>(sk + r * SK + 2 * col);
        d[0] = h;
        d[1] = lo;
      } else {
        uint4* d = reinterpret_cast<uint4*>(sk + BK * SK + (r - BK) * SV + 2 * col);
        d[0] = make_uint4(h.x, lo.x, h.y, lo.y);
        d[1] = make_uint4(h.z, lo.z, h.w, lo.w);
      }
    }
  };

  // The first load group: the block's bias halves (K4, K5), then chunk 0;
  // K6 computes its halves while chunk 0 lands.
  const float* brows = bs;
  int bld = bstr;
  if constexpr (Rows::kStrip) {
    load_chunk(0);
    g.compute_bias(bs, bstr, q0, rows, tid, THREADS);
  } else {
    if (bias_smem) {
      if (ghw % 4 == 0 && reinterpret_cast<uintptr_t>(g.bhw) % 16 == 0) {
        const int cpr = ghw / 4;
        for (int e = tid; e < rows * cpr; e += THREADS) {
          const int r = e / cpr, c = (e - r * cpr) * 4;
          cp_async16(bs + r * bstr + c, g.bhw + static_cast<size_t>(r) * ghw + c, true);
        }
      } else {
        for (int e = tid; e < rows * ghw; e += THREADS) {
          const int r = e / ghw;
          bs[r * bstr + e - r * ghw] = g.bhw[e];
        }
      }
    } else {
      brows = g.bhw;
      bld = ghw;
    }
    load_chunk(0);
  }
  cp_async_wait<0>();
  __syncthreads();
  split_chunk(0);
  load_chunk(1);

  // This warp's stripe; rows past n repeat row n - 1 (never stored).
  const int lr0 = warp * 16 + gr, lr1 = lr0 + 8;  // rows in the block
  const bool active = q0 + warp * 16 < nq;        // the stripe holds a kept row
  const float* b0r = brows + min(lr0, rows - 1) * bld;
  const float* b1r = brows + min(lr1, rows - 1) * bld;
  // q's A fragments split as hi / lo, held in registers; with QLOAD its
  // rows' pieces are read again (from L1) and split in each chunk, which
  // leaves the registers of hi and lo to the output tiles.
  uint32_t qh[QLOAD ? 1 : 2 * PAIRS][4], ql[QLOAD ? 1 : 2 * PAIRS][4];
  const float* qa = g.q + g.in(min(q0 + lr0, n - 1)) + 4 * gq;
  const float* qb = g.q + g.in(min(q0 + lr1, n - 1)) + 4 * gq;
  if constexpr (!QLOAD) {
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const bool in_hd = !PAD || 16 * p + 4 * gq < hd;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 x = in_hd ? __ldg(reinterpret_cast<const float4*>(qa + 16 * p)) : zero;
      const float4 y = in_hd ? __ldg(reinterpret_cast<const float4*>(qb + 16 * p)) : zero;
      // k-step 2p: slots (gq, gq + 4) = dims 16p + 4gq + (0, 1); 2p + 1: + (2, 3).
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

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float cl[2] = {-INFINITY, -INFINITY};  // running row max times log2 e
  float l[2] = {0.f, 0.f};               // this lane's part of the row sums
  [[maybe_unused]] const float inv_gw = 1.f / static_cast<float>(gw);  // general grids

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<0>();  // raw chunk c + 1, loaded during step c - 1
    __syncthreads();     // split chunk c and raw c + 1 visible; every warp is done with c - 1
    load_chunk(c + 2);
    if (c + 1 < n_chunks) split_chunk(c + 1);
    if (!active) continue;
    const float* sk = spl + (c & 1) * L::SPLIT;
    const float* sv = sk + BK * SK;

    // s = q . k of this stripe and chunk; key 8j + gr is B column gr of tile j.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      if constexpr (QLOAD) {  // k-steps 2p and 2p + 1 of q, read and split here
        const bool in_hd = !PAD || 16 * p + 4 * gq < hd;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 x = in_hd ? __ldg(reinterpret_cast<const float4*>(qa + 16 * p)) : zero;
        const float4 y = in_hd ? __ldg(reinterpret_cast<const float4*>(qb + 16 * p)) : zero;
        uint32_t ah[2][4], al[2][4];
        split(x.x, ah[0][0], al[0][0]);
        split(y.x, ah[0][1], al[0][1]);
        split(x.y, ah[0][2], al[0][2]);
        split(y.y, ah[0][3], al[0][3]);
        split(x.z, ah[1][0], al[1][0]);
        split(y.z, ah[1][1], al[1][1]);
        split(x.w, ah[1][2], al[1][2]);
        split(y.w, ah[1][3], al[1][3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint4* w = reinterpret_cast<const uint4*>(sk + (8 * j + gr) * SK + 32 * p + 8 * gq);
          const uint4 h = w[0], lo = w[1];
          mma_3xtf32(s[j], ah[0], al[0], h.x, h.y, lo.x, lo.y);
          mma_3xtf32(s[j], ah[1], al[1], h.z, h.w, lo.z, lo.w);
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint4* w = reinterpret_cast<const uint4*>(sk + (8 * j + gr) * SK + 32 * p + 8 * gq);
          const uint4 h = w[0], lo = w[1];
          mma_3xtf32(s[j], qh[2 * p], ql[2 * p], h.x, h.y, lo.x, lo.y);
          mma_3xtf32(s[j], qh[2 * p + 1], ql[2 * p + 1], h.z, h.w, lo.z, lo.w);
        }
      }
    }

    // s[j][e] (row lr0) and s[j][2 + e] (row lr1) are key 8j + 2gq + e of
    // the chunk: scale, bias in the plain version's order, keys past n -inf.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      [[maybe_unused]] float bias[4];
      if constexpr (GRID_ROW) {  // the chunk lies in grid row y: bh[i, y] + bw[i, x]
        const int y = c * BK / 64, x = c * BK - 64 * y + 8 * j + 2 * gq;
        const float2 w0 = *reinterpret_cast<const float2*>(b0r + gh + x);
        const float2 w1 = *reinterpret_cast<const float2*>(b1r + gh + x);
        bias[0] = b0r[y] + w0.x;
        bias[1] = b0r[y] + w0.y;
        bias[2] = b1r[y] + w1.x;
        bias[3] = b1r[y] + w1.y;
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = c * BK + 8 * j + 2 * gq + e;
          const bool ok = key < n;
          const int kk = ok ? key : n - 1;
          // kk / gw: (kk + 1/2) / gw is at least 1 / (2 gw) from an integer,
          // and the float32 product errs by less for kk below 2^22.
          const int ky = __float2int_rz((static_cast<float>(kk) + 0.5f) * inv_gw);
          const int kx = gh + kk - ky * gw;
          if constexpr (Rows::kStrip) {  // K6's order: ((q.k) scale + bh) + bw
            s[j][e] = ok ? __fadd_rn(__fadd_rn(__fmul_rn(s[j][e], scale), b0r[ky]), b0r[kx])
                         : -INFINITY;
            s[j][2 + e] = ok ? __fadd_rn(__fadd_rn(__fmul_rn(s[j][2 + e], scale), b1r[ky]),
                                         b1r[kx])
                             : -INFINITY;
          } else {
            bias[e] = ok ? b0r[ky] + b0r[kx] : -INFINITY;
            bias[2 + e] = ok ? b1r[ky] + b1r[kx] : -INFINITY;
          }
        }
      }
      if constexpr (!Rows::kStrip) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = folded ? __fmul_rn(__fadd_rn(s[j][e], bias[e]), scale)
                           : __fadd_rn(__fmul_rn(s[j][e], scale), bias[e]);
      }
    }

    // Online softmax: the row max over the chunk (4 lanes a row), the
    // rescale of the running sums and output, p = 2^(s log2 e - m log2 e).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float cn = fmaxf(cl[i], quad_max(mx[i]) * kLog2e);  // finite: a chunk has a key < n
      alpha[i] = ex2(cl[i] - cn);
      cl[i] = cn;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], kLog2e, -cl[e >> 1]));
        ls[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = fmaf(l[i], alpha[i], ls[i]);

    // o = o alpha + p . v. k slots (gq, gq + 4) of step j are keys 8j + 2gq +
    // (0, 1), the score columns this lane holds.
    if constexpr (OG == 0) {  // in o's own mma registers (short rows)
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e >> 1];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t ph[4], pl[4];
        split(s[j][0], ph[0], pl[0]);
        split(s[j][2], ph[1], pl[1]);
        split(s[j][1], ph[2], pl[2]);
        split(s[j][3], ph[3], pl[3]);
        const float* v0 = sv + (8 * j + 2 * gq) * SV + 2 * gr;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          const uint2 b0 = *reinterpret_cast<const uint2*>(v0 + 16 * dt);
          const uint2 b1 = *reinterpret_cast<const uint2*>(v0 + SV + 16 * dt);
          mma_3xtf32(o[dt], ph, pl, b0.x, b1.x, b0.y, b1.y);
        }
      }
    } else {  // the chunk's products in fresh registers, OG output tiles at a
              // time, joining o in one rounded FMA
#pragma unroll
      for (int d0 = 0; d0 < DT; d0 += OG) {
        float acc[OG][4];
#pragma unroll
        for (int dd = 0; dd < OG; ++dd)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[dd][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t ph[4], pl[4];
          split(s[j][0], ph[0], pl[0]);
          split(s[j][2], ph[1], pl[1]);
          split(s[j][1], ph[2], pl[2]);
          split(s[j][3], ph[3], pl[3]);
          const float* v0 = sv + (8 * j + 2 * gq) * SV + 2 * gr;
#pragma unroll
          for (int dd = 0; dd < OG; ++dd) {
            const uint2 b0 = *reinterpret_cast<const uint2*>(v0 + 16 * (d0 + dd));
            const uint2 b1 = *reinterpret_cast<const uint2*>(v0 + SV + 16 * (d0 + dd));
            mma_3xtf32(acc[dd], ph, pl, b0.x, b1.x, b0.y, b1.y);
          }
        }
#pragma unroll
        for (int dd = 0; dd < OG; ++dd)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[d0 + dd][e] = fmaf(o[d0 + dd][e], alpha[e >> 1], acc[dd][e]);
      }
    }
  }
  cp_async_wait<0>();

  // out = o / l; rows past nq (and every row of a stripe without a kept
  // row) zero.
  const int row0 = q0 + lr0, row1 = q0 + lr1;
  float inv[2] = {0.f, 0.f};
  if (active) {
#pragma unroll
    for (int i = 0; i < 2; ++i) inv[i] = 1.f / quad_sum(l[i]);
  }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = 8 * dt + 2 * gq;
    if (PAD && 8 * dt >= hd) continue;
    if (row0 < n)
      *reinterpret_cast<float2*>(g.out + g.out_off(row0) + col) =
          row0 < nq ? make_float2(o[dt][0] * inv[0], o[dt][1] * inv[0]) : make_float2(0.f, 0.f);
    if (row1 < n)
      *reinterpret_cast<float2*>(g.out + g.out_off(row1) + col) =
          row1 < nq ? make_float2(o[dt][2] * inv[1], o[dt][3] * inv[1]) : make_float2(0.f, 0.f);
  }
}

// K4 / K5 on group blockIdx.y, rows from blockIdx.x * BQ. QKV (K7): group
// g = (window w, head h) reads q, k, v in place from the (W, 3, nh, n, HD)
// qkv in a.q: q at (3 w nh n + h n) HD, k and v each nh n HD after the
// one before.
template <int HD, int NT, int WARPS, int OG, bool GRID_ROW, bool QKV, bool PAD>
__device__ __forceinline__ void dense_f32tc(const RelposArgs& a, const bool bias_smem) {
  const int n = a.n, g = blockIdx.y, q0 = blockIdx.x * F32Layout<HD, NT, WARPS>::BQ;
  const size_t hd = PAD ? a.hd : HD;
  const size_t base = static_cast<size_t>(g) * n;
  const float* q = static_cast<const float*>(a.q) + base * hd;
  const float* k = static_cast<const float*>(a.k) + base * hd;
  const float* v = static_cast<const float*>(a.v) + base * hd;
  if constexpr (QKV) {
    const int w = g / a.qkv_heads, h = g - w * a.qkv_heads;
    const size_t hn = static_cast<size_t>(a.qkv_heads) * n * hd;
    q = static_cast<const float*>(a.q) + 3 * w * hn + static_cast<size_t>(h) * n * hd;
    k = q + hn;
    v = k + hn;
  }
  const DenseRows32<HD, PAD> rows{{a.hd}, q, k, v, static_cast<float*>(a.out) + base * hd,
                                  static_cast<const float*>(a.bhw) + (base + q0) * (a.gh + a.gw)};
  const int nq = g >= a.g_skip ? min(a.n_valid, n) : n;  // rows whose output is kept
  f32tc_body<HD, NT, WARPS, OG, GRID_ROW>(rows, n, a.gh, a.gw, nq, q0, a.scale, a.folded != 0,
                                          bias_smem);
}

// Four entry kernels over one body, so that a profile tells K4, K5, K6 and
// K7 apart.
template <int HD, int NT, int WARPS, int OG, bool GRID_ROW, bool PAD>
__global__ void __launch_bounds__(32 * WARPS, 1)
    relpos_global_kernel_f32tc(RelposArgs a, int bias_smem) {
  dense_f32tc<HD, NT, WARPS, OG, GRID_ROW, false, PAD>(a, bias_smem != 0);
}

template <int HD, int NT, int WARPS, int OG, bool GRID_ROW, bool PAD>
__global__ void __launch_bounds__(32 * WARPS, 1)
    relpos_window_kernel_f32tc(RelposArgs a, int bias_smem) {
  dense_f32tc<HD, NT, WARPS, OG, GRID_ROW, false, PAD>(a, bias_smem != 0);
}

template <int HD, int NT, int WARPS, int OG, bool GRID_ROW, bool PAD>
__global__ void __launch_bounds__(32 * WARPS, 1)
    relpos_qkv_kernel_f32tc(RelposArgs a, int bias_smem) {
  dense_f32tc<HD, NT, WARPS, OG, GRID_ROW, true, PAD>(a, bias_smem != 0);
}

// K6: block blockIdx.x = ((b, wy, wx) window, head) * parts + part, head
// fastest; every token of the padded grid is a query and a key (no skip),
// the bias halves computed in the block, K6's order of the score's terms.
template <int HD, int NT, int WARPS, bool PAD>
__global__ void __launch_bounds__(32 * WARPS, 1) window_strip_kernel_f32tc(StripArgs a, int parts) {
  const int ws = a.ws, nwx = a.wp / ws, nwy = a.hp / ws;
  const int group = blockIdx.x / parts, part = blockIdx.x - group * parts;
  const int head = group % a.nh, win = group / a.nh;
  const int wx = win % nwx, wy = (win / nwx) % nwy, b = win / (nwx * nwy);
  const size_t hd = PAD ? a.c / a.nh : HD;
  const size_t tok0 = (static_cast<size_t>(b) * a.hp + wy * ws) * a.wp + wx * ws;
  const size_t in0 = tok0 * a.ts + static_cast<size_t>(head) * hd;
  const size_t out0 = tok0 * a.c + static_cast<size_t>(head) * hd;
  const WindowRows32<HD, PAD> rows{{static_cast<int>(hd)},
                              static_cast<const float*>(a.q) + in0,
                              static_cast<const float*>(a.k) + in0,
                              static_cast<const float*>(a.v) + in0,
                              static_cast<float*>(a.out) + out0,
                              static_cast<const float*>(a.rh),
                              static_cast<const float*>(a.rw),
                              ws, a.wp, a.ts, a.c};
  f32tc_body<HD, NT, WARPS, 0, false>(rows, ws * ws, ws, ws, ws * ws,
                                      part * F32Layout<HD, NT, WARPS>::BQ, a.scale, false, true);
}

template <int HD, int NT, int WARPS>
cudaError_t launch_f32tc(void (*kernel)(RelposArgs, int), const RelposArgs& a, int g,
                         cudaStream_t stream) {
  using L = F32Layout<HD, NT, WARPS>;
  // 16-byte loads of q, k, v rows, 16-byte stores of zeros into out.
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.out)) % 16 != 0)
    return cudaErrorInvalidValue;
  // The bias halves in shared memory where they fit beside the chunks.
  const size_t with_bias = L::chunk_bytes() + L::bias_bytes(a.gh + a.gw);
  const bool bias_smem = with_bias <= kMaxSmem;
  const size_t smem = bias_smem ? with_bias : L::chunk_bytes();
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.n + L::BQ - 1) / L::BQ, g);
  kernel<<<grid, 32 * WARPS, smem, stream>>>(a, bias_smem);
  return cudaGetLastError();
}

// K4: 8 warps of 16 query rows, 32-key chunks, p . v over all output tiles
// at once (4 at a time above hd 80).
template <int HD, bool PAD>
cudaError_t launch_global_f32tc(const RelposArgs& a, int g, cudaStream_t stream) {
  constexpr int OG = HD > 80 ? 4 : HD / 8;
  // Two chunks a grid row when gw == 64; gh even keeps the bw pairs 8-byte
  // aligned in shared memory.
  if (a.gw == 64 && a.gh % 2 == 0)
    return launch_f32tc<HD, 4, 8>(&relpos_global_kernel_f32tc<HD, 4, 8, OG, true, PAD>, a, g,
                                  stream);
  return launch_f32tc<HD, 4, 8>(&relpos_global_kernel_f32tc<HD, 4, 8, OG, false, PAD>, a, g,
                                stream);
}

// K5: 7 warps of 16 query rows (N = 196 is two blocks), 40-key chunks (32
// at hd 128, whose 40-key chunks do not fit in shared memory), p . v
// accumulating in o; windows of more than kWindowKeys keys take K4's body
// (which takes the folded bias and the skip too).
constexpr int kWindowKeys = 256;

template <int HD>
constexpr int window_chunk_tiles() { return HD > 96 ? 4 : 5; }

template <int HD, bool PAD>
cudaError_t launch_window_f32tc(const RelposArgs& a, int g, cudaStream_t stream) {
  constexpr int NT = window_chunk_tiles<HD>();
  if (a.n > kWindowKeys) return launch_global_f32tc<HD, PAD>(a, g, stream);
  return launch_f32tc<HD, NT, 7>(&relpos_window_kernel_f32tc<HD, NT, 7, 0, false, PAD>, a, g,
                                 stream);
}

// K7: K5's launch on the qkv kernel; windows of more than kWindowKeys keys
// take K4's block on the general grid path. launch_f32tc's 16-byte check of
// a.q covers every group's q, k and v (hd floats a row, hd a multiple of 8).
template <int HD, bool PAD>
cudaError_t launch_qkv_f32tc(const RelposArgs& a, int g, cudaStream_t stream) {
  constexpr int NT = window_chunk_tiles<HD>();
  constexpr int OG = HD > 80 ? 4 : HD / 8;
  if (a.n > kWindowKeys)
    return launch_f32tc<HD, 4, 8>(&relpos_qkv_kernel_f32tc<HD, 4, 8, OG, false, PAD>, a, g,
                                  stream);
  return launch_f32tc<HD, NT, 7>(&relpos_qkv_kernel_f32tc<HD, NT, 7, 0, false, PAD>, a, g,
                                 stream);
}

// K6: K5's shape of block (7 warps, K5's chunks, p . v in o), the window's
// tokens read in place, 2 blocks a 14 x 14 window and head.
template <int HD, bool PAD>
cudaError_t launch_strip_f32tc(const StripArgs& a, int batch, cudaStream_t stream) {
  constexpr int NT = window_chunk_tiles<HD>();
  using L = F32Layout<HD, NT, 7>;
  // Windows of up to 16 x 16 tokens (`quad_sum_scatter`'s 16 columns; the
  // caller checks ws * ws <= 208).
  if (a.ws > 16) return cudaErrorInvalidValue;
  // 16-byte loads of q, k, v rows and of the table rows (ts, c and hd
  // multiples of 4 floats).
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.out) |
       reinterpret_cast<uintptr_t>(a.rh) | reinterpret_cast<uintptr_t>(a.rw)) % 16 != 0 ||
      a.ts % 4 != 0 || a.c % 4 != 0)
    return cudaErrorInvalidValue;
  const int parts = (a.ws * a.ws + L::BQ - 1) / L::BQ;
  const long long blocks =
      static_cast<long long>(batch) * (a.hp / a.ws) * (a.wp / a.ws) * a.nh * parts;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = &window_strip_kernel_f32tc<HD, NT, 7, PAD>;
  const size_t smem = L::chunk_bytes() + L::bias_bytes(2 * a.ws);
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), 32 * 7, smem, stream>>>(a, parts);
  return cudaGetLastError();
}

}  // namespace

}  // namespace dlimg
