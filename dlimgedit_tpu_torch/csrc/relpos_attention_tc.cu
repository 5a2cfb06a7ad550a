// K4, K5, K7 and K6 in bfloat16 on Hopper's tensor cores: attention with
// the decomposed relative-position bias of the SAM ViT encoders, exact
// softmax.
//
// K4 (`relpos_global_tc`, kernel `relpos_global_kernel_tc`) replaces the TPU
// kernel dlimgedit_tpu/ops/flash_attention.py:139 `_attention_grouped`: the
// global blocks, one group per head over the whole token grid (ViT-B at
// 1024: 12 groups of N = 4096, hd 64; ViT-H: 16 groups, hd 80).
// K5 (`relpos_windowed_tc`, kernel `relpos_window_kernel_tc`) replaces :307
// `_attention_head_fused`: the windowed blocks (25 windows x 12 heads of
// N = 196), folded or plain bias, pad-query skip of the bottom window row.
// K7 (`relpos_windowed_tc` with qkv_heads, kernel `relpos_qkv_kernel_tc`)
// replaces :382 `windowed_attention_qkv`: K5's body on groups read in place
// from one (W, 3, nh, N, hd) tensor, plain bias, no skip.
// K6 (`window_strip_tc`, kernel `window_strip_kernel_tc`) replaces :646
// `windowed_attention_fused`: K5's body on windows read in place from the
// padded NHWC q, k, v (the channel slices of the qkv output), bias halves
// computed in the block, no skip.
// The float32 routes stay on the CUDA-core bodies of relpos_attention.cu
// (K4, K5, K7) and window_strip_attention.cu (K6), whose head notes give
// the arithmetic; this file computes the same functions with the JAX
// rounding: scores and softmax in float32, p normalised in float32 and then
// rounded to bf16, p . v accumulated in float32.
//
// What bounds them on an H100. K4 at ViT-B: 4 G N^2 hd = 51.5 GFLOP of
// minimal products (52 us at the bf16 peak) against ~25 MB moved (7.5 us),
// so operations; the exact two-pass softmax does 1.5x those products and
// two exponentials per score (402 M a launch, ~0.11 ms on the SFUs at 16 a
// clock per SM): a second floor, shared by the two passes, that the
// products can hide only if they run beside it. K5 at N = 196 is near the
// ridge: ~3.7 GFLOP against ~33 MB (~10 us either way); K7 and K6 likewise
// (K6 reads its q, k, v once from the qkv output, ~23 MB, writes 7.5 MB).
//
// All: exp(x) is ex2(x log2 e), log2 e folded into the FMA that forms the
// exponent (`ex2.approx`; the bf16 tolerance covers its last ulp against
// expf). p goes from the score accumulators straight into the A fragments
// of p . v, never through shared memory.
//
// K5 design (`mma.sync.m16n8k16`, bf16 in, float32 accumulate, B fragments
// by `ldmatrix` / `ldmatrix.trans`): one block of 4 warps per (window,
// head) group. K and V of the group (196 x 64 bf16 = 25 KB each; 31 KB at
// hd 80) arrive in shared memory by 16-byte cp.async, zero-filled to 208
// keys (256 for windows of up to 16 x 16), rows padded to hd + 8 elements
// so that the 8 rows an ldmatrix reads fall on distinct banks; beside them
// each query row's bias halves [bh | bw] and each key's one-hot row
// [ky | 16 + kx], bf16, 16 columns a half (windows of up to 16 x 16). A
// warp owns a 16-row stripe (13 stripes cover 196 rows, 4 rows of waste)
// and takes stripes in turn; its q fragments come straight from device
// memory. The bias is two more depth steps of the score product, [bh | bw]
// against the one-hot rows after q . k is scaled: exact products, no
// per-score lookups (adding bh[i, y_j] + bw[i, x_j] by index, four
// shared-memory reads a score, was a large share of the body's time). The whole
// score row stays in registers (26 key tiles, 104 floats a lane), so the
// row max and sum are exact in one pass and no key is seen twice. Keys past
// N score -inf; the window-partition pad keys are
// real zero-valued keys, as in JAX. Groups >= g_skip compute only the
// stripes that hold rows below n_valid and write zeros for every other row,
// including the rows of a stripe that straddles n_valid. K7 and K6 run the
// same body (`window_tc_body`), templated on where a group's rows lie:
// K7's at per-group offsets into the combined qkv, K6's at the window's
// tokens of the padded grid (token stride 3C for q, k, v, C for out; K and
// V by 16-byte cp.async from those strided rows, q by 4-byte loads, nothing
// partitioned or copied), one block per (image, window, head). K6 fills
// the bias halves itself before the stripes: for each window row (and
// column) a 16 x 16 x hd product of its tokens' q rows with the table
// slice rh[y] (rw[x]) on mma.sync, each half rounded to bf16 on its own as
// the TPU kernel rounds. q and the tables are read from device memory (staging
// them would cost the shared memory that lets two blocks share an SM at
// hd 80) in 16-byte loads, the head dims permuted alike in both operands
// (`bias_tile`), not in the stripes' 4-byte fragment loads, each of which
// touches 8 lines.
//
// K4 design (`wgmma`): K and V of a global head (512 KB each at ViT-B) do
// not fit 227 KB, so 64-key tiles stream through a five-stage cp.async ring,
// each tile loaded four steps before it is read (with fewer, the loads'
// latency set the pace). A block of 3 warpgroups owns 192 query rows (64 a
// warpgroup; 264 blocks fill 132 SMs in two waves at ViT-B) and shares each
// K / V tile among them. q . k is an SS wgmma (m64n64k16, q and K in shared
// memory as K-major core matrices without swizzle); p . v an RS wgmma (p in
// registers, V MN-major). Pass 1 computes q . k only and keeps, per lane and
// row, a running max and sum of exponentials, merged across the row's 4
// lanes at the end; q . k of the next tile runs while the statistics of
// this one are formed. Pass 2 recomputes q . k and forms p = exp(s - m) / l
// as one ex2 with log2 l folded into the exponent, rounds p to bf16 and
// accumulates p . v; p . v of a tile runs while p of the next is formed
// (the order of FlashAttention-3's loop). Every wgmma issue is paired with
// its wait on every path and its registers are fenced, so ptxas keeps the
// products asynchronous. When a key tile is one grid row (gw == 64, every
// ViT grid at 1024) the row half bh[i, y] is one value per query row and
// tile, and bw[i, x] is read as bf16 pairs; other grids look each key's
// (y, x) up in a table in shared memory, padding keys a -inf column. TMA
// loads from a producer warp and warpgroup ping-pong are later work
// (ROADMAP queue D).
#include <math.h>
#include <stdint.h>

#include "relpos_attention.cuh"
#include "tensor_core.cuh"

namespace dlimg {
namespace {

// wgmma (Hopper's warpgroup products). Shared-memory operand descriptor
// for the layout without swizzle: 8 x 16-byte core matrices, `lbo` bytes
// apart along K and `sbo` bytes apart along M / N.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3ffff) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Orders the generic-proxy writes (cp.async) before async-proxy reads (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of wgmma accumulators across the
// asynchronous product's issue and wait.
template <int R, int C>
__device__ __forceinline__ void fence_operands(float (&d)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
}

// d (+)= a . b for a 64 x 64 x 16 tile of the warpgroup, a and b K-major
// in shared memory; d in the mma.sync C layout for each warp's 16 rows,
// d[i] covering columns 8i .. 8i + 7.
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[8][4], uint64_t desc_a,
                                               uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += a . b for a 64 x N x 16 tile of the warpgroup (N = 64 or 80, the
// head width), a (this warp's 16 rows, the mma.sync A-fragment layout) in
// registers, b MN-major (transposed) in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_64xNx16_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                                 uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_64xNx16_rs<64>(float (&d)[8][4], const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_64xNx16_rs<80>(float (&d)[10][4], const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int C>
__device__ __forceinline__ void fence_operands(uint32_t (&r)[C][4]) {
#pragma unroll
  for (int i = 0; i < C; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// key j -> y | (gh + x) << 16 for j < n, `masked` for the tile padding.
__device__ __forceinline__ void stage_key_table(int* kyx, int count, int n, int gh, int gw,
                                                int masked, int tid, int nthreads) {
  for (int j = tid; j < count; j += nthreads) {
    const int ky = j / gw;
    kyx[j] = j < n ? ky | ((gh + j - ky * gw) << 16) : masked;
  }
}

// ---------------------------------------------------------------------------
// K5, K7 and K6: windows, one block per group (a head of a window)
// ---------------------------------------------------------------------------

constexpr int kWinThreads = 128;  // 4 warps, each taking 16-row stripes in turn

// The bias halves of the window body, in shared memory as bf16 rows of
// kBiasCols: a query row's [bh (16 columns) | bw (16)], and a key's one-hot
// [ky | 16 + kx] (zero past n), so that the bias is two more depth steps
// of the score product (`window_tc_body`). Windows of up to 16 x 16.
constexpr int kBiasSide = 16;
constexpr int kBiasCols = 2 * kBiasSide + 8;  // + 8: 16-byte rows on distinct banks

// Where a group of K5 or K7 keeps its rows: q, k, v and out rows r at
// r * HD from their pointers; the caller's bf16 bias halves, n x (gh + gw).
template <int HD>
struct DenseRows {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  const bf16* bhw;

  __device__ __forceinline__ size_t in(int r) const { return static_cast<size_t>(r) * HD; }
  __device__ __forceinline__ size_t out_off(int r) const { return static_cast<size_t>(r) * HD; }

  // The kept rows' bias halves, zero-padded to 16 columns each.
  __device__ __forceinline__ void stage_bias(bf16* ba, int nq, int gh, int gw, int tid, int,
                                             int) const {
    const int ghw = gh + gw;
    for (int e = tid; e < nq * kBiasSide; e += kWinThreads) {
      const int r = e / kBiasSide, c = 2 * (e - r * kBiasSide);  // c, c + 1 < 32
      const int half = c / kBiasSide, cc = c - half * kBiasSide;
      const int lim = half ? gw : gh;
      const bf16* src = bhw + static_cast<size_t>(r) * ghw + (half ? gh : 0) + cc;
      const bf16 zero = __float2bfloat16_rn(0.f);
      __nv_bfloat162 w;
      w.x = cc < lim ? src[0] : zero;
      w.y = cc + 1 < lim ? src[1] : zero;
      *reinterpret_cast<__nv_bfloat162*>(ba + r * kBiasCols + c) = w;
    }
  }
};

// c[t] += (rows r0, r1 of A) . (rows t0, t1 of B)^T for one 16 x 16 tile
// over HD: A rows gr (r0) and gr + 8 (r1), B rows gr (t0, columns 0 .. 7)
// and 8 + gr (t1, columns 8 .. 15), each row HD contiguous bf16 in device
// memory. A dot product does not care in which order its HD terms are
// summed, so A and B share a permutation of the head dims that lets each
// lane read 16 bytes a row: in depth step 2j (2j + 1) the lane's four
// k slots {2gq, 2gq + 1, 2gq + 8, 2gq + 9} hold dims 32j + 8gq + 0 .. 3
// (4 .. 7); at hd 80 the last step holds dims 64 + 4gq + 0 .. 3 (8 bytes).
template <int HD>
__device__ __forceinline__ void bias_tile(float (&c)[2][4], const bf16* r0, const bf16* r1,
                                          const bf16* t0, const bf16* t1, int gq) {
  constexpr int PAIRS = HD / 32;
  const bf16* rows[4] = {r0, r1, t0, t1};
  uint4 w[4][PAIRS];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < PAIRS; ++j)
      w[r][j] = __ldg(reinterpret_cast<const uint4*>(rows[r] + 32 * j + 8 * gq));
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const uint32_t lo[4] = {w[0][j].x, w[1][j].x, w[0][j].y, w[1][j].y};
    mma_bf16(c[0], lo, w[2][j].x, w[2][j].y);
    mma_bf16(c[1], lo, w[3][j].x, w[3][j].y);
    const uint32_t hi[4] = {w[0][j].z, w[1][j].z, w[0][j].w, w[1][j].w};
    mma_bf16(c[0], hi, w[2][j].z, w[2][j].w);
    mma_bf16(c[1], hi, w[3][j].z, w[3][j].w);
  }
  if constexpr (HD % 32 != 0) {
    static_assert(HD % 32 == 16, "a last depth step of 16 dims");
    uint2 x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      x[r] = __ldg(reinterpret_cast<const uint2*>(rows[r] + 32 * PAIRS + 4 * gq));
    const uint32_t a[4] = {x[0].x, x[1].x, x[0].y, x[1].y};
    mma_bf16(c[0], a, x[2].x, x[2].y);
    mma_bf16(c[1], a, x[3].x, x[3].y);
  }
}

// K6's group: the ws x ws tokens of one window of a padded (B, hp, wp, *)
// grid, read in place. Token t of the window is t / ws rows and t % ws
// columns from its first token; q, k, v rows are `ts` elements apart (3C
// for the channel slices of the qkv output), out rows `c`. Each pointer is
// at the window's first token and the head's first channel.
template <int HD>
struct WindowRows {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  const bf16* rh;  // gathered (ws, ws, HD) tables
  const bf16* rw;
  int ws, wp, ts, c;

  __device__ __forceinline__ size_t tok(int t) const {
    const int y = t / ws;
    return static_cast<size_t>(y) * wp + (t - y * ws);
  }
  __device__ __forceinline__ size_t in(int r) const { return tok(r) * ts; }
  __device__ __forceinline__ size_t out_off(int r) const { return tok(r) * c; }

  // The bias halves of every row, computed here as the TPU kernel does:
  // bh[i, y] = q_i . rh[y_i, y] and bw[i, x] = q_i . rw[x_i, x], float32
  // sums of the bf16 products on mma.sync, each half rounded to bf16 on
  // its own. Step u of a warp takes the ws tokens of window row u against
  // rh[u] (their bh) and those of window column u against rw[u] (their
  // bw), two independent 16 x 16 tiles whose 16 columns are the rows' 16
  // bias columns (those past ws written as zeros; tile rows past ws repeat
  // row ws - 1 and are dropped).
  __device__ __forceinline__ void stage_bias(bf16* ba, int, int, int, int, int warp,
                                             int lane) const {
    const int gr = lane >> 2, gq = lane & 3;
    const int m0 = min(gr, ws - 1), m1 = min(gr + 8, ws - 1);
    for (int u = warp; u < ws; u += kWinThreads / 32) {
      float c[2][2][4] = {};  // [bh, bw][columns 0 .. 7, 8 .. 15][fragment]
      const bf16* th = rh + static_cast<size_t>(u) * ws * HD;
      const bf16* tw = rw + static_cast<size_t>(u) * ws * HD;
      bias_tile<HD>(c[0], q + in(u * ws + m0), q + in(u * ws + m1), th + m0 * HD,
                    th + m1 * HD, gq);
      bias_tile<HD>(c[1], q + in(m0 * ws + u), q + in(m1 * ws + u), tw + m0 * HD,
                    tw + m1 * HD, gq);
      // c[h][t][e]: tile row gr (+ 8 for e >= 2), column 8 t + 2 gq + (e & 1).
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int m = gr + 8 * hi;
        if (m >= ws) continue;
        bf16* rowh = ba + (u * ws + m) * kBiasCols + 2 * gq;
        bf16* roww = ba + (m * ws + u) * kBiasCols + kBiasSide + 2 * gq;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int col = 8 * t + 2 * gq;
          const float* ch = c[0][t] + 2 * hi;
          const float* cw = c[1][t] + 2 * hi;
          st_u32(rowh + 8 * t, pack_bf16(col < ws ? ch[0] : 0.f, col + 1 < ws ? ch[1] : 0.f));
          st_u32(roww + 8 * t, pack_bf16(col < ws ? cw[0] : 0.f, col + 1 < ws ? cw[1] : 0.f));
        }
      }
    }
  }
};

// The body of K5, K7 and K6 for one group of n <= NP tokens on a grid of
// gh x gw <= 16 x 16 (`Rows` says where its rows lie and where its bias
// halves come from); rows below nq are computed, the rest written as
// zeros. The score is s = (q.k) alpha + bh + bw, the bias added by two
// depth steps of [bh | bw] against the keys' one-hot rows, whose products
// are exact; p = exp(s - max s) = 2^(s gamma - max s gamma). alpha = scale
// and gamma = log2 e for the plain bias; alpha = 1 and gamma = scale log2 e
// for the folded one (the halves divided by scale).
template <int HD, int NP, class Rows>
__device__ __forceinline__ void window_tc_body(unsigned char* smem_raw, const Rows& g,
                                               const int n, const int gh, const int gw,
                                               const int nq, const float alpha,
                                               const float gamma) {
  static_assert(HD % 16 == 0 && NP % 16 == 0, "tiles of 16");
  static_assert(HD / 2 <= kBiasCols, "a half output row fits a bias row");
  constexpr int KS = HD + 8;       // shared row stride (elements)
  constexpr int KSTEPS = HD / 16;  // depth steps of q . k
  constexpr int NT = NP / 8;       // 8-key tiles of a score row
  constexpr int DT = HD / 8;       // 8-column tiles of the output
  constexpr int CPR = HD / 8;      // 16-byte chunks of a row
  constexpr int BS = kBiasCols;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // NP x KS
  bf16* vs = ks + NP * KS;                       // NP x KS
  bf16* oh = vs + NP * KS;                       // NP x BS: keys' one-hot rows
  bf16* ba = oh + NP * BS;                       // NP x BS: rows' bias halves (nq staged)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, gq = lane & 3;

  for (int e = tid; e < NP * CPR; e += kWinThreads) {
    const int r = e / CPR, c = (e - r * CPR) * 8;
    const bool ok = r < n;
    const size_t off = g.in(ok ? r : 0) + c;
    cp_async16(ks + r * KS + c, g.k + off, ok);
    cp_async16(vs + r * KS + c, g.v + off, ok);
  }
  cp_async_commit();
  for (int e = tid; e < NP * kBiasSide; e += kWinThreads) {  // one-hot pairs
    const int j = e / kBiasSide, c = 2 * (e - j * kBiasSide);
    const int ky = j / gw, hit = c < kBiasSide ? ky : kBiasSide + j - ky * gw;
    const uint32_t one = 0x3f80u;  // bf16 1.0
    st_u32(oh + j * BS + c, j >= n ? 0u : hit == c ? one : hit == c + 1 ? one << 16 : 0u);
  }
  g.stage_bias(ba, nq, gh, gw, tid, warp, lane);
  cp_async_wait<0>();
  __syncthreads();
  const int stripes = (nq + 15) / 16;  // stripes holding a kept row

  for (int st = warp; st < NP / 16; st += kWinThreads / 32) {
    const int r0 = st * 16 + gr, r1 = r0 + 8;
    if (st >= stripes) {  // skipped pad queries and tile padding: zeros
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int c = 8 * dt + 2 * gq;
        if (r0 < n) st_u32(g.out + g.out_off(r0) + c, 0u);
        if (r1 < n) st_u32(g.out + g.out_off(r1) + c, 0u);
      }
      continue;
    }
    // q fragments straight from device memory (rows past n repeat row n - 1;
    // their results are never stored).
    uint32_t qa[KSTEPS][4];
    {
      const bf16* q0 = g.q + g.in(min(r0, n - 1)) + 2 * gq;
      const bf16* q1 = g.q + g.in(min(r1, n - 1)) + 2 * gq;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        qa[kk][0] = ldg_u32(q0 + 16 * kk);
        qa[kk][1] = ldg_u32(q1 + 16 * kk);
        qa[kk][2] = ldg_u32(q0 + 16 * kk + 8);
        qa[kk][3] = ldg_u32(q1 + 16 * kk + 8);
      }
    }
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, ks + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * KS + 16 * kk +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qa[kk], b[2], b[3]);
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= alpha;

    // + bh[i, y_j] + bw[i, x_j]: the stripe's [bh | bw] rows against the keys'
    // one-hot rows, two depth steps.
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      uint32_t a[4];
      ldsm_x4(a, ba + (16 * st + (lane & 7) + ((lane >> 3) & 1) * 8) * BS + 16 * kb +
                     (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, oh + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * BS + 16 * kb +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], a, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
      }
    }

    // Keys past n masked, row max.
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * j + 2 * gq + e >= n) {
          s[j][e] = -INFINITY;
          s[j][2 + e] = -INFINITY;
        }
        m0 = fmaxf(m0, s[j][e]);
        m1 = fmaxf(m1, s[j][2 + e]);
      }
    const float c0 = -quad_max(m0) * gamma, c1 = -quad_max(m1) * gamma;
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = ex2(fmaf(s[j][0], gamma, c0));
      s[j][1] = ex2(fmaf(s[j][1], gamma, c0));
      s[j][2] = ex2(fmaf(s[j][2], gamma, c1));
      s[j][3] = ex2(fmaf(s[j][3], gamma, c1));
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
        ldsm_x4_trans(b, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * KS +
                             16 * dp + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    // The output tile goes out through this stripe's bias rows (read above
    // and by no other warp), HD / 2 columns at a time, so that each store
    // writes 16-byte chunks of 8 rows. (K6's output rows lie C apart, and
    // 4-byte stores straight from the accumulators were a large share of
    // its time.)
    constexpr int HW = HD / 2, CH = HW / 8;  // columns, 16-byte chunks a half row
    bf16* stage = ba + 16 * st * BS;
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int dt = h * DT / 2; dt < (h + 1) * DT / 2; ++dt) {
        const int c = 8 * dt - h * HW + 2 * gq;
        st_u32(stage + gr * BS + c, r0 < nq ? pack_bf16(o[dt][0], o[dt][1]) : 0u);
        st_u32(stage + (gr + 8) * BS + c, r1 < nq ? pack_bf16(o[dt][2], o[dt][3]) : 0u);
      }
      __syncwarp();
#pragma unroll
      for (int e = lane; e < 16 * CH; e += 32) {
        const int rr = e / CH, c = (e - rr * CH) * 8, r = 16 * st + rr;
        if (r < n)
          *reinterpret_cast<uint4*>(g.out + g.out_off(r) + h * HW + c) =
              *reinterpret_cast<const uint4*>(stage + rr * BS + c);
      }
      __syncwarp();
    }
  }
}

// Three entry kernels over one body, so that a profile tells K5, K7 and K6
// apart. K5: group g's rows at g * n, folded or plain bias, pad-query skip.
template <int HD, int NP>
__global__ void __launch_bounds__(kWinThreads, 2) relpos_window_kernel_tc(RelposArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, g = blockIdx.x;
  const size_t base = static_cast<size_t>(g) * n;
  const DenseRows<HD> rows{static_cast<const bf16*>(a.q) + base * HD,
                           static_cast<const bf16*>(a.k) + base * HD,
                           static_cast<const bf16*>(a.v) + base * HD,
                           static_cast<bf16*>(a.out) + base * HD,
                           static_cast<const bf16*>(a.bhw) + base * (a.gh + a.gw)};
  const int nq = g >= a.g_skip ? min(a.n_valid, n) : n;  // rows whose output is kept
  window_tc_body<HD, NP>(smem_raw, rows, n, a.gh, a.gw, nq, a.folded ? 1.f : a.scale,
                         a.folded ? a.scale * kLog2e : kLog2e);
}

// K7: group g = (window w, head h) reads q, k, v in place from the
// (W, 3, nh, n, HD) qkv at w 3 nh n + h n and one and two nh n further;
// output and bias halves at g * n. Plain bias, every row kept.
template <int HD, int NP>
__global__ void __launch_bounds__(kWinThreads, 2) relpos_qkv_kernel_tc(RelposArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, nh = a.qkv_heads, g = blockIdx.x;
  const size_t hn = static_cast<size_t>(nh) * n;
  const size_t qbase = static_cast<size_t>(g / nh) * 3 * hn + static_cast<size_t>(g % nh) * n;
  const size_t base = static_cast<size_t>(g) * n;
  const bf16* qkv = static_cast<const bf16*>(a.q);
  const DenseRows<HD> rows{qkv + qbase * HD, qkv + (qbase + hn) * HD,
                           qkv + (qbase + 2 * hn) * HD, static_cast<bf16*>(a.out) + base * HD,
                           static_cast<const bf16*>(a.bhw) + base * (a.gh + a.gw)};
  window_tc_body<HD, NP>(smem_raw, rows, n, a.gh, a.gw, n, a.scale, kLog2e);
}

// K6: block g = ((b, wy, wx) window, head), head fastest; every token of
// the padded grid is a query and a key (no skip), the bias halves are
// computed in the block.
template <int HD, int NP>
__global__ void __launch_bounds__(kWinThreads, 2) window_strip_kernel_tc(StripArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ws = a.ws, nwx = a.wp / ws, nwy = a.hp / ws;
  const int head = blockIdx.x % a.nh, win = blockIdx.x / a.nh;
  const int wx = win % nwx, wy = (win / nwx) % nwy, b = win / (nwx * nwy);
  const size_t tok0 = (static_cast<size_t>(b) * a.hp + wy * ws) * a.wp + wx * ws;
  const size_t in0 = tok0 * a.ts + static_cast<size_t>(head) * HD;
  const size_t out0 = tok0 * a.c + static_cast<size_t>(head) * HD;
  const WindowRows<HD> rows{static_cast<const bf16*>(a.q) + in0,
                            static_cast<const bf16*>(a.k) + in0,
                            static_cast<const bf16*>(a.v) + in0,
                            static_cast<bf16*>(a.out) + out0,
                            static_cast<const bf16*>(a.rh),
                            static_cast<const bf16*>(a.rw),
                            ws, a.wp, a.ts, a.c};
  window_tc_body<HD, NP>(smem_raw, rows, ws * ws, ws, ws, ws * ws, a.scale, kLog2e);
}

// K, V, the keys' one-hot rows and the rows' bias halves, NP rows each (a
// stripe past n reads and ignores its rows): 91 KB at hd 64 and 104 KB at
// hd 80 for 14 x 14 windows, so that two blocks share an SM.
template <int HD, int NP, class Args>
cudaError_t launch_window_tc(void (*kernel)(Args), const Args& a, long long blocks,
                             cudaStream_t stream) {
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = sizeof(bf16) * 2 * NP * (HD + 8 + kBiasCols);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), kWinThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD, int NP>
cudaError_t launch_relpos_window_tc(const RelposArgs& a, int g, cudaStream_t stream) {
  return a.qkv_heads > 0
             ? launch_window_tc<HD, NP>(&relpos_qkv_kernel_tc<HD, NP>, a, g, stream)
             : launch_window_tc<HD, NP>(&relpos_window_kernel_tc<HD, NP>, a, g, stream);
}

// ---------------------------------------------------------------------------
// K4: global blocks; 3 warpgroups of 64 query rows, 64-key tiles streamed
// twice, q . k on wgmma one tile ahead of the softmax
// ---------------------------------------------------------------------------

constexpr int kGlbBK = 64;                 // keys a tile
constexpr int kGlbGroups = 3;              // warpgroups a block
constexpr int kGlbThreads = 128 * kGlbGroups;
constexpr int kGlbBM = 64 * kGlbGroups;    // query rows a block
constexpr int kGlbStages = 5;              // K tiles, and V tiles, in shared memory
constexpr int kGlbAhead = kGlbStages - 1;  // tiles loaded ahead of the one read

// Row stride (elements) of the block's bf16 bias halves in shared memory:
// 16-byte rows, room for column ghw (-inf, looked up by the padding keys of
// general grids), and a word stride of 4 mod 32, so that the bw pairs of a
// warp (8 rows x 4 lanes) fall on 32 banks.
__host__ __device__ inline int glb_bias_stride(int ghw) { return (ghw + 56) / 64 * 64 + 8; }

// 64 rows x HD columns as wgmma's K-major core matrices without swizzle:
// row r, columns 8c .. 8c + 7 in the 16 bytes at chunk (r / 8) * (HD / 8) * 8
// + c * 8 + r % 8. Core matrices are 128 bytes apart along K (LBO) and
// 16 HD bytes apart along the rows (SBO).
template <int HD>
__device__ __forceinline__ int core_chunk(int r, int c) {
  return ((r >> 3) * (HD / 8) + c) * 8 + (r & 7);
}

template <int HD>
struct GlbLayout {
  static constexpr int TILE = kGlbBK * HD;    // a K or V tile in core matrices
  static constexpr int Q_ROWS = kGlbBM * HD;  // the block's q rows in core matrices
  static size_t bytes(int ghw, int kyx_count) {
    return sizeof(bf16) * (Q_ROWS + 2 * kGlbStages * TILE +
                           static_cast<size_t>(kGlbBM) * glb_bias_stride(ghw)) +
           sizeof(int) * kyx_count;
  }
};

// A thread's running state of K4: the row statistics (pass 1), then p of
// the tile in flight in p . v and the output accumulators (pass 2).
template <int HD>
struct GlbAcc {
  float m[2], l[2];
  uint32_t pa[4][4];
  float o[HD / 8][4];
};

// What one thread of K4 works with: the shared-memory stages, its rows'
// bias halves, and the steps of a pass. Every member is inlined, so the
// score arrays stay in registers while their wgmma is in flight.
//
// Loads: every step commits one cp.async group, the tiles kGlbAhead ahead
// of the one it reads, so each tile has kGlbAhead - 1 steps to land. The
// stage a load overwrites held the tile of the step before, whose products
// every warpgroup retired before this step's barrier.
template <int HD, bool GRID_ROW>
struct GlobalCtx {
  using L = GlbLayout<HD>;
  static constexpr int CPR = HD / 8;
  bf16* ks;           // kGlbStages K tiles
  bf16* vs;           // kGlbStages V tiles
  const bf16* b0r;    // bias halves of this lane's two rows
  const bf16* b1r;
  const int* kyx;     // key -> (y, gh + x) (general grids)
  const bf16* k;
  const bf16* v;
  uint64_t desc_q;    // this warpgroup's 64 q rows
  int n, n_tiles, gh, tid, lane;
  float scale;

  // K or V tile t into its stage as wgmma's core matrices (key r, dims
  // 8c .. 8c + 7 at chunk core_chunk(r, c)); consecutive threads write
  // consecutive 16-byte chunks. K is read K-major, V MN-major.
  __device__ __forceinline__ void load_tile(bf16* stages, const bf16* src, int t) const {
    bf16* dst = stages + (t % kGlbStages) * L::TILE;
    for (int e = tid; e < kGlbBK * CPR; e += kGlbThreads) {
      const int key = t * kGlbBK + (e >> 3) / CPR * 8 + (e & 7);
      const bool ok = key < n;
      cp_async16(dst + e * 8,
                 src + static_cast<size_t>(ok ? key : 0) * HD + (e >> 3) % CPR * 8, ok);
    }
  }

  // The loads of one step: tile t (K, and V in pass 2), if it exists.
  template <bool PASS2>
  __device__ __forceinline__ void load_ahead(int t) const {
    if (t < n_tiles) {
      load_tile(ks, k, t);
      if constexpr (PASS2) load_tile(vs, v, t);
    }
    cp_async_commit();
  }

  // Waits until this thread's loads older than the newest `kGlbAhead - 2`
  // groups have landed, makes them visible to wgmma, and waits for every
  // thread's.
  __device__ __forceinline__ void landed() const {
    cp_async_wait<kGlbAhead - 2>();
    fence_proxy_async();
    __syncthreads();
  }

  // q . k of tile t on wgmma, asynchronous: the caller waits.
  __device__ __forceinline__ void issue_qk(float (&s)[8][4], int t) const {
    const uint64_t desc_k = gmma_desc(ks + (t % kGlbStages) * L::TILE, 128, 16 * HD);
    fence_operands(s);  // no register copy may land between the fence and the products
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_64x64x16(s, desc_q + 16 * kk, desc_k + 16 * kk, kk);
    wgmma_commit();
    fence_operands(s);
  }

  // The scores of this lane's 2 rows x 16 keys of tile t,
  // u = q.k * scale + bh + bw, except that on a grid-row tile u leaves out
  // the row half bh[i, t]: one value a row, which `row_half` gives and the
  // steps add once per tile.
  __device__ __forceinline__ void add_bias(float (&s)[8][4], int t) const {
    const int gq = lane & 3;
    if constexpr (GRID_ROW) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(b0r + gh + 8 * j + 2 * gq);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(b1r + gh + 8 * j + 2 * gq);
        s[j][0] = fmaf(s[j][0], scale, bf_lo(w0));
        s[j][1] = fmaf(s[j][1], scale, bf_hi(w0));
        s[j][2] = fmaf(s[j][2], scale, bf_lo(w1));
        s[j][3] = fmaf(s[j][3], scale, bf_hi(w1));
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int2 kt2 = *reinterpret_cast<const int2*>(kyx + t * kGlbBK + 8 * j + 2 * gq);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int te = e ? kt2.y : kt2.x;
          const int ky = te & 0xffff, kx = te >> 16;
          s[j][e] = fmaf(s[j][e], scale, bf(b0r[ky]) + bf(b0r[kx]));
          s[j][2 + e] = fmaf(s[j][2 + e], scale, bf(b1r[ky]) + bf(b1r[kx]));
        }
      }
    }
  }

  __device__ __forceinline__ void row_half(int t, float& h0, float& h1) const {
    if constexpr (GRID_ROW) {  // tile t is grid row t
      h0 = bf(b0r[t]);
      h1 = bf(b1r[t]);
    } else {
      h0 = h1 = 0.f;
    }
  }

  // Pass 1 on tile t: per lane and row, running max m of u + h and sum l of
  // exp(u + h - m) = 2^((u + h - m) log2 e) over the lane's keys (log2 e
  // folded into one FMA a score); a lane that has seen only masked keys
  // keeps m = -inf and l = 0.
  __device__ __forceinline__ void stats(const float (&s)[8][4], int t, GlbAcc<HD>& acc) const {
    float h[2];
    row_half(t, h[0], h[1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mu = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mu = fmaxf(mu, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      const float mt = fmaxf(acc.m[i], mu + h[i]);
      const float c = mt == -INFINITY ? 0.f : (h[i] - mt) * kLog2e;
      float add = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        add += ex2(fmaf(s[j][2 * i], kLog2e, c)) + ex2(fmaf(s[j][2 * i + 1], kLog2e, c));
      acc.l[i] = mt == -INFINITY ? 0.f : fmaf(acc.l[i], ex2((acc.m[i] - mt) * kLog2e), add);
      acc.m[i] = mt;
    }
  }

  // Pass 2 on tile t: p = 2^((u + h) log2 e - m) with m = max log2 e +
  // log2 l (so p is normalised), rounded to bf16 straight into the A
  // fragments of p . v.
  __device__ __forceinline__ void probabilities(const float (&s)[8][4], int t, const float (&m)[2],
                                                uint32_t (&pa)[4][4]) const {
    float h0, h1;
    row_half(t, h0, h1);
    const float c0 = fmaf(h0, kLog2e, -m[0]), c1 = fmaf(h1, kLog2e, -m[1]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const float(&r)[4] = s[2 * kk + hi];
        pa[kk][2 * hi] = pack_bf16(ex2(fmaf(r[0], kLog2e, c0)), ex2(fmaf(r[1], kLog2e, c0)));
        pa[kk][2 * hi + 1] = pack_bf16(ex2(fmaf(r[2], kLog2e, c1)), ex2(fmaf(r[3], kLog2e, c1)));
      }
    }
  }

  // o += p . v of tile t on wgmma, V MN-major from shared memory: core
  // matrices 16 HD bytes apart along the keys (K), 128 bytes apart along the
  // head dims (N); 16 keys a step. Asynchronous: the caller waits.
  __device__ __forceinline__ void issue_pv(uint32_t (&pa)[4][4], int t,
                                           float (&o)[HD / 8][4]) const {
    const uint64_t desc_v = gmma_desc(vs + (t % kGlbStages) * L::TILE, 16 * HD, 128);
    fence_operands(pa);
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_64xNx16_rs<HD>(o, pa[kk], desc_v + 2 * HD * kk);
    wgmma_commit();
    fence_operands(pa);
    fence_operands(o);
  }

  // Pass 1 step on a tile that has a next one: K(t + 1) has landed, so
  // start q . k of t + 1 into `nxt`, and form the statistics of tile t,
  // whose q . k was started one step earlier into `cur`.
  __device__ __forceinline__ void step1(float (&cur)[8][4], float (&nxt)[8][4], int t,
                                        GlbAcc<HD>& acc) const {
    landed();
    load_ahead<false>(t + kGlbAhead);
    issue_qk(nxt, t + 1);
    wgmma_wait<1>();
    fence_operands(cur);
    add_bias(cur, t);
    stats(cur, t, acc);
  }

  // Pass 1 on the last tile, its q . k in flight in `cur`.
  __device__ __forceinline__ void last1(float (&cur)[8][4], int t, GlbAcc<HD>& acc) const {
    wgmma_wait<0>();
    fence_operands(cur);
    add_bias(cur, t);
    stats(cur, t, acc);
  }

  // Pass 1: q . k of one tile in flight while the statistics of the one
  // before it are formed; two score arrays and the loop unrolled by two,
  // every issue paired with its wait on every path.
  __device__ __forceinline__ void pass1(float (&sa)[8][4], float (&sb)[8][4],
                                        GlbAcc<HD>& acc) const {
    issue_qk(sa, 0);
    int t = 0;
    for (; t + 2 < n_tiles; t += 2) {
      step1(sa, sb, t, acc);
      step1(sb, sa, t + 1, acc);
    }
    if (t + 1 < n_tiles) {
      step1(sa, sb, t, acc);
      last1(sb, t + 1, acc);
    } else {
      last1(sa, t, acc);
    }
  }

  // Pass 2 step on a tile that has a next one, p of tile t in `pcur`: start
  // q . k of t + 1 and p . v of t, form p of t + 1 into `pnxt` while p . v
  // runs, then wait for it.
  __device__ __forceinline__ void step2(float (&s)[8][4], uint32_t (&pcur)[4][4],
                                        uint32_t (&pnxt)[4][4], int t, GlbAcc<HD>& acc) const {
    landed();  // K(t + 1), V(t)
    load_ahead<true>(t + kGlbAhead);
    issue_qk(s, t + 1);
    issue_pv(pcur, t, acc.o);
    wgmma_wait<1>();
    fence_operands(s);
    add_bias(s, t + 1);
    probabilities(s, t + 1, acc.m, pnxt);
    wgmma_wait<0>();
  }

  // Pass 2: p . v of one tile in flight while p of the next is formed.
  __device__ __forceinline__ void pass2(float (&s)[8][4], GlbAcc<HD>& acc) const {
    issue_qk(s, 0);
    wgmma_wait<0>();
    fence_operands(s);
    add_bias(s, 0);
    probabilities(s, 0, acc.m, acc.pa);
    uint32_t pb[4][4];
    int t = 0;
    for (; t + 2 < n_tiles; t += 2) {
      step2(s, acc.pa, pb, t, acc);
      step2(s, pb, acc.pa, t + 1, acc);
    }
    cp_async_wait<0>();  // the last V tile
    fence_proxy_async();
    if (t + 1 < n_tiles) {
      step2(s, acc.pa, pb, t, acc);
      __syncthreads();
      issue_pv(pb, t + 1, acc.o);
    } else {
      __syncthreads();
      issue_pv(acc.pa, t, acc.o);
    }
    wgmma_wait<0>();
  }
};

template <int HD, bool GRID_ROW>
__global__ void __launch_bounds__(kGlbThreads, 1) relpos_global_kernel_tc(RelposArgs a) {
  static_assert(HD % 16 == 0, "head width must be a multiple of 16");
  using L = GlbLayout<HD>;
  constexpr int CPR = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kGlbBM q rows, core matrices
  bf16* ks = qs + L::Q_ROWS;                     // kGlbStages K tiles
  bf16* vs = ks + kGlbStages * L::TILE;          // kGlbStages V tiles
  bf16* bs = vs + kGlbStages * L::TILE;          // kGlbBM x bstr bias halves
  const int n = a.n, gh = a.gh, ghw = gh + a.gw;
  const int bstr = glb_bias_stride(ghw);
  int* kyx = reinterpret_cast<int*>(bs + kGlbBM * bstr);  // general grids only

  const int g = blockIdx.y, q0 = blockIdx.x * kGlbBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t base = static_cast<size_t>(g) * n;
  const bf16* q = static_cast<const bf16*>(a.q) + base * HD;
  const bf16* bhw = static_cast<const bf16*>(a.bhw) + (base + q0) * ghw;
  bf16* out = static_cast<bf16*>(a.out) + base * HD;
  const int n_tiles = (n + kGlbBK - 1) / kGlbBK;
  const int rows = min(kGlbBM, n - q0);      // the block's query rows below n
  const int r0 = warp * 16 + (lane >> 2);  // this lane's rows in the block: r0, r0 + 8

  const GlobalCtx<HD, GRID_ROW> c{
      ks, vs, bs + r0 * bstr, bs + (r0 + 8) * bstr, kyx,
      static_cast<const bf16*>(a.k) + base * HD, static_cast<const bf16*>(a.v) + base * HD,
      gmma_desc(qs + (warp >> 2) * 64 * HD, 128, 16 * HD), n, n_tiles, gh, tid, lane, a.scale};

  // The first load group: the block's q rows and bias halves (16-byte
  // chunks where the rows allow), then K tiles 0 .. kGlbAhead - 1.
  for (int e = tid; e < kGlbBM * CPR; e += kGlbThreads) {
    const int r = e / CPR, col = e - r * CPR;
    const bool ok = q0 + r < n;
    cp_async16(qs + core_chunk<HD>(r, col) * 8,
               q + static_cast<size_t>(ok ? q0 + r : 0) * HD + col * 8, ok);
  }
  if (ghw % 8 == 0 && reinterpret_cast<uintptr_t>(bhw) % 16 == 0) {
    const int cpr = ghw / 8;
    for (int e = tid; e < rows * cpr; e += kGlbThreads) {
      const int r = e / cpr, col = (e - r * cpr) * 8;
      cp_async16(bs + r * bstr + col, bhw + r * ghw + col, true);
    }
  } else {
    for (int e = tid; e < rows * ghw; e += kGlbThreads) {
      const int r = e / ghw;
      bs[r * bstr + e - r * ghw] = bhw[e];
    }
  }
  if constexpr (!GRID_ROW) {  // padding keys look up column ghw, which holds -inf
    stage_key_table(kyx, n_tiles * kGlbBK, n, gh, a.gw, ghw | (ghw << 16), tid, kGlbThreads);
    for (int r = tid; r < kGlbBM; r += kGlbThreads) bs[r * bstr + ghw] = __float2bfloat16(-INFINITY);
  }
#pragma unroll
  for (int t = 0; t < kGlbAhead; ++t) c.template load_ahead<false>(t);
  cp_async_wait<kGlbAhead - 1>();
  fence_proxy_async();
  __syncthreads();

  GlbAcc<HD> acc;
  float sa[8][4], sb[8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    acc.m[i] = -INFINITY;
    acc.l[i] = 0.f;
  }
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc.o[dt][e] = 0.f;
  c.pass1(sa, sb, acc);
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // merge the row's 4 lanes; fold in 1 / l
    const float mq = quad_max(acc.m[i]);
    const float lq = quad_sum(
        acc.m[i] == -INFINITY ? 0.f : acc.l[i] * ex2((acc.m[i] - mq) * kLog2e));
    acc.m[i] = fmaf(mq, kLog2e, log2f(lq));
  }

  cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with pass 1's K stages
#pragma unroll
  for (int t = 0; t < kGlbAhead; ++t) c.template load_ahead<true>(t);
  cp_async_wait<kGlbAhead - 1>();
  fence_proxy_async();
  __syncthreads();
  c.pass2(sa, acc);
  fence_operands(acc.o);

  const int row0 = q0 + r0, row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int col = 8 * dt + 2 * (lane & 3);
    if (row0 < n)
      st_u32(out + static_cast<size_t>(row0) * HD + col, pack_bf16(acc.o[dt][0], acc.o[dt][1]));
    if (row1 < n)
      st_u32(out + static_cast<size_t>(row1) * HD + col, pack_bf16(acc.o[dt][2], acc.o[dt][3]));
  }
}

template <int HD, bool GRID_ROW>
cudaError_t launch_global_tc(const RelposArgs& a, int g, cudaStream_t stream) {
  auto kernel = &relpos_global_kernel_tc<HD, GRID_ROW>;
  const int n_tiles = (a.n + kGlbBK - 1) / kGlbBK;
  const size_t smem = GlbLayout<HD>::bytes(a.gh + a.gw, GRID_ROW ? 0 : n_tiles * kGlbBK);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.n + kGlbBM - 1) / kGlbBM, g);
  kernel<<<grid, kGlbThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

cudaError_t relpos_global_tc(const RelposArgs& a, int g, int hd, cudaStream_t stream) {
  // A key tile is one grid row when gw == 64; gh even keeps the bw pairs
  // 4-byte aligned in shared memory.
  const bool row = a.gw == kGlbBK && a.gh % 2 == 0;
  if (hd == 64)
    return row ? launch_global_tc<64, true>(a, g, stream)
               : launch_global_tc<64, false>(a, g, stream);
  if (hd == 80)
    return row ? launch_global_tc<80, true>(a, g, stream)
               : launch_global_tc<80, false>(a, g, stream);
  return cudaErrorInvalidValue;
}

cudaError_t relpos_windowed_tc(const RelposArgs& a, int g, int hd, cudaStream_t stream) {
  if (a.gh > kBiasSide || a.gw > kBiasSide) return cudaErrorInvalidValue;
  const bool small = a.n <= 208;  // 14 x 14 windows: 13 stripes
  if (hd == 64)
    return small ? launch_relpos_window_tc<64, 208>(a, g, stream)
                 : launch_relpos_window_tc<64, 256>(a, g, stream);
  if (hd == 80)
    return small ? launch_relpos_window_tc<80, 208>(a, g, stream)
                 : launch_relpos_window_tc<80, 256>(a, g, stream);
  return cudaErrorInvalidValue;
}

cudaError_t window_strip_tc(const StripArgs& a, int batch, int hd, cudaStream_t stream) {
  // Windows of up to 14 x 14 tokens (the caller checks ws * ws <= 208).
  if (a.ws > 14) return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(batch) * (a.hp / a.ws) * (a.wp / a.ws) * a.nh;
  if (hd == 64)
    return launch_window_tc<64, 208>(&window_strip_kernel_tc<64, 208>, a, blocks, stream);
  if (hd == 80)
    return launch_window_tc<80, 208>(&window_strip_kernel_tc<80, 208>, a, blocks, stream);
  return cudaErrorInvalidValue;
}

}  // namespace dlimg
