// The bodies of the bf16 and float16 tensor-core kernels K4, K5, K7 and K6:
// the design is the note below. relpos_attention_tc.cu instantiates them
// in bf16 at hd 64 and 80, relpos_attention_tc_pad.cu in bf16 at the
// padded widths; relpos_attention_tc_f16.cu and relpos_attention_tc_f16_pad.cu
// likewise in float16.
//
// K4, K5, K7 and K6 in bfloat16 and float16 on Hopper's tensor cores:
// attention with the decomposed relative-position bias of the SAM ViT
// encoders, exact softmax.
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
// The float32 routes run in relpos_attention_f32tc.cu (K4, K5, K6, K7:
// three TF32 passes); the head notes of relpos_attention.cu and
// window_strip_attention.cu give the arithmetic. This file computes the same functions with the JAX rounding:
// scores and softmax in float32, p normalised in float32 and then rounded
// to the activation dtype, p . v accumulated in float32.
//
// Element types. Every body is templated on its 16-bit element type T,
// __nv_bfloat16 or __half (`Half2<T>`, tensor_core.cuh): JAX rounds
// float16 where it rounds bf16 (Precision.HIGHEST is for float32 only;
// products accumulate in float32; p and K6's bias halves are rounded to
// the input dtype), so a float16 kernel is the bf16 one with `.f16` in
// its mma.sync and wgmma products and float16 roundings. Both have the
// same instances.
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
// slice rh[y] (rw[x]) on the float64 tensor cores (mma.sync m8n8k4), each
// half's exact sum correctly rounded to the dtype (ROADMAP C13). q and the
// tables are read from device memory (staging them would cost the shared
// memory that lets two blocks share an SM at hd 80) in 4-byte loads, each
// lane's depth slot a run of dims in both operands.
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
// tile, and bw[i, x] is read as bf16 pairs. Other grids compute each
// key's (y, x) from its index (padding keys score -inf), with the block's
// bias rows in shared memory where they fit beside q and the stages (a
// 128 x 128 grid at hd 64), else read in place from device memory, where
// the 192 rows' halves stay in L2 (at hd 80); a grid-row grid whose bias
// rows do not fit takes that general path. No grid asks for more than the
// 227 KB a block may have. TMA loads from a producer warp and warpgroup
// ping-pong are later work (ROADMAP queue D).
//
// Head widths. hd 64 and 80 (ViT-B/L and ViT-H) have instances of their
// own (relpos_attention_tc.cu). Every other multiple of 8 from 8 to 128
// runs an instance at a padded width, 32, 96 or 128 (`PAD`, compiled apart
// in relpos_attention_tc_pad.cu so that the two build in parallel): the
// rows hold hd dims, their columns past hd load as zeros (cp.async's zero
// fill, zero q fragments), which add nothing to q . k, and the output
// columns past hd are not stored; the scale is the true hd^-1/2. At 96 and
// 128, K4 takes 2 warpgroups (128 query rows) so that its output
// accumulators fit in registers, p . v is two wgmma products (64 + 32 or
// 64 + 64 columns), and the window body forms p . v in two column parts.
// These instances are right first; their speed is later work.
#pragma once

#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// The wgmma products below write their element type's name ("bf16" or
// "f16") into one instruction text.
#define DLIMG_WGMMA_SS_64x64(TY)                                                              \
  asm volatile(                                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "     \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                                         \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),          \
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),          \
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),          \
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),          \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),          \
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),          \
        "+f"(d[7][2]), "+f"(d[7][3])                                                        \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))

#define DLIMG_WGMMA_RS_N64(TY)                                                                \
  asm volatile(                                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "    \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                           \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),          \
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),          \
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),          \
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),          \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),          \
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),          \
        "+f"(d[7][2]), "+f"(d[7][3])                                                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

#define DLIMG_WGMMA_RS_N80(TY)                                                                \
  asm volatile(                                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n80k16.f32." TY "." TY " "                             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "     \
      " %32, %33, %34, %35, %36, %37, %38, %39}, "                                            \
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"                                           \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),          \
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),          \
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),          \
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),          \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),          \
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),          \
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),          \
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

#define DLIMG_WGMMA_RS_N32(TY)                                                                \
  asm volatile(                                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "                             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "              \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                                           \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),          \
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),          \
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),          \
        "+f"(d[3][3])                                                                       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

template <typename T>
constexpr bool kIsF16 = std::is_same<T, __half>::value;

// d (+)= a . b for a 64 x 64 x 16 tile of the warpgroup, a and b K-major
// in shared memory, elements of type T; d in the mma.sync C layout for
// each warp's 16 rows, d[i] covering columns 8i .. 8i + 7.
template <typename T>
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[8][4], uint64_t desc_a,
                                               uint64_t desc_b, int accumulate) {
  if constexpr (kIsF16<T>) {
    DLIMG_WGMMA_SS_64x64("f16");
  } else {
    DLIMG_WGMMA_SS_64x64("bf16");
  }
}

// Output tiles T0 .. N - 1 of d (8 columns a tile) as an array of their own.
template <int T0, int N>
__device__ __forceinline__ float (&tiles_from(float (&d)[N][4]))[N - T0][4] {
  return *reinterpret_cast<float(*)[N - T0][4]>(&d[T0]);
}

// d += a . b for a 64 x N x 16 tile of the warpgroup (N = 32, 64, 80, 96
// or 128, the head width), a (this warp's 16 rows, the mma.sync A-fragment
// layout) in registers, b MN-major (transposed) in shared memory, elements
// of type T. N = 96 and 128 are two products: columns 0 .. 63, then the
// rest from the core matrix 8 columns on (core matrices lie 128 bytes
// apart along N, so the descriptor's address moves 1024 bytes).
template <typename T, int N>
__device__ __forceinline__ void wgmma_64xNx16_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  if constexpr (N == 96) {
    wgmma_64xNx16_rs<T, 64>(*reinterpret_cast<float(*)[8][4]>(&d[0]), a, desc_b);
    wgmma_64xNx16_rs<T, 32>(tiles_from<8>(d), a, desc_b + 64);
  } else if constexpr (N == 128) {
    wgmma_64xNx16_rs<T, 64>(*reinterpret_cast<float(*)[8][4]>(&d[0]), a, desc_b);
    wgmma_64xNx16_rs<T, 64>(tiles_from<8>(d), a, desc_b + 64);
  } else if constexpr (N == 64) {
    if constexpr (kIsF16<T>) {
      DLIMG_WGMMA_RS_N64("f16");
    } else {
      DLIMG_WGMMA_RS_N64("bf16");
    }
  } else if constexpr (N == 80) {
    if constexpr (kIsF16<T>) {
      DLIMG_WGMMA_RS_N80("f16");
    } else {
      DLIMG_WGMMA_RS_N80("bf16");
    }
  } else {
    static_assert(N == 32, "head widths 32, 64, 80, 96 and 128");
    if constexpr (kIsF16<T>) {
      DLIMG_WGMMA_RS_N32("f16");
    } else {
      DLIMG_WGMMA_RS_N32("bf16");
    }
  }
}

#undef DLIMG_WGMMA_SS_64x64
#undef DLIMG_WGMMA_RS_N64
#undef DLIMG_WGMMA_RS_N80
#undef DLIMG_WGMMA_RS_N32

template <int C>
__device__ __forceinline__ void fence_operands(uint32_t (&r)[C][4]) {
#pragma unroll
  for (int i = 0; i < C; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// ---------------------------------------------------------------------------
// K5, K7 and K6: windows, one block per group (a head of a window)
// ---------------------------------------------------------------------------

constexpr int kWinThreads = 128;  // 4 warps, each taking 16-row stripes in turn

// The bias halves of the window body, in shared memory as 16-bit rows of
// kBiasCols: a query row's [bh (16 columns) | bw (16)], and a key's one-hot
// [ky | 16 + kx] (zero past n), so that the bias is two more depth steps
// of the score product (`window_tc_body`). Windows of up to 16 x 16.
constexpr int kBiasSide = 16;
constexpr int kBiasCols = 2 * kBiasSide + 8;  // + 8: 16-byte rows on distinct banks

// Where a group of K5 or K7 keeps its rows: q, k, v and out rows r at
// r * hd from their pointers (hd = HD, or with PAD the rows' own head width:
// `HeadWidth`); the caller's bias halves, n x (gh + gw); elements of type T.
template <typename T, int HD, bool PAD>
struct DenseRows : HeadWidth<HD, PAD> {
  using Elem = T;
  const T* q;
  const T* k;
  const T* v;
  T* out;
  const T* bhw;

  __device__ __forceinline__ size_t in(int r) const {
    return static_cast<size_t>(r) * this->width();
  }
  __device__ __forceinline__ size_t out_off(int r) const { return in(r); }

  // The kept rows' bias halves, zero-padded to 16 columns each.
  __device__ __forceinline__ void stage_bias(T* ba, int nq, int gh, int gw, int tid, int,
                                             int) const {
    const int ghw = gh + gw;
    for (int e = tid; e < nq * kBiasSide; e += kWinThreads) {
      const int r = e / kBiasSide, c = 2 * (e - r * kBiasSide);  // c, c + 1 < 32
      const int half = c / kBiasSide, cc = c - half * kBiasSide;
      const int lim = half ? gw : gh;
      const T* src = bhw + static_cast<size_t>(r) * ghw + (half ? gh : 0) + cc;
      const T zero = from_float<T>(0.f);
      typename Half2<T>::Pair w;
      w.x = cc < lim ? src[0] : zero;
      w.y = cc + 1 < lim ? src[1] : zero;
      *reinterpret_cast<typename Half2<T>::Pair*>(ba + r * kBiasCols + c) = w;
    }
  }
};

// c (8 x 8) += a (8 x 4) . b (4 x 8) in float64 on the tensor cores
// (mma.sync m8n8k4): lane (g, t) = (lane / 4, lane % 4) holds a[g][t],
// b[t][g] and c[g][2t], c[g][2t + 1].
__device__ __forceinline__ void mma_f64(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// float64 x rounded to odd in float32 (toward zero, the last bit set when
// inexact): its rounding to a 16-bit type is the correct rounding of x.
__device__ __forceinline__ float round_to_odd(double x) {
  float f = __double2float_rz(x);
  if (static_cast<double>(f) != x) f = __uint_as_float(__float_as_uint(f) | 1u);
  return f;
}

// K6's group: the ws x ws tokens of one window of a padded (B, hp, wp, *)
// grid, read in place. Token t of the window is t / ws rows and t % ws
// columns from its first token; q, k, v rows are `ts` elements apart (3C
// for the channel slices of the qkv output), out rows `c`. Each pointer is
// at the window's first token and the head's first channel; the tables are
// (ws, ws, hd).
template <typename T, int HD, bool PAD>
struct WindowRows : HeadWidth<HD, PAD> {
  using Elem = T;
  const T* q;
  const T* k;
  const T* v;
  T* out;
  const T* rh;  // gathered (ws, ws, HD) tables
  const T* rw;
  int ws, wp, ts, c;

  __device__ __forceinline__ size_t tok(int t) const {
    const int y = t / ws;
    return static_cast<size_t>(y) * wp + (t - y * ws);
  }
  __device__ __forceinline__ size_t in(int r) const { return tok(r) * ts; }
  __device__ __forceinline__ size_t out_off(int r) const { return tok(r) * c; }

  // The bias halves of every row, as the TPU kernel defines them: bh[i, y]
  // = q_i . rh[y_i, y] and bw[i, x] = q_i . rw[x_i, x], each the sum of its
  // products correctly rounded to the dtype (JAX's bh.astype(qn.dtype) of
  // the exact sum, as the plain version rounds it; a float32 sum, in each
  // implementation's own order, rounds to the other side of a midpoint now
  // and then and moves a row's logits by a step of the bias: ROADMAP C13).
  // Step u of a warp takes the ws tokens of window row u against rh[u]
  // (their bh) and those of window column u against rw[u] (their bw): two
  // 16 x 16 tiles, each four 8 x 8 tiles of float64 mma.sync over the
  // depth, whose sums of 16-bit products are exact; lane slot t of a step
  // holds dims t hd / 4 + s, s + 1 (a sum's order does not matter), the
  // columns past ws written as zeros, tile rows past ws repeating row ws -
  // 1 and dropped.
  __device__ __forceinline__ void stage_bias(T* ba, int, int, int, int, int warp,
                                             int lane) const {
    using H = Half2<T>;
    const int gr = lane >> 2, gq = lane & 3;
    const int hd = this->width(), kq = hd / 4;  // a lane slot's dims (a multiple of 2)
    for (int u = warp; u < ws; u += kWinThreads / 32) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // bh, bw
        const T* tab = (h ? rw : rh) + static_cast<size_t>(u) * ws * hd;
        const T* a[2];
        const T* b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = min(8 * i + gr, ws - 1);
          a[i] = q + in(h ? m * ws + u : u * ws + m) + gq * kq;
          b[i] = tab + static_cast<size_t>(m) * hd + gq * kq;
        }
        double c[2][2][2] = {};  // [token tile][column tile][fragment]
        for (int d = 0; d < kq; d += 2) {
          const uint32_t wa[2] = {ldg_u32(a[0] + d), ldg_u32(a[1] + d)};
          const uint32_t wb[2] = {ldg_u32(b[0] + d), ldg_u32(b[1] + d)};
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 2; ++j)
                mma_f64(c[i][j], e ? H::hi(wa[i]) : H::lo(wa[i]), e ? H::hi(wb[j]) : H::lo(wb[j]));
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = 8 * i + gr;
          if (m >= ws) continue;
          T* row = ba + (h ? m * ws + u : u * ws + m) * kBiasCols + h * kBiasSide;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = 8 * j + 2 * gq;
            st_u32(row + col, H::pack(col < ws ? round_to_odd(c[i][j][0]) : 0.f,
                                      col + 1 < ws ? round_to_odd(c[i][j][1]) : 0.f));
          }
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
// for the folded one (the halves divided by scale). With Rows::kPad the
// rows hold hd < HD dims (a padded instance): columns past hd of q, K and V
// are zeros in registers and shared memory, so they add nothing to q . k,
// and the output columns past hd are not stored. Above hd 80, p . v runs in
// two column parts (the score row stays in registers and p is formed again
// for the second), so that its accumulators fit beside the score row.
template <int HD, int NP, class Rows>
__device__ __forceinline__ void window_tc_body(unsigned char* smem_raw, const Rows& g,
                                               const int n, const int gh, const int gw,
                                               const int nq, const float alpha,
                                               const float gamma) {
  using T = typename Rows::Elem;
  using H = Half2<T>;
  constexpr bool PAD = Rows::kPad;
  constexpr int OP = HD > 80 ? 2 : 1;  // column parts of p . v
  constexpr int PW = HD / OP;          // columns a part
  static_assert(HD % 16 == 0 && NP % 16 == 0 && PW % 16 == 0, "tiles of 16");
  static_assert(PW / 2 <= kBiasCols, "a half output row fits a bias row");
  constexpr int KS = HD + 8;       // shared row stride (elements)
  constexpr int KSTEPS = HD / 16;  // depth steps of q . k
  constexpr int NT = NP / 8;       // 8-key tiles of a score row
  constexpr int DT = PW / 8;       // 8-column tiles of a part of the output
  constexpr int CPR = HD / 8;      // 16-byte chunks of a row
  constexpr int BS = kBiasCols;
  const int hd = g.width();
  T* ks = reinterpret_cast<T*>(smem_raw);  // NP x KS
  T* vs = ks + NP * KS;                    // NP x KS
  T* oh = vs + NP * KS;                    // NP x BS: keys' one-hot rows
  T* ba = oh + NP * BS;                    // NP x BS: rows' bias halves (nq staged)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, gq = lane & 3;

  for (int e = tid; e < NP * CPR; e += kWinThreads) {
    const int r = e / CPR, c = (e - r * CPR) * 8;
    const bool ok = r < n && (!PAD || c < hd);
    const size_t off = PAD ? (ok ? g.in(r) + c : 0) : g.in(ok ? r : 0) + c;
    cp_async16(ks + r * KS + c, g.k + off, ok);
    cp_async16(vs + r * KS + c, g.v + off, ok);
  }
  cp_async_commit();
  for (int e = tid; e < NP * kBiasSide; e += kWinThreads) {  // one-hot pairs
    const int j = e / kBiasSide, c = 2 * (e - j * kBiasSide);
    const int ky = j / gw, hit = c < kBiasSide ? ky : kBiasSide + j - ky * gw;
    const uint32_t one = H::kOne;  // 1.0 in the dtype
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
      for (int dt = 0; dt < OP * DT; ++dt) {
        const int c = 8 * dt + 2 * gq;
        if (PAD && 8 * dt >= hd) continue;
        if (r0 < n) st_u32(g.out + g.out_off(r0) + c, 0u);
        if (r1 < n) st_u32(g.out + g.out_off(r1) + c, 0u);
      }
      continue;
    }
    // q fragments straight from device memory (rows past n repeat row n - 1;
    // their results are never stored).
    uint32_t qa[KSTEPS][4];
    {
      const T* q0 = g.q + g.in(min(r0, n - 1)) + 2 * gq;
      const T* q1 = g.q + g.in(min(r1, n - 1)) + 2 * gq;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const bool lo = !PAD || 16 * kk < hd, hi = !PAD || 16 * kk + 8 < hd;
        qa[kk][0] = lo ? ldg_u32(q0 + 16 * kk) : 0u;
        qa[kk][1] = lo ? ldg_u32(q1 + 16 * kk) : 0u;
        qa[kk][2] = hi ? ldg_u32(q0 + 16 * kk + 8) : 0u;
        qa[kk][3] = hi ? ldg_u32(q1 + 16 * kk + 8) : 0u;
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
        H::mma(s[2 * jp], qa[kk], b[0], b[1]);
        H::mma(s[2 * jp + 1], qa[kk], b[2], b[3]);
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
        H::mma(s[2 * jp], a, b[0], b[1]);
        H::mma(s[2 * jp + 1], a, b[2], b[3]);
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

    // p rounded to the dtype, straight into the A fragments of p . v; output
    // columns part * PW .. part * PW + PW - 1.
#pragma unroll
    for (int part = 0; part < OP; ++part) {
      float o[DT][4];
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        const uint32_t pa[4] = {H::pack(s[2 * kk][0] * i0, s[2 * kk][1] * i0),
                                H::pack(s[2 * kk][2] * i1, s[2 * kk][3] * i1),
                                H::pack(s[2 * kk + 1][0] * i0, s[2 * kk + 1][1] * i0),
                                H::pack(s[2 * kk + 1][2] * i1, s[2 * kk + 1][3] * i1)};
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t b[4];
          ldsm_x4_trans(b, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * KS +
                               part * PW + 16 * dp + (lane >> 4) * 8);
          H::mma(o[2 * dp], pa, b[0], b[1]);
          H::mma(o[2 * dp + 1], pa, b[2], b[3]);
        }
      }
      // The output tile goes out through this stripe's bias rows (read above
      // and by no other warp), PW / 2 columns at a time, so that each store
      // writes 16-byte chunks of 8 rows. (K6's output rows lie C apart, and
      // 4-byte stores straight from the accumulators were a large share of
      // its time.)
      constexpr int HW = PW / 2, CH = HW / 8;  // columns, 16-byte chunks a half row
      T* stage = ba + 16 * st * BS;
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int dt = h * DT / 2; dt < (h + 1) * DT / 2; ++dt) {
          const int c = 8 * dt - h * HW + 2 * gq;
          st_u32(stage + gr * BS + c, r0 < nq ? H::pack(o[dt][0], o[dt][1]) : 0u);
          st_u32(stage + (gr + 8) * BS + c, r1 < nq ? H::pack(o[dt][2], o[dt][3]) : 0u);
        }
        __syncwarp();
#pragma unroll
        for (int e = lane; e < 16 * CH; e += 32) {
          const int rr = e / CH, c = (e - rr * CH) * 8, r = 16 * st + rr;
          const int col = part * PW + h * HW + c;
          if (r < n && (!PAD || col < hd))
            *reinterpret_cast<uint4*>(g.out + g.out_off(r) + col) =
                *reinterpret_cast<const uint4*>(stage + rr * BS + c);
        }
        __syncwarp();
      }
    }
  }
}

// Three entry kernels over one body, so that a profile tells K5, K7 and K6
// apart. K5: group g's rows at g * n, folded or plain bias, pad-query skip.
template <typename T, int HD, int NP, bool PAD>
__global__ void __launch_bounds__(kWinThreads, 2) relpos_window_kernel_tc(RelposArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, g = blockIdx.x;
  const size_t hd = PAD ? a.hd : HD;
  const size_t base = static_cast<size_t>(g) * n;
  const DenseRows<T, HD, PAD> rows{{a.hd},
                                   static_cast<const T*>(a.q) + base * hd,
                                   static_cast<const T*>(a.k) + base * hd,
                                   static_cast<const T*>(a.v) + base * hd,
                                   static_cast<T*>(a.out) + base * hd,
                                   static_cast<const T*>(a.bhw) + base * (a.gh + a.gw)};
  const int nq = g >= a.g_skip ? min(a.n_valid, n) : n;  // rows whose output is kept
  window_tc_body<HD, NP>(smem_raw, rows, n, a.gh, a.gw, nq, a.folded ? 1.f : a.scale,
                         a.folded ? a.scale * kLog2e : kLog2e);
}

// K7: group g = (window w, head h) reads q, k, v in place from the
// (W, 3, nh, n, HD) qkv at w 3 nh n + h n and one and two nh n further;
// output and bias halves at g * n. Plain bias, every row kept.
template <typename T, int HD, int NP, bool PAD>
__global__ void __launch_bounds__(kWinThreads, 2) relpos_qkv_kernel_tc(RelposArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, nh = a.qkv_heads, g = blockIdx.x;
  const size_t hd = PAD ? a.hd : HD;
  const size_t hn = static_cast<size_t>(nh) * n;
  const size_t qbase = static_cast<size_t>(g / nh) * 3 * hn + static_cast<size_t>(g % nh) * n;
  const size_t base = static_cast<size_t>(g) * n;
  const T* qkv = static_cast<const T*>(a.q);
  const DenseRows<T, HD, PAD> rows{{a.hd}, qkv + qbase * hd, qkv + (qbase + hn) * hd,
                                   qkv + (qbase + 2 * hn) * hd, static_cast<T*>(a.out) + base * hd,
                                   static_cast<const T*>(a.bhw) + base * (a.gh + a.gw)};
  window_tc_body<HD, NP>(smem_raw, rows, n, a.gh, a.gw, n, a.scale, kLog2e);
}

// K6: block g = ((b, wy, wx) window, head), head fastest; every token of
// the padded grid is a query and a key (no skip), the bias halves are
// computed in the block.
template <typename T, int HD, int NP, bool PAD>
__global__ void __launch_bounds__(kWinThreads, 2) window_strip_kernel_tc(StripArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ws = a.ws, nwx = a.wp / ws, nwy = a.hp / ws;
  const int head = blockIdx.x % a.nh, win = blockIdx.x / a.nh;
  const int wx = win % nwx, wy = (win / nwx) % nwy, b = win / (nwx * nwy);
  const size_t hd = PAD ? a.c / a.nh : HD;
  const size_t tok0 = (static_cast<size_t>(b) * a.hp + wy * ws) * a.wp + wx * ws;
  const size_t in0 = tok0 * a.ts + static_cast<size_t>(head) * hd;
  const size_t out0 = tok0 * a.c + static_cast<size_t>(head) * hd;
  const WindowRows<T, HD, PAD> rows{{static_cast<int>(hd)},
                                    static_cast<const T*>(a.q) + in0,
                                    static_cast<const T*>(a.k) + in0,
                                    static_cast<const T*>(a.v) + in0,
                                    static_cast<T*>(a.out) + out0,
                                    static_cast<const T*>(a.rh),
                                    static_cast<const T*>(a.rw),
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
  const size_t smem = 2 * 2 * NP * (HD + 8 + kBiasCols);  // 2-byte elements
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), kWinThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD, int NP, bool PAD>
cudaError_t launch_relpos_window_tc(const RelposArgs& a, int g, cudaStream_t stream) {
  return a.qkv_heads > 0
             ? launch_window_tc<HD, NP>(&relpos_qkv_kernel_tc<T, HD, NP, PAD>, a, g, stream)
             : launch_window_tc<HD, NP>(&relpos_window_kernel_tc<T, HD, NP, PAD>, a, g, stream);
}

// ---------------------------------------------------------------------------
// K4: global blocks; 3 warpgroups of 64 query rows, 64-key tiles streamed
// twice, q . k on wgmma one tile ahead of the softmax
// ---------------------------------------------------------------------------

constexpr int kGlbBK = 64;                 // keys a tile
constexpr int kGlbStages = 5;              // K tiles, and V tiles, in shared memory
constexpr int kGlbAhead = kGlbStages - 1;  // tiles loaded ahead of the one read

// Row stride (elements) of the block's 16-bit bias halves in shared memory:
// 16-byte rows of more than ghw columns and a word stride of 4 mod 32, so
// that the bw pairs of a warp (8 rows x 4 lanes) fall on 32 banks.
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
  // Warpgroups a block: 3 (192 query rows), or 2 above hd 80, whose output
  // accumulators would not fit in the registers of 3.
  static constexpr int GROUPS = HD > 80 ? 2 : 3;
  static constexpr int THREADS = 128 * GROUPS;
  static constexpr int BM = 64 * GROUPS;      // query rows a block
  static constexpr int TILE = kGlbBK * HD;    // a K or V tile in core matrices
  static constexpr int Q_ROWS = BM * HD;      // the block's q rows in core matrices
  // q, the stages and, with bias_smem, the block's bias rows.
  __host__ __device__ static size_t bytes(int ghw, bool bias_smem) {
    return sizeof(bf16) * (Q_ROWS + 2 * kGlbStages * TILE +
                           (bias_smem ? static_cast<size_t>(BM) * glb_bias_stride(ghw) : 0));
  }
  // Whether the bias rows fit in shared memory beside q and the stages.
  __host__ __device__ static bool bias_fits(int ghw) { return bytes(ghw, true) <= kMaxSmem; }
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
// every warpgroup retired before this step's barrier. With PAD, rows of
// hd < HD dims (a padded instance): q, K and V columns past hd load as zeros.
template <typename T, int HD, bool GRID_ROW, bool PAD>
struct GlobalCtx {
  using L = GlbLayout<HD>;
  using H = Half2<T>;
  static constexpr int CPR = HD / 8;
  T* ks;           // kGlbStages K tiles
  T* vs;           // kGlbStages V tiles
  const T* b0r;    // bias halves of this lane's two rows (shared or device memory)
  const T* b1r;
  const T* k;
  const T* v;
  uint64_t desc_q;    // this warpgroup's 64 q rows
  int n, n_tiles, gh, gw, tid, lane;
  float scale;
  float inv_gw;       // 1 / gw (general grids)
  int hd;             // the rows' head width (HD unless PAD)

  // K or V tile t into its stage as wgmma's core matrices (key r, dims
  // 8c .. 8c + 7 at chunk core_chunk(r, c)); consecutive threads write
  // consecutive 16-byte chunks. K is read K-major, V MN-major.
  __device__ __forceinline__ void load_tile(T* stages, const T* src, int t) const {
    T* dst = stages + (t % kGlbStages) * L::TILE;
    for (int e = tid; e < kGlbBK * CPR; e += L::THREADS) {
      const int key = t * kGlbBK + (e >> 3) / CPR * 8 + (e & 7);
      const int col = (e >> 3) % CPR * 8;
      if constexpr (PAD) {
        const bool ok = key < n && col < hd;
        cp_async16(dst + e * 8, src + (ok ? static_cast<size_t>(key) * hd + col : 0), ok);
      } else {
        const bool ok = key < n;
        cp_async16(dst + e * 8, src + static_cast<size_t>(ok ? key : 0) * HD + col, ok);
      }
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
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_64x64x16<T>(s, desc_q + 16 * kk, desc_k + 16 * kk, kk);
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
        s[j][0] = fmaf(s[j][0], scale, H::lo(w0));
        s[j][1] = fmaf(s[j][1], scale, H::hi(w0));
        s[j][2] = fmaf(s[j][2], scale, H::lo(w1));
        s[j][3] = fmaf(s[j][3], scale, H::hi(w1));
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = t * kGlbBK + 8 * j + 2 * gq + e;
          const bool ok = key < n;
          const int kk = ok ? key : n - 1;
          // kk / gw: (kk + 1/2) / gw is at least 1 / (2 gw) from an integer,
          // and the float32 product errs by less for kk below 2^22.
          const int ky = __float2int_rz((static_cast<float>(kk) + 0.5f) * inv_gw);
          const int kx = gh + kk - ky * gw;
          s[j][e] = ok ? fmaf(s[j][e], scale, to_float(b0r[ky]) + to_float(b0r[kx]))
                       : -INFINITY;
          s[j][2 + e] = ok ? fmaf(s[j][2 + e], scale, to_float(b1r[ky]) + to_float(b1r[kx]))
                           : -INFINITY;
        }
      }
    }
  }

  __device__ __forceinline__ void row_half(int t, float& h0, float& h1) const {
    if constexpr (GRID_ROW) {  // tile t is grid row t
      h0 = to_float(b0r[t]);
      h1 = to_float(b1r[t]);
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
  // log2 l (so p is normalised), rounded to the dtype straight into the A
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
        pa[kk][2 * hi] = H::pack(ex2(fmaf(r[0], kLog2e, c0)), ex2(fmaf(r[1], kLog2e, c0)));
        pa[kk][2 * hi + 1] = H::pack(ex2(fmaf(r[2], kLog2e, c1)), ex2(fmaf(r[3], kLog2e, c1)));
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
    for (int kk = 0; kk < 4; ++kk) wgmma_64xNx16_rs<T, HD>(o, pa[kk], desc_v + 2 * HD * kk);
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

template <typename T, int HD, bool GRID_ROW, bool PAD>
__global__ void __launch_bounds__(GlbLayout<HD>::THREADS, 1) relpos_global_kernel_tc(RelposArgs a) {
  static_assert(HD % 16 == 0, "head width must be a multiple of 16");
  using L = GlbLayout<HD>;
  using H = Half2<T>;
  constexpr int CPR = HD / 8;
  constexpr int kGlbBM = L::BM, kGlbThreads = L::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // kGlbBM q rows, core matrices
  T* ks = qs + L::Q_ROWS;                  // kGlbStages K tiles
  T* vs = ks + kGlbStages * L::TILE;       // kGlbStages V tiles
  T* bs = vs + kGlbStages * L::TILE;       // kGlbBM x bstr bias halves
  const int n = a.n, gh = a.gh, ghw = gh + a.gw;
  const int bstr = glb_bias_stride(ghw);
  // The bias rows in shared memory where they fit (always on a grid-row
  // grid: its launcher takes the general kernel otherwise), else in place.
  const bool bias_smem = GRID_ROW || L::bias_fits(ghw);

  const int g = blockIdx.y, q0 = blockIdx.x * kGlbBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hd = PAD ? a.hd : HD;
  const size_t base = static_cast<size_t>(g) * n;
  const T* q = static_cast<const T*>(a.q) + base * hd;
  const T* bhw = static_cast<const T*>(a.bhw) + (base + q0) * ghw;
  T* out = static_cast<T*>(a.out) + base * hd;
  const int n_tiles = (n + kGlbBK - 1) / kGlbBK;
  const int rows = min(kGlbBM, n - q0);      // the block's query rows below n
  const int r0 = warp * 16 + (lane >> 2);  // this lane's rows in the block: r0, r0 + 8
  // In place, rows past n repeat row n - 1 (their results are never stored).
  const T* b0r = bias_smem ? bs + r0 * bstr : bhw + min(r0, rows - 1) * ghw;
  const T* b1r = bias_smem ? bs + (r0 + 8) * bstr : bhw + min(r0 + 8, rows - 1) * ghw;

  const GlobalCtx<T, HD, GRID_ROW, PAD> c{
      ks, vs, b0r, b1r,
      static_cast<const T*>(a.k) + base * hd, static_cast<const T*>(a.v) + base * hd,
      gmma_desc(qs + (warp >> 2) * 64 * HD, 128, 16 * HD), n, n_tiles, gh, a.gw, tid, lane,
      a.scale, 1.f / static_cast<float>(a.gw), hd};

  // The first load group: the block's q rows and bias halves (16-byte
  // chunks where the rows allow), then K tiles 0 .. kGlbAhead - 1.
  for (int e = tid; e < kGlbBM * CPR; e += kGlbThreads) {
    const int r = e / CPR, col = e - r * CPR;
    if constexpr (PAD) {
      const bool ok = q0 + r < n && col * 8 < hd;
      cp_async16(qs + core_chunk<HD>(r, col) * 8,
                 q + (ok ? static_cast<size_t>(q0 + r) * hd + col * 8 : 0), ok);
    } else {
      const bool ok = q0 + r < n;
      cp_async16(qs + core_chunk<HD>(r, col) * 8,
                 q + static_cast<size_t>(ok ? q0 + r : 0) * HD + col * 8, ok);
    }
  }
  if (bias_smem) {
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
    if (PAD && 8 * dt >= hd) continue;
    if (row0 < n)
      st_u32(out + static_cast<size_t>(row0) * hd + col, H::pack(acc.o[dt][0], acc.o[dt][1]));
    if (row1 < n)
      st_u32(out + static_cast<size_t>(row1) * hd + col, H::pack(acc.o[dt][2], acc.o[dt][3]));
  }
}

// A grid-row grid whose bias rows do not fit in shared memory takes the
// general kernel, which reads them in place, so no launch asks for more
// than kMaxSmem (q and the stages alone take 104 KB at hd 64, 130 KB at hd
// 80). The general kernel's keys are below 2^22 (the index arithmetic of
// `add_bias`).
template <typename T, int HD, bool GRID_ROW, bool PAD>
cudaError_t launch_global_tc(const RelposArgs& a, int g, cudaStream_t stream) {
  using L = GlbLayout<HD>;
  const int ghw = a.gh + a.gw;
  if constexpr (GRID_ROW) {
    if (!L::bias_fits(ghw)) return launch_global_tc<T, HD, false, PAD>(a, g, stream);
  }
  if (!GRID_ROW && a.n >= (1 << 22)) return cudaErrorInvalidValue;
  auto kernel = &relpos_global_kernel_tc<T, HD, GRID_ROW, PAD>;
  const size_t smem = L::bytes(ghw, GRID_ROW || L::bias_fits(ghw));
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.n + L::BM - 1) / L::BM, g);
  kernel<<<grid, L::THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// K4 at head width HD (rows of a.hd dims with PAD): a key tile is one grid
// row when gw == 64; gh even keeps the bw pairs 4-byte aligned in shared
// memory.
template <typename T, int HD, bool PAD>
cudaError_t global_tc(const RelposArgs& a, int g, cudaStream_t stream) {
  const bool row = a.gw == kGlbBK && a.gh % 2 == 0;
  return row ? launch_global_tc<T, HD, true, PAD>(a, g, stream)
             : launch_global_tc<T, HD, false, PAD>(a, g, stream);
}

// K5 / K7 at head width HD: windows of up to 16 x 16, score rows of 208
// keys up to 208 (14 x 14 windows: 13 stripes), else 256.
template <typename T, int HD, bool PAD>
cudaError_t windowed_tc(const RelposArgs& a, int g, cudaStream_t stream) {
  if (a.gh > kBiasSide || a.gw > kBiasSide) return cudaErrorInvalidValue;
  return a.n <= 208 ? launch_relpos_window_tc<T, HD, 208, PAD>(a, g, stream)
                    : launch_relpos_window_tc<T, HD, 256, PAD>(a, g, stream);
}

// K6 at head width HD: windows of up to 14 x 14 tokens (the caller checks
// ws * ws <= 208).
template <typename T, int HD, bool PAD>
cudaError_t strip_tc(const StripArgs& a, int batch, cudaStream_t stream) {
  if (a.ws > 14) return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(batch) * (a.hp / a.ws) * (a.wp / a.ws) * a.nh;
  return launch_window_tc<HD, 208>(&window_strip_kernel_tc<T, HD, 208, PAD>, a, blocks, stream);
}

// The instances of element type T at hd 64 and 80 (the ViTs' widths), and
// at a padded width (every other multiple of 8 up to 128). Each
// relpos_attention_tc*.cu file compiles one element type at one of the two
// sets of widths, so that the four build in parallel.
template <typename T>
cudaError_t global_at_instance_width(const RelposArgs& a, int g, int hd, cudaStream_t s) {
  return hd == 64 ? global_tc<T, 64, false>(a, g, s) : global_tc<T, 80, false>(a, g, s);
}

template <typename T>
cudaError_t windowed_at_instance_width(const RelposArgs& a, int g, int hd, cudaStream_t s) {
  return hd == 64 ? windowed_tc<T, 64, false>(a, g, s) : windowed_tc<T, 80, false>(a, g, s);
}

template <typename T>
cudaError_t strip_at_instance_width(const StripArgs& a, int batch, int hd, cudaStream_t s) {
  return hd == 64 ? strip_tc<T, 64, false>(a, batch, s) : strip_tc<T, 80, false>(a, batch, s);
}

template <typename T>
cudaError_t global_at_padded_width(const RelposArgs& a, int g, int hd, cudaStream_t s) {
  switch (padded_head_width(hd)) {
    case 32: return global_tc<T, 32, true>(a, g, s);
    case 96: return global_tc<T, 96, true>(a, g, s);
    case 128: return global_tc<T, 128, true>(a, g, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t windowed_at_padded_width(const RelposArgs& a, int g, int hd, cudaStream_t s) {
  switch (padded_head_width(hd)) {
    case 32: return windowed_tc<T, 32, true>(a, g, s);
    case 96: return windowed_tc<T, 96, true>(a, g, s);
    case 128: return windowed_tc<T, 128, true>(a, g, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t strip_at_padded_width(const StripArgs& a, int batch, int hd, cudaStream_t s) {
  switch (padded_head_width(hd)) {
    case 32: return strip_tc<T, 32, true>(a, batch, s);
    case 96: return strip_tc<T, 96, true>(a, batch, s);
    case 128: return strip_tc<T, 128, true>(a, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

}  // namespace dlimg
