// The general attention body for Hopper: every geometry of K2, K4, K5, K6
// and K7 that their tuned instances do not take. attention_general.cu
// instantiates it in bf16, attention_general_f16.cu in float16,
// attention_general_f32.cu in float32.
//
// The tuned instances (levit_attention_tc.cuh, levit_attention_f32tc.cu,
// relpos_attention_tc.cuh, relpos_attention_f32tc.cuh) are templated on the
// head width (kd 32; hd 64, 80 or padded to 32 / 96 / 128) and hold a whole
// score row of at most 208 or 256 keys in registers, with 16-byte rows.
// What they take is `attention_tuned` below, the rule the C entry points
// (levit_attention.cu, relpos_attention.cu, window_strip_attention.cu) and
// ops/flash_attention.py `attention_body` apply alike: every main path's
// shape is tuned. Everything else the JAX functions take comes here:
//   K2 (dlimgedit_tpu/ops/flash_attention.py:531 `levit_window_attention`)
//      at kd != 32 or N > 256 (TinyViT's 384 and 512 variants: windows of
//      576 and 1024 tokens);
//   K4 (:139 `_attention_grouped`), K5 (:307 `_attention_head_fused`), K7
//      (:382 `windowed_attention_qkv`) at head widths that are not a
//      multiple of 8 or above 128, and 16-bit K5 / K7 windows with a side
//      above 16 (the low-level wrappers; the routers send those to K4);
//   K6 (:646 `windowed_attention_fused`) at any head width and on windows
//      of more than 208 tokens.
// The arithmetic is each kernel's (the notes of levit_attention.cu,
// relpos_attention.cu and window_strip_attention.cu):
//   K2        s = (q . k) scale + bias[h, i, j]
//   K4/K5/K7  s = (q . k) scale + (bh[i, y_j] + bw[i, x_j])        plain
//             s = ((q . k) + (bh[i, y_j] + bw[i, x_j])) scale      folded
//   K6        s = ((q . k) scale + bh[i, y_j]) + bw[i, x_j], with
//             bh[i, y] = sum_d q_i[d] rh[y_i, y, d] rounded to the dtype
//             (bw alike from rw[x_i]), computed here: the sum in float64,
//             correctly rounded, as the plain version rounds it (a float32
//             sum, JAX's, rounds apart from it now and then: ROADMAP C13)
//   p = softmax_j(s), normalised in float32 and then rounded to the dtype;
//   out = p . v accumulated in float32, rounded to the dtype; K5's skipped
//   pad-query rows written as zeros.
//
// Design. A block owns (group, 64 query rows, one part of the output
// columns) and runs 4 warps, a warp a 16-row stripe (rows lane / 4 and + 8
// of the mma fragments); fewer warps only where K6's staged bias halves
// leave no room. Groups are on gridDim.x, so any count up to 2^31 - 1
// launches at once. The head width is a run-time value; an instance is
// templated on its output tiles NT (8-column tiles a part: 8, 16 or 32 in
// 16 bits, a whole head of up to 64, 128 or 256 columns a block; 8 or 16 in
// float32, wider heads in parts of 128 columns, each computing s again) and
// takes keys in chunks of KC (64; 32 where NT's accumulators are large, and
// for float32 K2).
//   Key pipeline. Each chunk's k (and v) rows go to shared memory by
//   cp.async (16, 8 or 4 bytes: the widest piece that every row start, the
//   head offsets and the token stride allow, `general_vec`; a 2-byte piece
//   (odd hd in 16 bits) is a plain load), into one of two stages, so that
//   chunk i + 1's copies are in flight while chunk i is computed: one
//   barrier a chunk. The pieces cover a row's padded depth, zeros past hd
//   and past n (the copies' zero fill), so no operand is padded or cast on
//   the host; each thread walks its pieces without a division a piece.
//   TMA is not used: its tiles want 16-byte strides and row pieces, and
//   these rows have 2-byte pieces and any stride.
//   Fragments. q is staged once (its depth up to 256 in 16 bits, 128 in
//   float32; deeper heads stage q and k a depth piece at a time in the
//   same stages). In 16 bits q, k and v fragments come by ldmatrix (.trans
//   for v) from rows padded by 16 bytes (no bank conflicts); float32 reads
//   its fragments and splits them for three TF32 passes (hi.hi + hi.lo +
//   lo.hi, as relpos_attention_f32tc.cuh describes).
//   Bias. K2's (bq x KC) tile of the head's table comes with the chunk's
//   copies; K4 / K5 / K7 stage the block's rows of the halves once (read in
//   place where bq (gh + gw) elements pass 48 KB); K6 computes its rows'
//   halves into shared memory after q has landed, while the first chunks'
//   copies are in flight (a float64 dot product a value). Each
//   chunk's keys' (y, x) are computed once a chunk, by the threads that
//   issue its copies; a score reads two staged halves and no division.
//   Softmax, 16 bits: JAX's rounding point, p = exp(s - m) / l normalised
//   with the row's final max and sum in float32, then rounded to the dtype,
//   then p . v in float32 (dlimgedit_tpu/ops/flash_attention.py:73-81,
//   :520-526, :622-628); the quotient as a division rounds it, from the
//   row's reciprocal and one FMA correction. Where the block's score rows
//   fit (n <= kScoreKeys),
//   s is computed once: the first pass over the keys stores the scores
//   (float32, bq x n) and takes each row's max and sum online; the second
//   streams v and forms p from the stored scores. Else the second pass
//   computes s again from k.
//   Softmax, float32: one pass of online softmax (rounding p to float32 is
//   the identity); each chunk's p . v starts from zero and joins o in one
//   rounded FMA (the tensor cores' float32 accumulation truncates:
//   relpos_attention_f32tc.cuh), o / l at the end.
//
// Occupancy at chip_smoke.py's GENERAL_* geometries (bf16; 132 SMs): K2
// (kd 32, N 1024: two passes) 320 blocks of 4 warps at 43 KB and at most
// 168 registers, three an SM, so all are resident at once (two or three an
// SM); K7 (hd 136, n 196: NT 32, the score path) 800 blocks at 100 KB, two
// an SM (2.3 waves of its 600 full blocks); K5 (hd 36, n 196) and K6 (hd
// 36, ws 16) 800 and 512 blocks at 92 KB, two an SM; K4 (hd 36, n 4096: two
// passes) 512 blocks at 53 KB and 128 registers, four an SM, one wave.
//
// What bounds it on an H100: at those geometries the bytes (K2, K5, K6,
// K7: the operands once and the output) or the products (K4), 3-34 us;
// the body reaches 3-9% of it. Measured by ablation
// (tools/time_general.py, bf16): the chunks' copies and the staging alone
// take 40-47% of K2, K5 and K7 (K2: its 64 x 1024 bias rows read from L2
// in both passes for each of 4 windows, 84 MB a launch), p . v 20-25% of
// K7, the bias 4-7% (K4: 42%), q . k about 10%; a third stage, 64-key
// chunks at hd 136 and blocks of 2 warps measured slower or no faster.
// The times are in PERF.md.
#pragma once

#include "tensor_core.cuh"

namespace dlimg {

// The kernels the body serves, as the route rule and the Python wrappers
// number them (ops/flash_attention.py ATTENTION_KERNELS).
enum AttentionKernel {
  kAttnLevit = 0,     // K2, levit_window_attention
  kAttnGlobal = 1,    // K4, relpos_attention_global
  kAttnWindowed = 2,  // K5, relpos_attention_windowed
  kAttnQkv = 3,       // K7, relpos_attention_qkv
  kAttnStrip = 4,     // K6, windowed_attention_fused
};

// The groups a tuned K4 / K5 / K7 launch puts on gridDim.y; the entry
// points split a larger count into launches of at most this many.
constexpr int kMaxGridY = 65535;

// Whether the tuned instances take this geometry (else the general body
// runs). n: tokens of a group; gh, gw: K4-K7's grid, K6's window (ws, ws);
// heads: K7's heads. Tuned: K2 at kd 32 and N <= 256; K4-K7 at hd a
// multiple of 8 up to 128; 16-bit K5 / K7 windows with sides up to 16
// (float32 any); K6 windows of up to 208 tokens; K7 with at most kMaxGridY
// heads (its launches are split by whole windows).
inline bool attention_tuned(int kernel, int dtype, int hd, int n, int gh, int gw, int heads) {
  if (kernel == kAttnLevit) return hd == 32 && n > 0 && n <= 256;
  if (hd < 8 || hd > 128 || hd % 8 != 0) return false;
  if (kernel == kAttnWindowed || kernel == kAttnQkv) {
    if (dtype != kDtypeF32 && (gh > 16 || gw > 16)) return false;
    if (kernel == kAttnQkv && heads > kMaxGridY) return false;
  }
  if (kernel == kAttnStrip) return static_cast<long long>(gh) * gw <= 208;
  return true;
}

// The general body's bias policies, each with where a group's rows lie:
// K2's (nh, n, n) table; K4 / K5 / K7's halves (K7: q, k, v inside the
// (W, 3, nh, n, hd) qkv, a.nh > 0); K6's halves computed from rh and rw.
enum GeneralPolicy { kGenLevit = 0, kGenRelpos = 1, kGenStrip = 2 };

struct GeneralArgs {
  const void* q;      // K2, K7: the qkv tensor (q = k = v); K6: the three slices
  const void* k;
  const void* v;
  const void* bias;   // K2: (nh, n, n); K4, K5, K7: the halves (groups, n, gh + gw);
                      // K6: rh (ws, ws, hd)
  const void* bias2;  // K6: rw (ws, ws, hd)
  void* out;
  long long groups;   // K2: windows x nh; K6: images x windows x nh
  int n, hd, gh, gw;  // tokens of a group, head width, grid (K6: ws, ws)
  int nh;             // K2, K6: heads; K7: the qkv's heads (0: K4, K5)
  int g_skip, n_valid, folded;  // K5: groups >= g_skip keep n_valid rows
  int hp, wp, ts, c;  // K6: padded grid, token stride of q / k / v, out channels
  float scale;
  int vec;            // bytes of one staged load of q, k, v: 16, 8, 4 or 2
};

// The widest load (16, 8, 4 or 2 bytes, at least one element) that every
// row start allows: the operands' addresses, the head width and the row
// (token) stride, of which every group, head and component offset is a
// multiple.
inline int general_vec(size_t elem, int hd, long long stride, const void* a, const void* b,
                       const void* c) {
  const unsigned long long x = static_cast<unsigned long long>(hd) * elem |
                               static_cast<unsigned long long>(stride) * elem |
                               reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                               reinterpret_cast<uintptr_t>(c);
  int v = 16;
  while (v > static_cast<int>(elem) && x % v) v /= 2;
  return v;
}

// bf16 (attention_general.cu), float16 (attention_general_f16.cu) and
// float32 (attention_general_f32.cu) launches of the body under `policy`;
// the launch's error.
cudaError_t attention_general_bf16(const GeneralArgs& a, int policy, cudaStream_t s);
cudaError_t attention_general_f16(const GeneralArgs& a, int policy, cudaStream_t s);
cudaError_t attention_general_f32(const GeneralArgs& a, int policy, cudaStream_t s);

inline cudaError_t attention_general(const GeneralArgs& a, int policy, int dtype,
                                     cudaStream_t s) {
  if (dtype == kDtypeF32) return attention_general_f32(a, policy, s);
  if (dtype == kDtypeBF16) return attention_general_bf16(a, policy, s);
  if (dtype == kDtypeF16) return attention_general_f16(a, policy, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The body (instantiated by attention_general.cu, _f16.cu and _f32.cu)

constexpr int kGenWarps = 4;
// Stages of the key pipeline: chunk i + 1's copies in flight while chunk i
// is computed (a third stage measured no faster, and cost K4 a block an SM).
constexpr int kGenStages = 2;
// 16 bits: a block keeps its score rows in shared memory (s computed once)
// for groups of up to this many tokens (64 rows x 264 floats: 66 KB).
constexpr int kScoreKeys = 256;
// K4 / K5 / K7: a block stages its rows' bias halves up to this size and
// reads them in place beyond it.
constexpr size_t kStagedHalves = 48 * 1024;

template <typename T>
struct GenTile {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kStep = kF32 ? 8 : 16;      // depth of one mma
  static constexpr int kDepth = kF32 ? 128 : 256;  // depth one staging holds
  static constexpr int kPad = 16 / sizeof(T);      // a shared row's padding
};

// An instance's output part (NT 8-column tiles) and key chunk, and the
// blocks an SM its launch bound asks ptxas for, so that no instance
// spills: 4 (128 registers) for K4 / K5 / K7 at NT 8 in 16 bits, whose
// two-pass K4 then runs four blocks an SM; 3 (168) where that fits; 2
// (255) where 168 spilled (K6 at NT 8, its float64 prologue; K4-K7 and K6
// at NT 16; float32 K4-K7 at NT 8); 1 for the widest heads.
template <typename T, int NT, int POL>
struct GenShape {
  static constexpr int kPart = 8 * NT;
  // 32 keys where NT's accumulators are large, and for float32 K2, whose
  // 64-key table tile (18 KB a stage) would hold it to two blocks an SM.
  static constexpr int kKeys =
      (GenTile<T>::kF32 ? NT >= 16 || POL == kGenLevit : NT >= 32) ? 32 : 64;
  static constexpr int kMinBlocks =
      GenTile<T>::kF32 ? (NT == 8 ? (POL == kGenRelpos ? 2 : 3) : 1)
      : NT == 8        ? (POL == kGenRelpos ? 4 : POL == kGenLevit ? 3 : 2)
      : NT == 16       ? (POL == kGenLevit ? 1 : 2)
                       : 1;
};

// Where a launch keeps what in shared memory (offsets in bytes), computed
// on the host for the block shape and passed to the kernel.
struct GenLayout {
  int bq;        // query rows a block (16 a warp)
  int dt, ndc;   // depth staged at once (a multiple of the mma depth), depth pieces
  int qp;        // row pitch of staged q and k (elements)
  int vw, vp;    // v columns staged (the part, rounded up to the mma depth), pitch
  int sp;        // score row pitch (floats); 0: two passes over the keys
  int hw;        // bias halves a row (K4-K7: gh + gw; K6: 2 ws)
  int h_staged;  // K4-K7: the halves staged (else read in place)
  int bp;        // K2's bias tile pitch (elements)
  int bvec;      // bytes of one copy of K2's table rows or K4-K7's halves rows
  int q_off, s_off, h_off, ring_off;  // q (staged once), scores, halves, the two stages
  int stage;                          // bytes of a stage
  int k_in, qc_in, v_in, b_in, yx_in;  // within a stage: k, q (depth pieces), v, K2's tile, keys' (y, x)
  size_t total;
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <typename T, int NT, int POL>
GenLayout general_layout(const GeneralArgs& a, int warps, bool scores) {
  constexpr int policy = POL;
  using L = GenTile<T>;
  using S = GenShape<T, NT, POL>;
  constexpr size_t es = sizeof(T);
  constexpr int kc = S::kKeys;
  GenLayout y{};
  y.bq = 16 * warps;
  const int hdp = round_up(a.hd, L::kStep);
  y.dt = hdp < L::kDepth ? hdp : L::kDepth;
  y.ndc = (hdp + y.dt - 1) / y.dt;
  y.qp = y.dt + L::kPad;
  y.vw = round_up(a.hd < S::kPart ? a.hd : S::kPart, L::kStep);
  y.vp = y.vw + L::kPad;
  y.sp = scores ? round_up(a.n, kc) + 8 : 0;
  y.hw = policy == kGenStrip ? 2 * a.gh : policy == kGenRelpos ? a.gh + a.gw : 0;
  y.h_staged = policy == kGenStrip ||
               (policy == kGenRelpos && static_cast<size_t>(y.bq) * y.hw * es <= kStagedHalves);
  y.bp = kc + 8;
  y.bvec = policy == kGenLevit ? general_vec(es, a.n, a.n, a.bias, a.bias, a.bias)
           : policy == kGenRelpos ? general_vec(es, y.hw, y.hw, a.bias, a.bias, a.bias)
                                  : static_cast<int>(es);
  size_t off = 0, st = 0;
  auto take = [](size_t& at, size_t bytes) {
    const size_t o = at;
    at += (bytes + 15) / 16 * 16;
    return static_cast<int>(o);
  };
  const bool q_once = y.ndc == 1;
  y.q_off = take(off, q_once ? y.bq * y.qp * es : 0);
  y.s_off = take(off, static_cast<size_t>(y.bq) * y.sp * 4);
  y.h_off = take(off, y.h_staged ? static_cast<size_t>(y.bq) * y.hw * es : 0);
  y.ring_off = static_cast<int>(off);
  y.k_in = take(st, kc * y.qp * es);
  y.qc_in = take(st, q_once ? 0 : y.bq * y.qp * es);
  // v: with the score path its pass streams v alone, in k's room (vw <= dt)
  y.v_in = scores ? y.k_in : take(st, kc * y.vp * es);
  y.b_in = take(st, policy == kGenLevit ? y.bq * y.bp * es : 0);
  y.yx_in = take(st, policy == kGenLevit ? 0 : kc * sizeof(int2));
  y.stage = static_cast<int>(st);
  y.total = off + kGenStages * st;
  return y;
}

// A group's rows: q, k, v and out at their first token; token r at
// row(r) * stride elements, row(r) = r, or for a window of K6
// (r / ws) wp + r % ws.
template <typename T>
struct GenRows {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  long long in_stride, out_stride;
  int ws, wp;
  __device__ __forceinline__ long long row(int r) const {
    return ws ? static_cast<long long>(r / ws) * wp + r % ws : r;
  }
};

template <typename T, int POL>
__device__ __forceinline__ GenRows<T> general_rows(const GeneralArgs& a, long long g) {
  const T* q = static_cast<const T*>(a.q);
  T* out = static_cast<T*>(a.out);
  const long long hd = a.hd, n = a.n;
  GenRows<T> r{};
  if constexpr (POL == kGenLevit) {
    // group = (window, head), head fastest; per head [q | k | v] in the
    // (G, n, nh * 3 kd) qkv, out (G, n, nh * kd)
    const long long w = g / a.nh, h = g - w * a.nh, width = 3 * a.nh * hd;
    r.q = q + w * n * width + 3 * h * hd;
    r.k = r.q + hd;
    r.v = r.q + 2 * hd;
    r.out = out + w * n * a.nh * hd + h * hd;
    r.in_stride = width;
    r.out_stride = a.nh * hd;
  } else if constexpr (POL == kGenRelpos) {
    r.out = out + g * n * hd;
    r.in_stride = r.out_stride = hd;
    if (a.nh > 0) {
      // K7: group = (window w, head h) of the (W, 3, nh, n, hd) qkv
      const long long w = g / a.nh, h = g - w * a.nh, hn = a.nh * n;
      r.q = q + (w * 3 * hn + h * n) * hd;
      r.k = r.q + hn * hd;
      r.v = r.q + 2 * hn * hd;
    } else {
      r.q = q + g * n * hd;
      r.k = static_cast<const T*>(a.k) + g * n * hd;
      r.v = static_cast<const T*>(a.v) + g * n * hd;
    }
  } else {
    // group = ((b, wy, wx) window, head), head fastest, in the padded NHWC
    const int ws = a.gh, nwx = a.wp / ws, nwy = a.hp / ws;
    const long long win = g / a.nh, head = g - win * a.nh;
    const long long wx = win % nwx, wy = (win / nwx) % nwy, b = win / (static_cast<long long>(nwx) * nwy);
    const long long tok0 = (b * a.hp + wy * ws) * a.wp + wx * ws;
    r.q = q + tok0 * a.ts + head * hd;
    r.k = static_cast<const T*>(a.k) + tok0 * a.ts + head * hd;
    r.v = static_cast<const T*>(a.v) + tok0 * a.ts + head * hd;
    r.out = out + tok0 * a.c + head * hd;
    r.in_stride = a.ts;
    r.out_stride = a.c;
    r.ws = ws;
    r.wp = a.wp;
  }
  return r;
}


template <int VB> struct VecOf;
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<4> { using type = unsigned int; };
template <> struct VecOf<2> { using type = unsigned short; };

// VB bytes from device to shared memory, zeros when !valid (cp.async: 16
// bytes bypass L1, 8 and 4 go through it).
template <int VB>
__device__ __forceinline__ void cp_async_vec(void* dst, const void* src, bool valid) {
  if constexpr (VB == 16) {
    cp_async16(dst, src, valid);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(VB), "r"(valid ? VB : 0)
                 : "memory");
  }
}

// Rows r0 .. r0 + nrows of `src` (row r at row_of(r) * stride elements),
// columns col0 .. col0 + width, into dst (row pitch ds elements) in
// VB-byte pieces, asynchronously (2-byte pieces: plain loads); zeros for
// rows >= rlimit and columns >= climit (a piece lies wholly on one side:
// both limits' offsets are multiples of VB).
template <int VB, typename T, class RowOf>
__device__ __forceinline__ void copy_rows(T* dst, int ds, const T* src, long long stride,
                                          const RowOf& row_of, int r0, int nrows, int rlimit,
                                          int col0, int width, int climit) {
  if constexpr (VB < static_cast<int>(sizeof(T))) {
    return;
  } else {
    constexpr int E = VB / sizeof(T);
    // The thread's pieces are threadIdx.x + k blockDim.x of the row-major
    // (nrows, per) pieces, walked as (row, piece) without a division each.
    const int per = width / E, dr = blockDim.x / per, dc = blockDim.x - dr * per;
    int r = threadIdx.x / per, c = threadIdx.x - r * per;
    while (r < nrows) {
      const int col = c * E;
      const bool ok = r0 + r < rlimit && col0 + col < climit;
      const T* s = ok ? src + row_of(r0 + r) * stride + col0 + col : src;
      T* d = dst + r * ds + col;
      if constexpr (VB >= 4) {
        cp_async_vec<VB>(d, s, ok);
      } else {
        *reinterpret_cast<unsigned short*>(d) = ok ? *reinterpret_cast<const unsigned short*>(s) : 0;
      }
      r += dr;
      c += dc;
      if (c >= per) {
        c -= per;
        ++r;
      }
    }
  }
}

template <typename T, class RowOf>
__device__ __forceinline__ void copy_rows(int vec, T* dst, int ds, const T* src, long long stride,
                                          const RowOf& row_of, int r0, int nrows, int rlimit,
                                          int col0, int width, int climit) {
  switch (vec) {
    case 16: copy_rows<16>(dst, ds, src, stride, row_of, r0, nrows, rlimit, col0, width, climit); break;
    case 8: copy_rows<8>(dst, ds, src, stride, row_of, r0, nrows, rlimit, col0, width, climit); break;
    case 4: copy_rows<4>(dst, ds, src, stride, row_of, r0, nrows, rlimit, col0, width, climit); break;
    default: copy_rows<2>(dst, ds, src, stride, row_of, r0, nrows, rlimit, col0, width, climit); break;
  }
}

struct SameRow {
  __device__ __forceinline__ long long operator()(int r) const { return r; }
};

template <typename T>
struct TokenRow {
  const GenRows<T>* rows;
  __device__ __forceinline__ long long operator()(int r) const { return rows->row(r); }
};

// x . w over hd elements in VB-byte pieces, summed in float64 (exact for
// 16-bit products whose magnitudes span less than 2^37), then rounded for
// T: to odd in float32 for a 16-bit T, whose rounding of it is then the
// correct rounding of the sum; to nearest for float32.
template <int VB, typename T>
__device__ __forceinline__ float dot_rows(const T* x, const T* w, int hd) {
  if constexpr (VB < static_cast<int>(sizeof(T))) {
    return 0.f;
  } else {
    using V = typename VecOf<VB>::type;
    constexpr int E = VB / sizeof(T);
    union Piece {
      V v;
      T e[E];
    };
    double acc = 0.0;
    for (int d = 0; d < hd; d += E) {
      Piece xp, wp;
      xp.v = *reinterpret_cast<const V*>(x + d);
      wp.v = *reinterpret_cast<const V*>(w + d);
#pragma unroll
      for (int u = 0; u < E; ++u)
        acc = fma(static_cast<double>(to_float(xp.e[u])), static_cast<double>(to_float(wp.e[u])),
                  acc);
    }
    if constexpr (GenTile<T>::kF32) return __double2float_rn(acc);
    float f = __double2float_rz(acc);
    if (static_cast<double>(f) != acc) f = __uint_as_float(__float_as_uint(f) | 1u);
    return f;
  }
}

template <typename T>
__device__ __forceinline__ float dot_rows(int vec, const T* x, const T* w, int hd) {
  switch (vec) {
    case 16: return dot_rows<16>(x, w, hd);
    case 8: return dot_rows<8>(x, w, hd);
    case 4: return dot_rows<4>(x, w, hd);
    default: return dot_rows<2>(x, w, hd);
  }
}

// s[KT][4] += q . k^T of the warp's 16 rows (qw: its first staged row)
// against KC = 8 KT staged keys over `steps` depth steps.
template <typename T, int KT>
__device__ __forceinline__ void general_qk(float (&s)[KT][4], const T* qw, int qp, const T* ks,
                                           int steps, int lane) {
  const int gr = lane >> 2, gq = lane & 3;
  if constexpr (GenTile<T>::kF32) {
    for (int st = 0; st < steps; ++st) {
      const float* qa = qw + gr * qp + 8 * st + gq;
      uint32_t ah[4], al[4];
      split(qa[0], ah[0], al[0]);
      split(qa[8 * qp], ah[1], al[1]);
      split(qa[4], ah[2], al[2]);
      split(qa[8 * qp + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float* kb = ks + (8 * j + gr) * qp + 8 * st + gq;
        uint32_t bh0, bl0, bh1, bl1;
        split(kb[0], bh0, bl0);
        split(kb[4], bh1, bl1);
        mma_3xtf32(s[j], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  } else {
    // A: rows lane % 16, depth + 8 for lanes 16-31; B (key-major rows): keys
    // lane % 8 (+ 8 for lanes 16-31), depth + 8 for lanes 8-15 and 24-31.
    const T* qa = qw + (lane & 15) * qp + (lane >> 4) * 8;
    const T* kb = ks + ((lane & 7) + ((lane >> 4) << 3)) * qp + ((lane >> 3) & 1) * 8;
    for (int st = 0; st < steps; ++st) {
      uint32_t a[4];
      ldsm_x4(a, qa + 16 * st);
#pragma unroll
      for (int jp = 0; jp < KT / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, kb + 16 * jp * qp + 16 * st);
        Half2<T>::mma(s[2 * jp], a, b[0], b[1]);
        Half2<T>::mma(s[2 * jp + 1], a, b[2], b[3]);
      }
    }
  }
}

// o += p . v for 16 keys of the chunk (row 16 kk of the staged v): p the
// A fragment, v's B fragments by ldmatrix.trans, the vw staged columns.
template <typename T, int NT>
__device__ __forceinline__ void general_pv16(float (&o)[NT][4], const uint32_t (&pa)[4],
                                             const T* vs, int vp, int vw, int kk, int lane) {
  const T* vb = vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * vp + (lane >> 4) * 8;
#pragma unroll
  for (int tt = 0; tt < NT / 2; ++tt) {
    if (16 * tt < vw) {
      uint32_t b[4];
      ldsm_x4_trans(b, vb + 16 * tt);
      Half2<T>::mma(o[2 * tt], pa, b[0], b[1]);
      Half2<T>::mma(o[2 * tt + 1], pa, b[2], b[3]);
    }
  }
}

// The scores of a chunk (keys kc ..): scale, bias, keys past n masked.
// h0, h1: the bias halves of the thread's rows (K4-K7; staged or in
// place), yx: the chunk keys' (y, x); bt0, bt1: K2's staged table rows.
template <typename T, int POL, int KT>
__device__ __forceinline__ void general_scores(float (&s)[KT][4], const GeneralArgs& a,
                                               const T* h0, const T* h1, const int2* yx,
                                               const T* bt0, const T* bt1, int kc, int gq) {
  const bool full = POL == kGenLevit && kc + 8 * KT <= a.n;  // K2: no key of the chunk past n
#pragma unroll
  for (int j = 0; j < KT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = 8 * j + 2 * gq + (e & 1);
      float x = s[j][e];
      if (!full && kc + kj >= a.n) {
        x = -INFINITY;
      } else if constexpr (POL == kGenLevit) {
        float b;
        if constexpr (GenTile<T>::kF32) {
          b = (e >> 1 ? bt1 : bt0)[kj];
        } else {  // the key pair's two values in one load
          const uint32_t w = *reinterpret_cast<const uint32_t*>((e >> 1 ? bt1 : bt0) + (kj & ~1));
          b = e & 1 ? Half2<T>::hi(w) : Half2<T>::lo(w);
        }
        x = __fadd_rn(__fmul_rn(x, a.scale), b);
      } else {
        const int2 p = yx[kj];
        const T* h = e >> 1 ? h1 : h0;
        if constexpr (POL == kGenStrip) {
          x = __fadd_rn(__fadd_rn(__fmul_rn(x, a.scale), to_float(h[p.x])),
                        to_float(h[a.gh + p.y]));
        } else {
          const float b = __fadd_rn(to_float(h[p.x]), to_float(h[a.gh + p.y]));
          x = a.folded ? __fmul_rn(__fadd_rn(x, b), a.scale) : __fadd_rn(__fmul_rn(x, a.scale), b);
        }
      }
      s[j][e] = x;
    }
  }
}

// The rows' running max and sum over a chunk's scores; alpha: the factor
// the earlier sum (and, in float32, o) takes. In float32 the scores become
// their exponentials (the running max).
template <bool EXP, int KT>
__device__ __forceinline__ void general_online(float (&s)[KT][4], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
    const float mn = fmaxf(m[i], quad_max(mx));  // finite: a chunk has a key < n
    const float c = -mn * kLog2e;
    float add = 0.f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float e0 = ex2(fmaf(s[j][2 * i], kLog2e, c));
      const float e1 = ex2(fmaf(s[j][2 * i + 1], kLog2e, c));
      if (EXP) {
        s[j][2 * i] = e0;
        s[j][2 * i + 1] = e1;
      }
      add += e0 + e1;
    }
    alpha[i] = ex2((m[i] - mn) * kLog2e);  // 0 for the first chunk
    l[i] = fmaf(l[i], alpha[i], quad_sum(add));
    m[i] = mn;
  }
}

// p = exp(s - m) / l in float32 with the row's final m and l, rounded to T:
// two scores of one row packed. The quotient comes from the row's
// correctly rounded reciprocal r = 1 / l and one FMA correction
// (Markstein), which rounds it as a division does (e <= 1 <= l, p normal).
template <typename T>
__device__ __forceinline__ uint32_t general_p(float x0, float x1, float c, float l, float r) {
  const float e0 = ex2(fmaf(x0, kLog2e, c)), e1 = ex2(fmaf(x1, kLog2e, c));
  const float q0 = __fmul_rn(e0, r), q1 = __fmul_rn(e1, r);
  return Half2<T>::pack(fmaf(fmaf(-q0, l, e0), r, q0), fmaf(fmaf(-q1, l, e1), r, q1));
}

template <typename T, int POL, int NT>
__global__ void __launch_bounds__(32 * kGenWarps, (GenShape<T, NT, POL>::kMinBlocks))
    attention_general_kernel(GeneralArgs a, GenLayout y) {
  using L = GenTile<T>;
  using S = GenShape<T, NT, POL>;
  constexpr int KC = S::kKeys, KT = KC / 8;
  constexpr int kPasses = L::kF32 ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long g = blockIdx.x;
  const int bq = y.bq, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, gq = lane & 3;
  const int n = a.n, hd = a.hd, q0 = blockIdx.y * bq, c0 = blockIdx.z * S::kPart;
  const int cols = min(S::kPart, hd - c0);  // output columns of this block
  const GenRows<T> rows = general_rows<T, POL>(a, g);
  const TokenRow<T> tok{&rows};
  int nq = n;  // query rows whose output is kept
  if constexpr (POL == kGenRelpos) {
    if (g >= a.g_skip) nq = min(a.n_valid, n);
  }
  if (q0 >= nq) {  // only skipped rows: zeros
    for (int e = tid; e < bq * cols; e += blockDim.x) {
      const int r = q0 + e / cols, col = c0 + e % cols;
      if (r < n) rows.out[rows.row(r) * rows.out_stride + col] = from_float<T>(0.f);
    }
    return;
  }

  T* qs = reinterpret_cast<T*>(smem_raw + y.q_off);
  float* ss = reinterpret_cast<float*>(smem_raw + y.s_off);
  T* hs = reinterpret_cast<T*>(smem_raw + y.h_off);
  unsigned char* ring = smem_raw + y.ring_off;
  const bool q_once = y.ndc == 1, spath = y.sp > 0;
  const int hdp = (hd + L::kStep - 1) / L::kStep * L::kStep;
  const int chunks = (n + KC - 1) / KC;
  // Items, in order: the first pass's (chunk, depth piece), then in 16 bits
  // the second pass's (chunk, depth piece), or (chunk) on the score path.
  const int items0 = chunks * y.ndc;
  const int items = L::kF32 ? items0 : items0 + chunks * (spath ? 1 : y.ndc);
  const T* table = nullptr;  // K2: the head's (n, n) table; K4-K7: the group's halves
  if constexpr (POL == kGenLevit) {
    table = static_cast<const T*>(a.bias) + (g % a.nh) * static_cast<long long>(n) * n;
  } else if constexpr (POL == kGenRelpos) {
    table = static_cast<const T*>(a.bias) + g * static_cast<long long>(n) * y.hw;
  }

  struct Item {
    int pass, kc, dc;
    bool k, last, v;  // q . k this item; its last depth piece; p . v this item
  };
  auto decode = [&](int i) {
    Item it;
    int nd = y.ndc;
    it.pass = i >= items0;
    if (it.pass) {
      i -= items0;
      if (spath) nd = 1;
    }
    it.kc = i / nd * KC;
    it.dc = i % nd;
    it.k = !(spath && it.pass == 1);
    it.last = it.dc == nd - 1;
    it.v = it.pass == kPasses - 1 && it.last;
    return it;
  };
  auto issue = [&](int i) {
    const Item it = decode(i);
    unsigned char* st = ring + (i % kGenStages) * y.stage;
    if (it.k) {
      copy_rows(a.vec, reinterpret_cast<T*>(st + y.k_in), y.qp, rows.k, rows.in_stride, tok,
                it.kc, KC, n, it.dc * y.dt, y.dt, hd);
      if (!q_once)
        copy_rows(a.vec, reinterpret_cast<T*>(st + y.qc_in), y.qp, rows.q, rows.in_stride, tok,
                  q0, bq, n, it.dc * y.dt, y.dt, hd);
      if (it.last) {
        if constexpr (POL == kGenLevit) {
          copy_rows(y.bvec, reinterpret_cast<T*>(st + y.b_in), y.bp, table, n, SameRow{}, q0, bq,
                    n, it.kc, KC, n);
        } else {
          int2* yx = reinterpret_cast<int2*>(st + y.yx_in);
          for (int e = tid; e < KC; e += blockDim.x) {
            const int key = min(it.kc + e, n - 1), ky = key / a.gw;
            yx[e] = make_int2(ky, key - ky * a.gw);
          }
        }
      }
    }
    if (it.v)
      copy_rows(a.vec, reinterpret_cast<T*>(st + y.v_in), y.vp, rows.v, rows.in_stride, tok, it.kc,
                KC, n, c0, y.vw, c0 + cols);
  };

  // q (and K4-K7's staged halves), then the first items' copies.
  if (q_once) copy_rows(a.vec, qs, y.qp, rows.q, rows.in_stride, tok, q0, bq, n, 0, y.dt, hd);
  if constexpr (POL == kGenRelpos) {
    if (y.h_staged)
      copy_rows(y.bvec, hs, y.hw, table, y.hw, SameRow{}, q0, bq, n, 0, y.hw, y.hw);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kGenStages - 1; ++i) {
    if (i < items) issue(i);
    cp_async_commit();
  }
  if constexpr (POL == kGenStrip) {
    // K6: bh | bw of the block's rows, each sum over d correctly rounded to
    // T, from the staged q (or q in place) while the first chunks land.
    cp_async_wait<kGenStages - 1>();
    __syncthreads();
    const int ws = a.gh, h2 = 2 * ws;
    const T* rh = static_cast<const T*>(a.bias);
    const T* rw = static_cast<const T*>(a.bias2);
    for (int e = tid; e < bq * h2; e += blockDim.x) {
      const int r = e / h2, yy = e - r * h2, i = q0 + r;
      float acc = 0.f;
      if (i < n) {
        const T* qr = q_once ? qs + r * y.qp : rows.q + rows.row(i) * rows.in_stride;
        const T* tb = yy < ws ? rh + (static_cast<long long>(i / ws) * ws + yy) * hd
                              : rw + (static_cast<long long>(i % ws) * ws + (yy - ws)) * hd;
        acc = dot_rows(a.vec, qr, tb, hd);
      }
      hs[r * y.hw + yy] = from_float<T>(acc);
    }
  }

  const bool active = q0 + 16 * warp < nq;  // the warp has a kept row
  const int rl = 16 * warp + gr;            // the thread's rows rl, rl + 8 of the block
  // The thread's rows' bias halves (K4-K7) and K6's.
  const T* h0 = hs + rl * y.hw;
  const T* h1 = h0 + 8 * y.hw;
  if constexpr (POL == kGenRelpos) {
    if (!y.h_staged) {
      h0 = table + static_cast<long long>(min(q0 + rl, n - 1)) * y.hw;
      h1 = table + static_cast<long long>(min(q0 + rl + 8, n - 1)) * y.hw;
    }
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float s[KT][4];

  for (int i = 0; i < items; ++i) {
    cp_async_wait<kGenStages - 2>();
    __syncthreads();  // item i landed; every reader of item i - 1's stage is done
    if (i + kGenStages - 1 < items) issue(i + kGenStages - 1);
    cp_async_commit();
    if (!active) continue;
    const Item it = decode(i);
    const unsigned char* st = ring + (i % kGenStages) * y.stage;
    const T* vs = reinterpret_cast<const T*>(st + y.v_in);
    if (it.k) {
      if (it.dc == 0) {
#pragma unroll
        for (int j = 0; j < KT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      }
      const T* qb = q_once ? qs : reinterpret_cast<const T*>(st + y.qc_in);
      general_qk<T, KT>(s, qb + 16 * warp * y.qp, y.qp, reinterpret_cast<const T*>(st + y.k_in),
                        min(y.dt, hdp - it.dc * y.dt) / L::kStep, lane);
      if (!it.last) continue;
      const T* bt0 = reinterpret_cast<const T*>(st + y.b_in) + rl * y.bp;
      general_scores<T, POL, KT>(s, a, h0, h1, reinterpret_cast<const int2*>(st + y.yx_in), bt0,
                                 bt0 + 8 * y.bp, it.kc, gq);
      float alpha[2];
      if constexpr (L::kF32) {
        general_online<true>(s, m, l, alpha);
        // p (unnormalised, the running max) . v from zero, joined to o in
        // one rounded FMA.
        float pv[NT][4];
#pragma unroll
        for (int t = 0; t < NT; ++t) pv[t][0] = pv[t][1] = pv[t][2] = pv[t][3] = 0.f;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          // The score columns (2 gq, 2 gq + 1) of tile j are the k slots
          // (gq, gq + 4) of p, the keys of v permuted alike.
          uint32_t ah[4], al[4];
          split(s[j][0], ah[0], al[0]);
          split(s[j][2], ah[1], al[1]);
          split(s[j][1], ah[2], al[2]);
          split(s[j][3], ah[3], al[3]);
          const T* vb = vs + (8 * j + 2 * gq) * y.vp + gr;
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            if (8 * t < y.vw) {
              uint32_t bh0, bl0, bh1, bl1;
              split(vb[8 * t], bh0, bl0);
              split(vb[y.vp + 8 * t], bh1, bl1);
              mma_3xtf32(pv[t], ah, al, bh0, bh1, bl0, bl1);
            }
          }
        }
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[t][e] = fmaf(o[t][e], alpha[e >> 1], pv[t][e]);
      } else if (it.pass == 0) {
        general_online<false>(s, m, l, alpha);
        if (spath) {  // keep the chunk's scores for the second pass
          float* s0 = ss + rl * y.sp + it.kc + 2 * gq;
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            *reinterpret_cast<float2*>(s0 + 8 * j) = make_float2(s[j][0], s[j][1]);
            *reinterpret_cast<float2*>(s0 + 8 * y.sp + 8 * j) = make_float2(s[j][2], s[j][3]);
          }
        }
      } else {
        // p = exp(s - m) / l with the rows' final m and l, rounded to T,
        // then p . v accumulated in o.
        const float c0r = -m[0] * kLog2e, c1r = -m[1] * kLog2e;
        const float r0 = __frcp_rn(l[0]), r1 = __frcp_rn(l[1]);
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          const float* x0 = s[2 * kk];
          const float* x1 = s[2 * kk + 1];
          const uint32_t pa[4] = {general_p<T>(x0[0], x0[1], c0r, l[0], r0),
                                  general_p<T>(x0[2], x0[3], c1r, l[1], r1),
                                  general_p<T>(x1[0], x1[1], c0r, l[0], r0),
                                  general_p<T>(x1[2], x1[3], c1r, l[1], r1)};
          general_pv16<T, NT>(o, pa, vs, y.vp, y.vw, kk, lane);
        }
      }
    } else if constexpr (!L::kF32) {
      // The score path's second pass: p from the stored scores.
      const float c0r = -m[0] * kLog2e, c1r = -m[1] * kLog2e;
      const float r0 = __frcp_rn(l[0]), r1 = __frcp_rn(l[1]);
      const float* s0 = ss + rl * y.sp + it.kc + 2 * gq;
      const float* s1 = s0 + 8 * y.sp;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        const float2 x0 = *reinterpret_cast<const float2*>(s0 + 16 * kk);
        const float2 x1 = *reinterpret_cast<const float2*>(s1 + 16 * kk);
        const float2 x2 = *reinterpret_cast<const float2*>(s0 + 16 * kk + 8);
        const float2 x3 = *reinterpret_cast<const float2*>(s1 + 16 * kk + 8);
        const uint32_t pa[4] = {general_p<T>(x0.x, x0.y, c0r, l[0], r0),
                                general_p<T>(x1.x, x1.y, c1r, l[1], r1),
                                general_p<T>(x2.x, x2.y, c0r, l[0], r0),
                                general_p<T>(x3.x, x3.y, c1r, l[1], r1)};
        general_pv16<T, NT>(o, pa, vs, y.vp, y.vw, kk, lane);
      }
    }
  }

  // The block's column part of its rows; skipped rows zero.
  const bool pairs = a.vec >= 2 * static_cast<int>(sizeof(T));
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + rl + 8 * h, cc = 8 * t + 2 * gq;
      if (r >= n || cc >= cols) continue;
      float v0 = 0.f, v1 = 0.f;
      if (r < nq) {
        v0 = o[t][2 * h];
        v1 = o[t][2 * h + 1];
        if (L::kF32) {
          v0 = __fdiv_rn(v0, l[h]);
          v1 = __fdiv_rn(v1, l[h]);
        }
      }
      T* dst = rows.out + rows.row(r) * rows.out_stride + c0 + cc;
      if constexpr (L::kF32) {
        if (pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          continue;
        }
      } else {
        if (pairs) {
          *reinterpret_cast<uint32_t*>(dst) = Half2<T>::pack(v0, v1);
          continue;
        }
      }
      dst[0] = from_float<T>(v0);
      if (cc + 1 < cols) dst[1] = from_float<T>(v1);
    }
  }
}

template <typename T, int POL, int NT>
cudaError_t launch_general(const GeneralArgs& a, cudaStream_t stream) {
  using S = GenShape<T, NT, POL>;
  // Four warps with the score path where it may run, then without it, then
  // fewer warps (K6's halves of 64 rows may not fit).
  const bool scores = !GenTile<T>::kF32 && a.n <= kScoreKeys;
  GenLayout y{};
  int warps = kGenWarps;
  for (;; warps /= 2) {
    if (scores) {
      y = general_layout<T, NT, POL>(a, warps, true);
      if (y.total <= kMaxSmem) break;
    }
    y = general_layout<T, NT, POL>(a, warps, false);
    if (y.total <= kMaxSmem || warps == 1) break;
  }
  const long long row_blocks = (a.n + y.bq - 1LL) / y.bq;
  const long long parts = (a.hd + S::kPart - 1LL) / S::kPart;
  if (y.total > kMaxSmem || row_blocks > 65535 || parts > 65535) return cudaErrorInvalidValue;
  auto kernel = &attention_general_kernel<T, POL, NT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(y.total));
  // All of the unified cache as shared memory, so that the blocks that
  // fit its 228 KB share an SM.
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(a.groups), static_cast<unsigned>(row_blocks),
                  static_cast<unsigned>(parts));
  kernel<<<grid, 32 * warps, y.total, stream>>>(a, y);
  return cudaGetLastError();
}

// The instance for the head width: a whole head a block up to 256 columns
// in 16 bits (parts of 256 beyond), parts of 128 in float32.
template <typename T, int POL>
cudaError_t launch_general(const GeneralArgs& a, cudaStream_t s) {
  if (a.groups <= 0 || a.n <= 0) return cudaSuccess;
  if (a.groups > 0x7fffffffLL || a.hd <= 0 || a.vec < static_cast<int>(sizeof(T)))
    return cudaErrorInvalidValue;
  if (a.hd <= 64) return launch_general<T, POL, 8>(a, s);
  if constexpr (GenTile<T>::kF32) {
    return launch_general<T, POL, 16>(a, s);
  } else {
    if (a.hd <= 128) return launch_general<T, POL, 16>(a, s);
    return launch_general<T, POL, 32>(a, s);
  }
}

template <typename T>
cudaError_t general_by_policy(const GeneralArgs& a, int policy, cudaStream_t s) {
  switch (policy) {
    case kGenLevit: return launch_general<T, kGenLevit>(a, s);
    case kGenRelpos: return launch_general<T, kGenRelpos>(a, s);
    case kGenStrip: return launch_general<T, kGenStrip>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dlimg
