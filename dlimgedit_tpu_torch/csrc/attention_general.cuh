// The general attention body for Hopper: every geometry of K2, K4, K5, K6
// and K7 that their tuned instances do not take. attention_general.cu
// instantiates it in bf16 and float16, attention_general_f32.cu in float32.
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
//             bh[i, y] = sum_d q_i[d] rh[y_i, y, d] in float32, rounded to
//             the dtype (bw alike from rw[x_i]), computed here
//   p = softmax_j(s), normalised in float32 and then rounded to the dtype;
//   out = p . v accumulated in float32, rounded to the dtype; K5's skipped
//   pad-query rows written as zeros.
//
// Design. A block owns (group, up to 64 query rows, one part of at most
// kPart output columns); a warp a 16-row stripe (rows lane / 4 and + 8 of
// the mma fragments). Groups are on gridDim.x, so any count up to 2^31 - 1
// launches at once. The head width is a run-time value: q . k runs over
// depth steps (bf16 / float16 `mma.sync.m16n8k16`; float32 `m16n8k8` TF32
// in three passes, hi.hi + hi.lo + lo.hi, as relpos_attention_f32tc.cuh
// describes) from q and k rows staged in shared memory, zero past hd; the
// whole head when it fits (hd <= 256 in 16 bits, 128 in float32; q then
// staged once), else a depth chunk at a time. p . v writes the block's
// column part; a head wider than one part is several blocks, each computing
// s again (hd 136 in bf16: two). Keys come in chunks of 64, any N.
//   16 bits: two passes over the keys. The first takes each row's max and
//   sum (online), the second computes s again, forms p = exp(s - m) / l in
//   float32, rounds p to the dtype and accumulates p . v in float32: JAX's
//   rounding point (dlimgedit_tpu/ops/flash_attention.py:73-81, :520-526,
//   :622-628).
//   float32: one pass of online softmax (rounding p to float32 is the
//   identity); each chunk's p . v starts from zero and joins o in one
//   rounded FMA (the tensor cores' float32 accumulation truncates:
//   relpos_attention_f32tc.cuh), o / l at the end.
// Loads: rows are staged with the widest access that the row starts, the
// head offsets and the token stride all allow (`general_vec`: 16, 8, 4 or
// 2 bytes; hd 36 in bf16 reads 8-byte pieces, an odd hd 2-byte ones), so no
// operand is padded or cast on the host. Bias values are read by index
// from device memory (K2's table, K4 / K5 / K7's halves); K6's halves are
// computed by the block for its rows into shared memory (a block of fewer
// warps where a window's halves of 64 rows do not fit).
//
// What bounds it on an H100: operations, as the tuned bodies, which it
// does not try to approach: a body that is right for every geometry; its
// times are in PERF.md. Beside the products it computes s twice in 16
// bits, re-reads q per key chunk above the staging depth, and reads each
// bias value from L1 / L2.
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

// bf16 / float16 (attention_general.cu) and float32
// (attention_general_f32.cu) launches of the body under `policy`; the
// launch's error.
cudaError_t attention_general_16(const GeneralArgs& a, int policy, int dtype, cudaStream_t s);
cudaError_t attention_general_f32(const GeneralArgs& a, int policy, cudaStream_t s);

inline cudaError_t attention_general(const GeneralArgs& a, int policy, int dtype,
                                     cudaStream_t s) {
  if (dtype == kDtypeF32) return attention_general_f32(a, policy, s);
  if (dtype == kDtypeBF16 || dtype == kDtypeF16) return attention_general_16(a, policy, dtype, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The body (instantiated by attention_general.cu and attention_general_f32.cu)

constexpr int kGenKeys = 64;  // keys a chunk
constexpr int kGenMaxWarps = 4;

template <typename T>
struct GenTile {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kStep = kF32 ? 8 : 16;      // depth of one mma
  static constexpr int kDepth = kF32 ? 128 : 256;  // depth one staging holds
  static constexpr int kPad = 16 / sizeof(T);      // a shared row's padding
  static constexpr int kPart = kF32 ? 64 : 128;    // output columns of a block
  static constexpr int kTiles = kPart / 8;
};

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

// Rows r0 .. r0 + nrows of `src` (token r at rows.row(r) * stride), columns
// col0 .. col0 + width, into dst (row stride ds elements) in VB-byte
// pieces; zeros for rows >= rlimit and columns >= hd (a piece lies wholly
// on one side: hd is a multiple of its elements).
template <int VB, typename T>
__device__ __forceinline__ void stage_vec(T* dst, int ds, const T* src, const GenRows<T>& rows,
                                          long long stride, int r0, int nrows, int rlimit,
                                          int col0, int width, int hd) {
  if constexpr (VB < static_cast<int>(sizeof(T))) {
    return;
  } else {
    using V = typename VecOf<VB>::type;
    constexpr int E = VB / sizeof(T);
    const int per_row = width / E;
    for (int i = threadIdx.x; i < nrows * per_row; i += blockDim.x) {
      const int r = i / per_row, c = (i - r * per_row) * E;
      V val{};
      if (r0 + r < rlimit && col0 + c < hd)
        val = *reinterpret_cast<const V*>(src + rows.row(r0 + r) * stride + col0 + c);
      *reinterpret_cast<V*>(dst + r * ds + c) = val;
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage(int vec, T* dst, int ds, const T* src,
                                      const GenRows<T>& rows, long long stride, int r0, int nrows,
                                      int rlimit, int col0, int width, int hd) {
  switch (vec) {
    case 16: stage_vec<16>(dst, ds, src, rows, stride, r0, nrows, rlimit, col0, width, hd); break;
    case 8: stage_vec<8>(dst, ds, src, rows, stride, r0, nrows, rlimit, col0, width, hd); break;
    case 4: stage_vec<4>(dst, ds, src, rows, stride, r0, nrows, rlimit, col0, width, hd); break;
    default: stage_vec<2>(dst, ds, src, rows, stride, r0, nrows, rlimit, col0, width, hd); break;
  }
}

__device__ __forceinline__ uint32_t lds_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// s[8][4] += q . k^T of the warp's 16 rows against 64 staged keys over
// `steps` depth steps from column qc of the staged q.
template <typename T>
__device__ __forceinline__ void general_qk(float (&s)[8][4], const T* qs, int qsd, int qc,
                                           const T* ks, int ksd, int steps) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, gq = lane & 3;
  if constexpr (GenTile<T>::kF32) {
    for (int st = 0; st < steps; ++st) {
      const float* qa = qs + gr * qsd + qc + 8 * st + gq;
      uint32_t ah[4], al[4];
      split(qa[0], ah[0], al[0]);
      split(qa[8 * qsd], ah[1], al[1]);
      split(qa[4], ah[2], al[2]);
      split(qa[8 * qsd + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* kb = ks + (8 * j + gr) * ksd + 8 * st + gq;
        uint32_t bh0, bl0, bh1, bl1;
        split(kb[0], bh0, bl0);
        split(kb[4], bh1, bl1);
        mma_3xtf32(s[j], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  } else {
    for (int st = 0; st < steps; ++st) {
      const T* qa = qs + gr * qsd + qc + 16 * st + 2 * gq;
      const uint32_t a[4] = {lds_u32(qa), lds_u32(qa + 8 * qsd), lds_u32(qa + 8),
                             lds_u32(qa + 8 * qsd + 8)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const T* kb = ks + (8 * j + gr) * ksd + 16 * st + 2 * gq;
        Half2<T>::mma(s[j], a, lds_u32(kb), lds_u32(kb + 8));
      }
    }
  }
}

template <typename T, int POL>
__global__ void __launch_bounds__(32 * kGenMaxWarps) attention_general_kernel(GeneralArgs a) {
  using L = GenTile<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long g = blockIdx.x;
  const int warps = blockDim.x >> 5, bq = 16 * warps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gr = lane >> 2, gq = lane & 3;
  const int n = a.n, hd = a.hd, q0 = blockIdx.y * bq, c0 = blockIdx.z * L::kPart;
  const int cols = min(L::kPart, hd - c0);  // output columns of this block
  const GenRows<T> rows = general_rows<T, POL>(a, g);
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

  // Shared memory: q (bq rows), k and v (64 rows each), K6's bias halves.
  const int hdp = (hd + L::kStep - 1) / L::kStep * L::kStep;
  const int dt = min(hdp, L::kDepth);
  const bool q_once = hdp <= L::kDepth;
  const int qsd = dt + L::kPad, vsd = L::kPart + L::kPad;
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + bq * qsd;
  T* vs = ks + kGenKeys * qsd;
  float* hs = reinterpret_cast<float*>(vs + kGenKeys * vsd);

  const T* bias = nullptr;  // K2: the head's (n, n) table; K4 / K5 / K7: the group's halves
  const int ghw = a.gh + a.gw;
  if constexpr (POL == kGenLevit) {
    bias = static_cast<const T*>(a.bias) + (g % a.nh) * static_cast<long long>(n) * n;
  } else if constexpr (POL == kGenRelpos) {
    bias = static_cast<const T*>(a.bias) + g * static_cast<long long>(n) * ghw;
  } else {
    // K6: bh | bw of the block's rows, float32 sums over d rounded to T.
    const int ws = a.gh, h2 = 2 * ws;
    const T* rh = static_cast<const T*>(a.bias);
    const T* rw = static_cast<const T*>(a.bias2);
    for (int e = tid; e < bq * h2; e += blockDim.x) {
      const int r = e / h2, y = e - r * h2, i = q0 + r;
      float acc = 0.f;
      if (i < n) {
        const T* qr = rows.q + rows.row(i) * rows.in_stride;
        const T* tb = y < ws ? rh + (static_cast<long long>(i / ws) * ws + y) * hd
                             : rw + (static_cast<long long>(i % ws) * ws + (y - ws)) * hd;
        for (int d = 0; d < hd; ++d) acc = fmaf(to_float(qr[d]), to_float(tb[d]), acc);
      }
      hs[e] = to_float(from_float<T>(acc));
    }
  }

  const int ra = q0 + 16 * warp + gr;  // the thread's rows ra, ra + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[L::kTiles][4];
#pragma unroll
  for (int t = 0; t < L::kTiles; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;

  if (q_once) stage(a.vec, qs, qsd, rows.q, rows, rows.in_stride, q0, bq, n, 0, dt, hd);
  constexpr int kPasses = L::kF32 ? 1 : 2;
  for (int pass = 0; pass < kPasses; ++pass) {
    const bool with_v = pass == kPasses - 1;
    for (int kc = 0; kc < n; kc += kGenKeys) {
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      for (int dc = 0; dc < hdp; dc += dt) {
        __syncthreads();  // the last chunk's readers are done
        if (!q_once) stage(a.vec, qs, qsd, rows.q, rows, rows.in_stride, q0, bq, n, dc, dt, hd);
        stage(a.vec, ks, qsd, rows.k, rows, rows.in_stride, kc, kGenKeys, n, dc, dt, hd);
        if (with_v && dc + dt >= hdp)
          stage(a.vec, vs, vsd, rows.v, rows, rows.in_stride, kc, kGenKeys, n, c0, L::kPart, hd);
        __syncthreads();
        general_qk<T>(s, qs + 16 * warp * qsd, qsd, q_once ? dc : 0, ks, qsd,
                      min(dt, hdp - dc) / L::kStep);
      }
      // The scores: scale, bias, keys past n masked.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kc + 8 * j + 2 * gq + (e & 1);
          const int r = ra + 8 * (e >> 1);
          const int rc = min(r, n - 1);  // rows past n read row n - 1's bias
          float x = s[j][e];
          if (key >= n) {
            x = -INFINITY;
          } else if constexpr (POL == kGenLevit) {
            x = __fadd_rn(__fmul_rn(x, a.scale), to_float(bias[static_cast<long long>(rc) * n + key]));
          } else if constexpr (POL == kGenStrip) {
            const float* h = hs + (r - q0) * 2 * a.gh;
            const int yj = key / a.gh, xj = key - yj * a.gh;
            x = __fadd_rn(__fadd_rn(__fmul_rn(x, a.scale), h[yj]), h[a.gh + xj]);
          } else {
            const T* br = bias + static_cast<long long>(rc) * ghw;
            const int yj = key / a.gw, xj = key - yj * a.gw;
            const float b = __fadd_rn(to_float(br[yj]), to_float(br[a.gh + xj]));
            x = a.folded ? __fmul_rn(__fadd_rn(x, b), a.scale)
                         : __fadd_rn(__fmul_rn(x, a.scale), b);
          }
          s[j][e] = x;
        }
      }
      float alpha[2] = {1.f, 1.f};
      if (!with_v || L::kF32) {  // the rows' running max and sum
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
          const float mn = fmaxf(m[i], quad_max(mx));  // finite: a chunk has a key < n
          const float c = -mn * kLog2e;
          float add = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float e0 = ex2(fmaf(s[j][2 * i], kLog2e, c));
            const float e1 = ex2(fmaf(s[j][2 * i + 1], kLog2e, c));
            if (L::kF32) {
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
      if (!with_v) continue;
      if constexpr (L::kF32) {
        // p (unnormalised, the running max) . v from zero, joined to o in
        // one rounded FMA.
        float pv[L::kTiles][4];
#pragma unroll
        for (int t = 0; t < L::kTiles; ++t) pv[t][0] = pv[t][1] = pv[t][2] = pv[t][3] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // The score columns (2 gq, 2 gq + 1) of tile j are the k slots
          // (gq, gq + 4) of p, the keys of v permuted alike.
          uint32_t ah[4], al[4];
          split(s[j][0], ah[0], al[0]);
          split(s[j][2], ah[1], al[1]);
          split(s[j][1], ah[2], al[2]);
          split(s[j][3], ah[3], al[3]);
          const T* vb = vs + (8 * j + 2 * gq) * vsd + gr;
#pragma unroll
          for (int t = 0; t < L::kTiles; ++t) {
            if (8 * t < cols) {
              uint32_t bh0, bl0, bh1, bl1;
              split(vb[8 * t], bh0, bl0);
              split(vb[vsd + 8 * t], bh1, bl1);
              mma_3xtf32(pv[t], ah, al, bh0, bh1, bl0, bl1);
            }
          }
        }
#pragma unroll
        for (int t = 0; t < L::kTiles; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[t][e] = fmaf(o[t][e], alpha[e >> 1], pv[t][e]);
      } else {
        // p = exp(s - m) / l in float32 with the rows' final m and l,
        // rounded to T, then p . v accumulated in o.
        using H = Half2<T>;
        const float c0r = -m[0] * kLog2e, c1r = -m[1] * kLog2e;
        const unsigned short* v16 = reinterpret_cast<const unsigned short*>(vs);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t pa[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* r = s[2 * kk + h];
            pa[2 * h] = H::pack(__fdiv_rn(ex2(fmaf(r[0], kLog2e, c0r)), l[0]),
                                __fdiv_rn(ex2(fmaf(r[1], kLog2e, c0r)), l[0]));
            pa[2 * h + 1] = H::pack(__fdiv_rn(ex2(fmaf(r[2], kLog2e, c1r)), l[1]),
                                    __fdiv_rn(ex2(fmaf(r[3], kLog2e, c1r)), l[1]));
          }
          const unsigned short* vb = v16 + (16 * kk + 2 * gq) * vsd + gr;
#pragma unroll
          for (int t = 0; t < L::kTiles; ++t) {
            if (8 * t < cols) {
              const unsigned short* p = vb + 8 * t;
              const uint32_t b0 = p[0] | static_cast<uint32_t>(p[vsd]) << 16;
              const uint32_t b1 = p[8 * vsd] | static_cast<uint32_t>(p[9 * vsd]) << 16;
              H::mma(o[t], pa, b0, b1);
            }
          }
        }
      }
    }
  }

  // The block's column part of its rows; skipped rows zero.
#pragma unroll
  for (int t = 0; t < L::kTiles; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = ra + 8 * (e >> 1), cc = 8 * t + 2 * gq + (e & 1);
      if (r < n && cc < cols) {
        float val = r < nq ? o[t][e] : 0.f;
        if (L::kF32) val = r < nq ? __fdiv_rn(val, l[e >> 1]) : 0.f;
        rows.out[rows.row(r) * rows.out_stride + c0 + cc] = from_float<T>(val);
      }
    }
  }
}

// Shared memory of a block of `warps` warps: q, k, v (and K6's halves).
template <typename T>
size_t general_smem(const GeneralArgs& a, int policy, int warps) {
  using L = GenTile<T>;
  const int hdp = (a.hd + L::kStep - 1) / L::kStep * L::kStep;
  const size_t dt = hdp < L::kDepth ? hdp : L::kDepth;
  size_t bytes = (16 * warps + kGenKeys) * (dt + L::kPad) * sizeof(T) +
                 static_cast<size_t>(kGenKeys) * (L::kPart + L::kPad) * sizeof(T);
  if (policy == kGenStrip) bytes += static_cast<size_t>(16 * warps) * 2 * a.gh * sizeof(float);
  return bytes;
}

template <typename T, int POL>
cudaError_t launch_general(const GeneralArgs& a, cudaStream_t stream) {
  using L = GenTile<T>;
  if (a.groups <= 0 || a.n <= 0) return cudaSuccess;
  if (a.groups > 0x7fffffffLL || a.hd <= 0 || a.vec < static_cast<int>(sizeof(T)))
    return cudaErrorInvalidValue;
  // Four warps, fewer where K6's halves of 64 rows leave no room.
  int warps = kGenMaxWarps;
  while (warps > 1 && general_smem<T>(a, POL, warps) > kMaxSmem) warps /= 2;
  const size_t smem = general_smem<T>(a, POL, warps);
  const long long row_blocks = (a.n + 16LL * warps - 1) / (16 * warps);
  const long long parts = (a.hd + L::kPart - 1) / L::kPart;
  if (smem > kMaxSmem || row_blocks > 65535 || parts > 65535) return cudaErrorInvalidValue;
  auto kernel = &attention_general_kernel<T, POL>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(a.groups), static_cast<unsigned>(row_blocks),
                  static_cast<unsigned>(parts));
  kernel<<<grid, 32 * warps, smem, stream>>>(a);
  return cudaGetLastError();
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
