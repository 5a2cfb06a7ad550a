// K1: LayerNorm over the last axis, one-pass statistics, and
// K3: residual add + LayerNorm in one pass.
//
// K1 replaces the TPU kernel dlimgedit_tpu/ops/fused_norm.py:64
// `fused_layer_norm` (Pallas body `_ln_kernel`, :20). Same function:
// mean and mean of squares in float32 in one pass over the row,
// var = max(E[x^2] - E[x]^2, 0), y = (x - mean) * rsqrt(var + eps), then
// the affine, written in the activation dtype.
//
// K3 replaces dlimgedit_tpu/ops/fused_norm.py:98 `fused_add_layer_norm`
// (Pallas body `_add_ln_kernel`, :30): s = x + d is summed in float32,
// rounded to the activation dtype and written (it is the residual stream),
// and the statistics are taken on the ROUNDED s, so (s, LN(s)) bit-match
// the plain `x + d` followed by K1.
//
// What bounds both on an H100: bytes. K1 reads each row and writes it once,
// and reads scale and bias once: (2 * rows * C + 2 * C) * sizeof(T) bytes
// at 3.35 TB/s (a (1372, 1280) bf16 call: 7.03 MB, 2.10 us). K3 reads x and
// d and writes s and y (4 * C * sizeof(T) a row). Either does about 8 C
// float operations per row, far below the ~295 operations per byte where
// the tensor cores would become the limit. At the main path's sizes (0.3-18
// MB) the launch (~2 us back to back, ~1 us a kernel in a CUDA graph) and
// one round trip to memory are as large as the bytes' time, so the design
// aims at few instructions, every load in flight at once, and an even
// spread over the SMs.
//
// K1's design. A row is cut into 16-byte chunks (8 bf16 or 4 float32
// values), C * sizeof(T) / 16 of them; every width of KERNEL_WIDTHS makes a
// whole number. A group of L lanes of one warp holds a row, each lane CPL
// chunks, so a warp holds 32 / L rows at a time; lane l of a group owns
// chunks l, l + L, ..., the same columns in every row, so one warp-wide
// load or store touches L * 16 contiguous bytes of each of its rows, and
// the lane loads its scale and bias chunks into registers once, before its
// first row. L is the fewest of 4, 8, 16, 32 lanes that hold a row in at
// most 5 chunks a lane (else the most that divide it): bf16 C = 128, 160, 256, 320, 768, 1024,
// 1280 take L = 4, 4, 8, 8, 32, 32, 32 (4, 5, 4, 5, 3, 4, 5 chunks a
// lane); float32 L = 8, 8, 16, 16, 32, 32, 32 (4, 5, 4, 5, 6, 8, 10). The
// sums are reduced with __shfl_xor_sync over the group's lanes only; no
// shared memory, no block barrier.
//
// The launch plan (`ln_plan`; dlimg_layer_norm_plan returns it): a row
// group is a warp's 32 / L rows; a wave is the warps the SMs hold at once
// at the kernel's register count (at most 32 an SM; nvcc keeps each lane's
// scale and bias as float32 in registers, so the bf16 kernels take 127-168
// registers and an SM holds 12-16 of their warps). Rows that need more
// groups than a wave holds are walked by each warp, groups_per_warp of them
// at a stride of the grid's warps, the next group's loads issued before
// the current group is reduced. Blocks hold 4, 2 or 1 warps, the largest of
// these whose fullest SM (blocks dealt evenly over the SMs) holds as few
// warps as any of them: 1372 rows of 1280 take 1372 one-warp blocks, where
// the earlier 8-warp blocks left 40 SMs two blocks and the others one.
// Main-path plans on an H100 (132 SMs), bf16, as (L, rows a warp, warps a
// block, blocks, row groups a warp):
//   (1372, 1280): (32, 1, 1, 1372, 1)   (2548, 1280): (32, 1, 2, 637, 2)
//   (1372, 768):  (32, 1, 1, 1372, 1)   (2548, 768):  (32, 1, 2, 637, 2)
//   (4096, 1280): (32, 1, 1, 1366, 3)   (4096, 768):  (32, 1, 4, 512, 2)
//   (17689, 128): (4, 8, 1, 1106, 2)    (16384, 128): (4, 8, 4, 512, 1)
//   (4900, 160):  (4, 8, 1, 613, 1)     (4096, 160):  (4, 8, 4, 128, 1)
//   (4900, 320):  (8, 4, 2, 613, 1)     (4096, 256):  (8, 4, 4, 256, 1)
//   (70756, 128): (4, 8, 2, 885, 5)
// (tools/sweep_layer_norm.py and chip_smoke.py print them). Other block
// sizes, waves of 16 warps an SM, 2 or 8 chunks a lane, and programmatic
// dependent launch measured no better behind another kernel (PERF.md, PR
// 23). The TPU kernel's power-of-two row blocking (`_row_blocking`, a
// Mosaic tiling constraint) does not carry over: a partial row group
// computes on zeros and stores nothing.
//
// Every pointer must be 16-byte aligned: the entry point returns
// cudaErrorInvalidValue otherwise (the Python wrapper raises first).
//
// K3 keeps the earlier design: one warp per row, VPL = C / 32 values per
// lane (lane l owns columns l, l + 32, ...), in blocks of 8 warps.
#include <cstdint>

#include "common.cuh"

namespace dlimg {

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

constexpr int kLnMaxWarpsPerBlock = 4;
constexpr int kLnMinWarpsPerBlock = 1;
constexpr int kLnWaveWarpsPerSm = 32;
constexpr int kLnMaxChunksPerLane = 5;

// A 16-byte chunk of a row as float32 values.
template <typename T> struct Chunk;

template <> struct Chunk<float> {
  static constexpr int kValues = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <> struct Chunk<__nv_bfloat16> {
  static constexpr int kValues = 8;
  // The value at the lower address is the word's low half.
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ unsigned pack2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return (static_cast<unsigned>(__bfloat16_as_ushort(h.y)) << 16) |
           __bfloat16_as_ushort(h.x);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[8]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

// Sum over the L lanes of a group (aligned groups of L lanes of the warp).
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// The lane's CPL chunks of `row` (zeros past the last row).
template <int L, int CPL>
__device__ __forceinline__ void load_chunks(const uint4* __restrict__ x, int row,
                                            int rows, int gl, uint4 (&v)[CPL]) {
  if (row < rows) {
    const uint4* xr = x + static_cast<size_t>(row) * (L * CPL) + gl;
#pragma unroll
    for (int j = 0; j < CPL; ++j) v[j] = xr[L * j];
  } else {
#pragma unroll
    for (int j = 0; j < CPL; ++j) v[j] = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int L, int CPL>
__global__ void __launch_bounds__(kLnMaxWarpsPerBlock * 32)
layer_norm_kernel(const uint4* __restrict__ x, const uint4* __restrict__ scale,
                  const uint4* __restrict__ bias, uint4* __restrict__ out,
                  int rows, float eps) {
  using V = Chunk<T>;
  constexpr int N = V::kValues;
  constexpr int C = L * CPL * N;
  constexpr int kRowsPerWarp = 32 / L;
  const int lane = threadIdx.x % 32;
  const int sub = lane / L;  // the warp's row this lane works on
  const int gl = lane % L;   // the lane's place in its group
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int warps = gridDim.x * blockDim.x / 32;
  const int groups = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
  if (warp >= groups) return;  // whole warps leave together
  uint4 sc[CPL], bi[CPL], cur[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    sc[j] = scale[gl + L * j];
    bi[j] = bias[gl + L * j];
  }
  load_chunks<L, CPL>(x, warp * kRowsPerWarp + sub, rows, gl, cur);
  for (int g = warp; g < groups; g += warps) {  // uniform over the warp
    const int row = g * kRowsPerWarp + sub;
    const bool more = g + warps < groups;
    uint4 nxt[CPL];
    if (more) load_chunks<L, CPL>(x, row + warps * kRowsPerWarp, rows, gl, nxt);
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      float f[N];
      V::unpack(cur[j], f);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        s += f[k];
        s2 += f[k] * f[k];
      }
    }
    s = group_sum<L>(s);
    s2 = group_sum<L>(s2);
    const float mean = s / C;
    const float var = fmaxf(s2 / C - mean * mean, 0.f);
    const float inv = rsqrtf(var + eps);
    if (row < rows) {
      uint4* orow = out + static_cast<size_t>(row) * (L * CPL) + gl;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        float f[N], a[N], b[N];
        V::unpack(cur[j], f);
        V::unpack(sc[j], a);
        V::unpack(bi[j], b);
#pragma unroll
        for (int k = 0; k < N; ++k) f[k] = (f[k] - mean) * inv * a[k] + b[k];
        orow[L * j] = V::pack(f);
      }
    }
    if (more) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) cur[j] = nxt[j];
    }
  }
}

// The fewest of 4, 8, 16, 32 lanes that hold `chunks` in at most
// kLnMaxChunksPerLane chunks a lane; else the most of them that divide it.
constexpr int ln_lanes(int chunks) {
  int most = 0;
  for (int l = 4; l <= 32; l *= 2) {
    if (chunks % l != 0) continue;
    if (chunks / l <= kLnMaxChunksPerLane) return l;
    most = l;
  }
  return most;
}

struct LnPlan {
  int lanes, rows_per_warp, warps_per_block, blocks, groups_per_warp;
};

LnPlan ln_plan(int rows, int lanes, int sms, int wave_warps_per_sm) {
  LnPlan p{};
  p.lanes = lanes;
  p.rows_per_warp = 32 / lanes;
  const int groups = (rows + p.rows_per_warp - 1) / p.rows_per_warp;
  const int wave = sms * wave_warps_per_sm;
  p.groups_per_warp = (groups + wave - 1) / wave;
  const int warps = (groups + p.groups_per_warp - 1) / p.groups_per_warp;
  int fullest = 0;
  for (int w = kLnMaxWarpsPerBlock; w >= kLnMinWarpsPerBlock; w /= 2) {
    const int most = (warps + sms * w - 1) / (sms * w) * w;
    if (fullest == 0 || most < fullest) {
      fullest = most;
      p.warps_per_block = w;
    }
  }
  p.blocks = (warps + p.warps_per_block - 1) / p.warps_per_block;
  return p;
}

int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// K1 at width C: its lanes and chunks, and the warps an SM holds at once
// (kLnWaveWarpsPerSm, or fewer where the kernel's registers allow fewer).
// The SM count and the occupancy are those of the first device that asks.
template <typename T, int C>
struct LayerNormWidth {
  static constexpr int kChunks = C * static_cast<int>(sizeof(T)) / 16;
  static constexpr int kLanes = ln_lanes(kChunks);
  static constexpr int kPerLane = kChunks / kLanes;
  static_assert(kLanes > 0 && kLanes * kPerLane == kChunks,
                "a row must fill its lanes");

  static LnPlan plan(int rows) {
    static const int sms = device_sms();
    static const int resident = [] {
      int blocks = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, layer_norm_kernel<T, kLanes, kPerLane>,
          kLnMaxWarpsPerBlock * 32, 0);
      return blocks * kLnMaxWarpsPerBlock;
    }();
    const int wave = resident < kLnWaveWarpsPerSm ? resident : kLnWaveWarpsPerSm;
    return ln_plan(rows, kLanes, sms > 0 ? sms : 1, wave > 0 ? wave : 1);
  }

  static cudaError_t launch(const void* x, const void* scale, const void* bias,
                            void* out, int rows, float eps, cudaStream_t stream) {
    const LnPlan p = plan(rows);
    layer_norm_kernel<T, kLanes, kPerLane>
        <<<p.blocks, p.warps_per_block * 32, 0, stream>>>(
            static_cast<const uint4*>(x), static_cast<const uint4*>(scale),
            static_cast<const uint4*>(bias), static_cast<uint4*>(out), rows, eps);
    return cudaGetLastError();
  }
};

// f(LayerNormWidth<T, C>{}) for a width C of KERNEL_WIDTHS; other widths
// are refused.
template <typename T, typename F>
cudaError_t with_width(int cols, F f) {
  switch (cols) {
#define DLIMG_LN_WIDTH(C) \
  case C:                 \
    return f(LayerNormWidth<T, C>{});
    DLIMG_LN_WIDTH(128)
    DLIMG_LN_WIDTH(160)
    DLIMG_LN_WIDTH(256)
    DLIMG_LN_WIDTH(320)
    DLIMG_LN_WIDTH(768)
    DLIMG_LN_WIDTH(1024)
    DLIMG_LN_WIDTH(1280)
#undef DLIMG_LN_WIDTH
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t with_type_and_width(int dtype, int cols, F f) {
  if (dtype == kDtypeF32) return with_width<float>(cols, f);
  if (dtype == kDtypeBF16) return with_width<__nv_bfloat16>(cols, f);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

constexpr int kLnWarpsPerBlock = 8;

// Normalises one row held as v[i] = row[lane + 32 i] and writes the affine
// result to orow.
template <typename T, int VPL>
__device__ __forceinline__ void normalize_row(const float (&v)[VPL], int lane,
                                              const T* __restrict__ scale,
                                              const T* __restrict__ bias,
                                              T* __restrict__ orow, float eps) {
  constexpr int C = VPL * 32;
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    s += v[i];
    s2 += v[i] * v[i];
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = s / C;
  const float var = fmaxf(s2 / C - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    const float y = (v[i] - mean) * inv;
    orow[c] = from_float<T>(y * to_float(scale[c]) + to_float(bias[c]));
  }
}

template <typename T, int VPL>
__global__ void __launch_bounds__(kLnWarpsPerBlock * 32)
add_layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ d,
                      const T* __restrict__ scale, const T* __restrict__ bias,
                      T* __restrict__ s_out, T* __restrict__ out, int rows,
                      float eps) {
  constexpr int C = VPL * 32;
  const int row = blockIdx.x * kLnWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * C;
  float v[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const size_t c = base + lane + 32 * i;
    const T s = from_float<T>(to_float(x[c]) + to_float(d[c]));
    s_out[c] = s;
    v[i] = to_float(s);  // statistics of the rounded sum
  }
  normalize_row<T, VPL>(v, lane, scale, bias, out + base, eps);
}

// One launch of K3 for rows of width VPL * 32.
template <typename T, int VPL>
cudaError_t launch_add_layer_norm(const void* x, const void* d, const void* scale,
                                  const void* bias, void* s_out, void* out,
                                  int rows, float eps, cudaStream_t stream) {
  const int blocks = (rows + kLnWarpsPerBlock - 1) / kLnWarpsPerBlock;
  add_layer_norm_kernel<T, VPL><<<blocks, kLnWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(d),
      static_cast<const T*>(scale), static_cast<const T*>(bias),
      static_cast<T*>(s_out), static_cast<T*>(out), rows, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_add_layer_norm(const void* x, const void* d, const void* scale,
                                    const void* bias, void* s_out, void* out,
                                    int rows, int cols, float eps,
                                    cudaStream_t stream) {
  switch (cols) {
#define DLIMG_LN_CASE(VPL)                                                        \
  case VPL * 32:                                                                  \
    return launch_add_layer_norm<T, VPL>(x, d, scale, bias, s_out, out, rows, eps, \
                                         stream);
    DLIMG_LN_CASE(4)
    DLIMG_LN_CASE(5)
    DLIMG_LN_CASE(8)
    DLIMG_LN_CASE(10)
    DLIMG_LN_CASE(24)
    DLIMG_LN_CASE(32)
    DLIMG_LN_CASE(40)
#undef DLIMG_LN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace dlimg

// Widths the kernels are instantiated for; the Python wrappers check
// against the same list (ops/fused_norm.py KERNEL_WIDTHS).
extern "C" int dlimg_layer_norm(const void* x, const void* scale, const void* bias,
                                void* out, int rows, int cols, int dtype,
                                float eps, void* stream) {
  using namespace dlimg;
  if (rows <= 0) return 0;
  if (!aligned16(x) || !aligned16(scale) || !aligned16(bias) || !aligned16(out))
    return cudaErrorInvalidValue;
  return with_type_and_width(dtype, cols, [&](auto width) {
    return decltype(width)::launch(x, scale, bias, out, rows, eps,
                                   static_cast<cudaStream_t>(stream));
  });
}

// K1's launch plan for (rows, cols, dtype): plan[0..4] = lanes a row, rows
// a warp, warps a block, blocks, row groups a warp.
extern "C" int dlimg_layer_norm_plan(int rows, int cols, int dtype, int* plan) {
  using namespace dlimg;
  if (rows <= 0 || plan == nullptr) return cudaErrorInvalidValue;
  return with_type_and_width(dtype, cols, [&](auto width) {
    const LnPlan p = decltype(width)::plan(rows);
    const int v[5] = {p.lanes, p.rows_per_warp, p.warps_per_block, p.blocks,
                      p.groups_per_warp};
    for (int i = 0; i < 5; ++i) plan[i] = v[i];
    return cudaGetLastError();
  });
}

// K3: s_out = x + d (rounded to the dtype), out = LN(s_out).
extern "C" int dlimg_add_layer_norm(const void* x, const void* d, const void* scale,
                                    const void* bias, void* s_out, void* out,
                                    int rows, int cols, int dtype, float eps,
                                    void* stream) {
  using namespace dlimg;
  if (d == nullptr) return cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return dispatch_add_layer_norm<float>(x, d, scale, bias, s_out, out, rows, cols,
                                          eps, s);
  if (dtype == kDtypeBF16)
    return dispatch_add_layer_norm<__nv_bfloat16>(x, d, scale, bias, s_out, out,
                                                  rows, cols, eps, s);
  return cudaErrorInvalidValue;
}
