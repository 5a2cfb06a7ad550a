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
// Element types: float32, bf16 and float16, the same bodies for each (a
// float16 row moves in 16-byte chunks of 8 values, as bf16). JAX treats
// float16 as it treats bf16: float32 statistics, the output rounded once,
// K3's s rounded to the dtype and read back. Float16 K3 runs the
// width-generic body at every width: in float16 ptxas spilled its C / 32
// values-a-lane instances (4 bytes at C = 768; asked for two blocks an SM,
// 32 bytes at C = 1024).
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
// cudaErrorInvalidValue otherwise (the Python wrapper makes every operand
// dense and aligned first, ops/cuda_build.py `kernel_operand`).
//
// K3 keeps the earlier design at those widths: one warp per row, VPL =
// C / 32 values per lane (lane l owns columns l, l + 32, ...), in blocks
// of 8 warps.
//
// Any other width C >= 1 (the JAX kernels take any C) runs a width-generic
// body, for K1 and K3 alike (`ADD`), the C of a call a kernel argument:
// a row is nch = ceil(C sizeof(T) / 16) chunks, the last of them partial
// where C sizeof(T) is not a multiple of 16: its columns past C load as
// zeros and are not stored (scale and bias likewise), and the statistics
// take the true C. At small C a row's one-pass variance can be a tiny
// difference of two large terms (3 close values: var ~1e-6 of E[x^2]), so
// the statistics are formed with the plain version's roundings: a mean is
// the sum times float32(1 / C) (as XLA forms JAX's jnp.mean), the squares
// and mean^2 are rounded before they are summed and subtracted (no fused
// multiply-add), and a lane sums its values in order, as the CPU sums a
// short row. (The instances of KERNEL_WIDTHS keep their arithmetic, which
// at their widths moves the output by far less.) Such a row does not start
// on 16 bytes, so its
// chunks are read and written value by value; a row whose bytes are a
// multiple of 16 moves whole chunks. Rows of up to 32 kLnMaxChunksPerLane
// chunks run `layer_norm_any_kernel`: K1's lanes rule and launch plan, the
// fewest of 4, 8, 16, 32 lanes that hold the row in at most
// kLnMaxChunksPerLane chunks a lane (a lane's chunks past nch are zeros).
// Wider rows (bf16 above 1280, float32 above 640) run
// `layer_norm_wide_kernel`: a block of kLnWideThreads threads a row, the
// sums reduced over its warps through shared memory, the row read a second
// time (from L2) to normalise it. With ADD the body forms s = x + d rounded
// to the dtype, writes it and normalises it; K1 on that s runs the same
// body in the same order of summation, so at these widths K3 equals x + d
// followed by K1 bit for bit. These bodies are right first; their speed is
// later work.
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

// A 16-byte chunk of a row as float32 values (4 float32, or 8 bf16 or
// float16).
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

template <> struct Chunk<__half> {
  static constexpr int kValues = 8;
  // The value at the lower address is the word's low half.
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  static __device__ __forceinline__ unsigned pack2(float lo, float hi) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
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

// The widths with instances of their own (ops/fused_norm.py
// KERNEL_WIDTHS): K1's LayerNormWidth and K3's VPL = C / 32 kernels.
#define DLIMG_LN_WIDTHS(X) X(128) X(160) X(256) X(320) X(768) X(1024) X(1280)

bool instance_width(int cols) {
  switch (cols) {
#define DLIMG_LN_CASE(C) case C:
    DLIMG_LN_WIDTHS(DLIMG_LN_CASE)
#undef DLIMG_LN_CASE
    return true;
    default:
      return false;
  }
}

// f(LayerNormWidth<T, C>{}) for a width C of KERNEL_WIDTHS; other widths
// are refused (the caller takes the width-generic bodies for them).
template <typename T, typename F>
cudaError_t with_width(int cols, F f) {
  switch (cols) {
#define DLIMG_LN_WIDTH(C) \
  case C:                 \
    return f(LayerNormWidth<T, C>{});
    DLIMG_LN_WIDTHS(DLIMG_LN_WIDTH)
#undef DLIMG_LN_WIDTH
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t with_type_and_width(int dtype, int cols, F f) {
  if (dtype == kDtypeF32) return with_width<float>(cols, f);
  if (dtype == kDtypeBF16) return with_width<__nv_bfloat16>(cols, f);
  if (dtype == kDtypeF16) return with_width<__half>(cols, f);
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
#define DLIMG_LN_CASE(C)                                                              \
  case C:                                                                             \
    return launch_add_layer_norm<T, C / 32>(x, d, scale, bias, s_out, out, rows, eps, \
                                            stream);
    DLIMG_LN_WIDTHS(DLIMG_LN_CASE)
#undef DLIMG_LN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K1 and K3 at any other width
// ---------------------------------------------------------------------------

constexpr int kLnWideThreads = 256;
constexpr int kLnWideBlocksPerSm = 8;

// The raw bits of a value of T.
template <typename T> struct Bits;
template <> struct Bits<float> { using B = uint32_t; };
template <> struct Bits<__nv_bfloat16> { using B = uint16_t; };
template <> struct Bits<__half> { using B = uint16_t; };

// Columns c0 .. c0 + 16 / sizeof(T) - 1 of a row as a packed chunk (the
// layout Chunk<T> unpacks): zeros past C. `vec`: C sizeof(T) is a multiple
// of 16 and the row starts on 16 bytes, so the chunk is one 16-byte load.
template <typename T>
__device__ __forceinline__ uint4 load_chunk_masked(const T* __restrict__ row, int c0, int C,
                                                   bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(row + c0);
  using B = typename Bits<T>::B;
  constexpr int N = 16 / sizeof(T), PER = 4 / sizeof(T);  // values a 32-bit word
  const B* r = reinterpret_cast<const B*>(row);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (c0 + k < C) w[k / PER] |= static_cast<uint32_t>(r[c0 + k]) << (32 / PER * (k % PER));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Stores the columns below C of a packed chunk at c0.
template <typename T>
__device__ __forceinline__ void store_chunk_masked(T* __restrict__ row, int c0, int C, bool vec,
                                                   const uint4& u) {
  if (vec) {
    *reinterpret_cast<uint4*>(row + c0) = u;
    return;
  }
  using B = typename Bits<T>::B;
  constexpr int N = 16 / sizeof(T), PER = 4 / sizeof(T);
  B* r = reinterpret_cast<B*>(row);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (c0 + k < C) r[c0 + k] = static_cast<B>(w[k / PER] >> (32 / PER * (k % PER)));
}

// The chunk at c0 of the row at `base` as the body normalises it: x, or
// with ADD s = x + d rounded to T (written to s_out when `write`).
template <typename T, bool ADD>
__device__ __forceinline__ uint4 row_chunk(const T* __restrict__ x, const T* __restrict__ d,
                                           T* __restrict__ s_out, size_t base, int c0, int C,
                                           bool vec, bool write) {
  const uint4 u = load_chunk_masked(x + base, c0, C, vec);
  if constexpr (!ADD) {
    return u;
  } else {
    using V = Chunk<T>;
    float a[V::kValues], b[V::kValues];
    V::unpack(u, a);
    V::unpack(load_chunk_masked(d + base, c0, C, vec), b);
#pragma unroll
    for (int k = 0; k < V::kValues; ++k) a[k] += b[k];
    const uint4 s = V::pack(a);
    if (write) store_chunk_masked(s_out + base, c0, C, vec, s);
    return s;
  }
}

// (x - mean) inv scale + bias of one chunk, stored below C.
template <typename T>
__device__ __forceinline__ void normalize_chunk(const uint4& u, const T* __restrict__ scale,
                                                const T* __restrict__ bias, T* __restrict__ orow,
                                                int c0, int C, bool vec, float mean, float inv) {
  using V = Chunk<T>;
  float f[V::kValues], a[V::kValues], b[V::kValues];
  V::unpack(u, f);
  V::unpack(load_chunk_masked(scale, c0, C, vec), a);
  V::unpack(load_chunk_masked(bias, c0, C, vec), b);
#pragma unroll
  for (int k = 0; k < V::kValues; ++k) f[k] = (f[k] - mean) * inv * a[k] + b[k];
  store_chunk_masked(orow, c0, C, vec, V::pack(f));
}

// Rows of up to L kLnMaxChunksPerLane chunks: L lanes a row, 32 / L rows a
// warp, row groups walked at a stride of the grid's warps (K1's plan).
template <typename T, int L, bool ADD>
__global__ void __launch_bounds__(kLnMaxWarpsPerBlock * 32)
layer_norm_any_kernel(const T* __restrict__ x, const T* __restrict__ d,
                      const T* __restrict__ scale, const T* __restrict__ bias,
                      T* __restrict__ s_out, T* __restrict__ out, int rows, int C,
                      int vec_rows, float eps) {
  using V = Chunk<T>;
  constexpr int N = V::kValues;
  constexpr int CPL = kLnMaxChunksPerLane;
  constexpr int kRowsPerWarp = 32 / L;
  const bool vec = vec_rows != 0;
  const int lane = threadIdx.x % 32;
  const int sub = lane / L, gl = lane % L;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int warps = gridDim.x * blockDim.x / 32;
  const int groups = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
  const int nch = (C + N - 1) / N;
  const float inv_c = 1.f / static_cast<float>(C);
  for (int g = warp; g < groups; g += warps) {  // uniform over the warp
    const int row = g * kRowsPerWarp + sub;
    const bool live = row < rows;
    const size_t base = static_cast<size_t>(live ? row : 0) * C;
    uint4 v[CPL];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int ch = gl + L * j;
      v[j] = live && ch < nch ? row_chunk<T, ADD>(x, d, s_out, base, ch * N, C, vec, true)
                              : make_uint4(0u, 0u, 0u, 0u);
      float f[N];
      V::unpack(v[j], f);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        s += f[k];
        s2 += __fmul_rn(f[k], f[k]);  // rounded squares, as the plain version's
      }
    }
    s = group_sum<L>(s);
    s2 = group_sum<L>(s2);
    const float mean = s * inv_c;
    const float var = fmaxf(__fsub_rn(s2 * inv_c, __fmul_rn(mean, mean)), 0.f);
    const float inv = rsqrtf(var + eps);
    if (!live) continue;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int ch = gl + L * j;
      if (ch < nch) normalize_chunk(v[j], scale, bias, out + base, ch * N, C, vec, mean, inv);
    }
  }
}

// Wider rows: a block of kLnWideThreads a row (rows walked at a stride of
// the grid), thread t taking chunks t, t + kLnWideThreads, ...; the sums
// reduced over the warps in shared memory in warp order, the row read again
// to normalise it (with ADD, s formed again from x + d: the same values).
template <typename T, bool ADD>
__global__ void __launch_bounds__(kLnWideThreads)
layer_norm_wide_kernel(const T* __restrict__ x, const T* __restrict__ d,
                       const T* __restrict__ scale, const T* __restrict__ bias,
                       T* __restrict__ s_out, T* __restrict__ out, int rows, int C,
                       int vec_rows, float eps) {
  using V = Chunk<T>;
  constexpr int N = V::kValues;
  constexpr int W = kLnWideThreads / 32;
  __shared__ float red[2][W];
  const bool vec = vec_rows != 0;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nch = (C + N - 1) / N;
  const float inv_c = 1.f / static_cast<float>(C);
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t base = static_cast<size_t>(row) * C;
    float s = 0.f, s2 = 0.f;
    for (int ch = tid; ch < nch; ch += kLnWideThreads) {
      float f[N];
      V::unpack(row_chunk<T, ADD>(x, d, s_out, base, ch * N, C, vec, true), f);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        s += f[k];
        s2 += __fmul_rn(f[k], f[k]);
      }
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) {
      red[0][warp] = s;
      red[1][warp] = s2;
    }
    __syncthreads();
    s = 0.f;
    s2 = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      s += red[0][w];
      s2 += red[1][w];
    }
    __syncthreads();  // red is written again for the next row
    const float mean = s * inv_c;
    const float var = fmaxf(__fsub_rn(s2 * inv_c, __fmul_rn(mean, mean)), 0.f);
    const float inv = rsqrtf(var + eps);
    for (int ch = tid; ch < nch; ch += kLnWideThreads)
      normalize_chunk(row_chunk<T, ADD>(x, d, s_out, base, ch * N, C, vec, false), scale, bias,
                      out + base, ch * N, C, vec, mean, inv);
  }
}

// The lanes a row of `cols` values of `size` bytes takes in
// layer_norm_any_kernel (K1's rule), or 0 for layer_norm_wide_kernel.
int any_lanes(int cols, int size) {
  const long long chunks = (static_cast<long long>(cols) * size + 15) / 16;
  for (int l = 4; l <= 32; l *= 2)
    if ((chunks + l - 1) / l <= kLnMaxChunksPerLane) return l;
  return 0;
}

// The width-generic bodies at (T, ADD): the plan and one launch.
template <typename T, bool ADD>
struct AnyWidth {
  template <int L>
  static LnPlan lanes_plan(int rows) {
    static const int sms = device_sms();
    static const int resident = [] {
      int blocks = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, layer_norm_any_kernel<T, L, ADD>, kLnMaxWarpsPerBlock * 32, 0);
      return blocks * kLnMaxWarpsPerBlock;
    }();
    const int wave = resident < kLnWaveWarpsPerSm ? resident : kLnWaveWarpsPerSm;
    return ln_plan(rows, L, sms > 0 ? sms : 1, wave > 0 ? wave : 1);
  }

  // plan[0] = 0 and one block of kLnWideThreads a row for the wide body.
  static LnPlan plan(int rows, int cols) {
    switch (any_lanes(cols, sizeof(T))) {
      case 4: return lanes_plan<4>(rows);
      case 8: return lanes_plan<8>(rows);
      case 16: return lanes_plan<16>(rows);
      case 32: return lanes_plan<32>(rows);
      default: {
        static const int sms = device_sms();
        const int most = (sms > 0 ? sms : 1) * kLnWideBlocksPerSm;
        LnPlan p{};
        p.warps_per_block = kLnWideThreads / 32;
        p.blocks = rows < most ? rows : most;
        p.groups_per_warp = (rows + p.blocks - 1) / p.blocks;  // rows a block
        return p;
      }
    }
  }

  template <int L>
  static void launch_lanes(const LnPlan& p, const T* x, const T* d, const T* scale,
                           const T* bias, T* s_out, T* out, int rows, int cols, int vec,
                           float eps, cudaStream_t stream) {
    layer_norm_any_kernel<T, L, ADD><<<p.blocks, p.warps_per_block * 32, 0, stream>>>(
        x, d, scale, bias, s_out, out, rows, cols, vec, eps);
  }

  static cudaError_t launch(const void* x, const void* d, const void* scale, const void* bias,
                            void* s_out, void* out, int rows, int cols, float eps,
                            cudaStream_t stream) {
    const LnPlan p = plan(rows, cols);
    const T *xt = static_cast<const T*>(x), *dt = static_cast<const T*>(d);
    const T *st = static_cast<const T*>(scale), *bt = static_cast<const T*>(bias);
    T *so = static_cast<T*>(s_out), *ot = static_cast<T*>(out);
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(d) |
                           reinterpret_cast<uintptr_t>(scale) |
                           reinterpret_cast<uintptr_t>(bias) |
                           reinterpret_cast<uintptr_t>(s_out) | reinterpret_cast<uintptr_t>(out);
    const int vec = cols % Chunk<T>::kValues == 0 && ptrs % 16 == 0;
    switch (p.lanes) {
      case 4: launch_lanes<4>(p, xt, dt, st, bt, so, ot, rows, cols, vec, eps, stream); break;
      case 8: launch_lanes<8>(p, xt, dt, st, bt, so, ot, rows, cols, vec, eps, stream); break;
      case 16: launch_lanes<16>(p, xt, dt, st, bt, so, ot, rows, cols, vec, eps, stream); break;
      case 32: launch_lanes<32>(p, xt, dt, st, bt, so, ot, rows, cols, vec, eps, stream); break;
      default:
        layer_norm_wide_kernel<T, ADD><<<p.blocks, kLnWideThreads, 0, stream>>>(
            xt, dt, st, bt, so, ot, rows, cols, vec, eps);
    }
    return cudaGetLastError();
  }
};

template <bool ADD, typename F>
cudaError_t with_any_width(int dtype, F f) {
  if (dtype == kDtypeF32) return f(AnyWidth<float, ADD>{});
  if (dtype == kDtypeBF16) return f(AnyWidth<__nv_bfloat16, ADD>{});
  if (dtype == kDtypeF16) return f(AnyWidth<__half, ADD>{});
  return cudaErrorInvalidValue;
}

}  // namespace dlimg

// K1: out = LN(x) over rows of `cols` values. The widths of KERNEL_WIDTHS
// run their own instances, any other cols >= 1 the width-generic bodies.
// Every pointer must start on 16 bytes.
extern "C" int dlimg_layer_norm(const void* x, const void* scale, const void* bias,
                                void* out, int rows, int cols, int dtype,
                                float eps, void* stream) {
  using namespace dlimg;
  if (rows <= 0) return 0;
  if (cols <= 0 || !aligned16(x) || !aligned16(scale) || !aligned16(bias) ||
      !aligned16(out))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!instance_width(cols))
    return with_any_width<false>(dtype, [&](auto w) {
      return decltype(w)::launch(x, x, scale, bias, out, out, rows, cols, eps, s);
    });
  return with_type_and_width(dtype, cols, [&](auto width) {
    return decltype(width)::launch(x, scale, bias, out, rows, eps, s);
  });
}

// K1's launch plan for (rows, cols, dtype): plan[0..4] = lanes a row, rows
// a warp, warps a block, blocks, row groups a warp; for rows too wide for
// a warp's registers (the width-generic wide body) lanes a row = 0, then
// 0, warps a block, blocks, rows a block.
extern "C" int dlimg_layer_norm_plan(int rows, int cols, int dtype, int* plan) {
  using namespace dlimg;
  if (rows <= 0 || cols <= 0 || plan == nullptr) return cudaErrorInvalidValue;
  auto write = [&](const LnPlan& p) {
    const int v[5] = {p.lanes, p.rows_per_warp, p.warps_per_block, p.blocks,
                      p.groups_per_warp};
    for (int i = 0; i < 5; ++i) plan[i] = v[i];
    return cudaGetLastError();
  };
  if (!instance_width(cols))
    return with_any_width<false>(dtype, [&](auto w) {
      return write(decltype(w)::plan(rows, cols));
    });
  return with_type_and_width(dtype, cols, [&](auto width) {
    return write(decltype(width)::plan(rows));
  });
}

// K3: s_out = x + d (rounded to the dtype), out = LN(s_out). The widths of
// KERNEL_WIDTHS take any alignment; the width-generic bodies (every width in
// float16) move 16-byte chunks only where every pointer starts on 16 bytes.
extern "C" int dlimg_add_layer_norm(const void* x, const void* d, const void* scale,
                                    const void* bias, void* s_out, void* out,
                                    int rows, int cols, int dtype, float eps,
                                    void* stream) {
  using namespace dlimg;
  if (d == nullptr) return cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  if (cols <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!instance_width(cols) || dtype == kDtypeF16)
    return with_any_width<true>(dtype, [&](auto w) {
      return decltype(w)::launch(x, d, scale, bias, s_out, out, rows, cols, eps, s);
    });
  if (dtype == kDtypeF32)
    return dispatch_add_layer_norm<float>(x, d, scale, bias, s_out, out, rows, cols,
                                          eps, s);
  if (dtype == kDtypeBF16)
    return dispatch_add_layer_norm<__nv_bfloat16>(x, d, scale, bias, s_out, out,
                                                  rows, cols, eps, s);
  return cudaErrorInvalidValue;
}
