// P1: exact greedy box NMS over score-sorted candidates (automatic mask
// generation's pool).
//
// Replaces the `lax.fori_loop` of dlimgedit_tpu/ops/amg.py:175-180
// (`greedy_nms`). That loop is not a Pallas kernel: XLA runs it as M
// dependent steps over the rows of an (M, M) IoU matrix. Written in PyTorch
// it is three or four small launches a row (~7000 nodes of a CUDA graph at
// M = 2304) for a few kilobytes of data.
//
// The earlier design was one block of 1024 threads walking the M
// rows in order: each kept row cost a barrier of the whole block and a pass
// of ceil(M / 1024) IoU tests a thread. At AMG's M = 2304 that took 1.47160
// ms over phase 7's 3 launches, ~0.49 ms a launch, ~210 ns a row
// (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): M dependent barriers of
// 1024 threads, not the work, bound it.
//
// Design: two launches on the caller's stream, one call of the wrapper
// (ops/amg.py `greedy_nms` counts the call), both capturable in AMG's CUDA
// graph. The scratch is the wrapper's (`torch.empty` on the device, so from
// the graph's pool inside a capture): nw = ceil(M / 64) words of 64 bits a
// row, rows padded to 64 nw, the row stride rounded up to an even number of
// words (16-byte rows for cp.async), then nw words of live flags.
//  1. `greedy_nms_mask_kernel`, a 2-D grid of 256-thread blocks, one per
//     (64-row block rb, 64-column word w >= rb): four threads a row i,
//     sixteen columns each, set the bits of the j in word w with j > i and
//     IoU(i, j) > thresh, and two shuffles join the row's word. The
//     diagonal blocks also write the live word of their rows (score > 0)
//     with a ballot. The threshold is read through its device pointer, so a
//     graph replay uses its current value.
//  2. `greedy_nms_scan_kernel`, ONE warp and no block barrier. The removed
//     set, one bit a row, lives in shared memory and starts as ~live. For
//     each 64-row block in order, the warp resolves the block from its
//     diagonal word in registers: row r is kept iff its bit is clear when
//     step r comes, and a kept row ORs its diagonal word in (64 dependent
//     steps of two instructions, a test and a predicated OR, the same in
//     every lane). Then the lanes split the later words and OR the kept
//     rows' words into them (one 16-byte shared-memory load a row and
//     lane, two words, ORed under the row's kept bit). The rows' words
//     come into shared memory ahead of the scan by cp.async, in chunks of
//     64 words a row through a ring of 4 stages: the next 3 chunks load
//     while this one is scanned. keep[i] = the bit of i is clear: a row is
//     kept iff its score is > 0 and no earlier kept row covers it, the
//     earlier design's semantics exactly.
//
// Bound. The work is M (M - 1) / 2 IoU tests at most (only kept rows' tests
// count: against the later candidates still kept), ~16 float32 operations
// each, on ~21 bytes a candidate: at M = 2304 under a microsecond at the
// card's float32 rate. The scan stays latency bound: one warp issues
// every step of nw blocks (64 dependent steps and a shared-memory pass of
// the rows' words each). At M = 2304 a call takes ~0.067 ms on AMG's pools
// (chip_smoke.py phase 7, the same card), 7x less than the earlier design.
//
// Exactness. The IoU is computed with the plain version's float32 ops in
// its order (areas max(x1 - x0 + 1, 0) * max(y1 - y0 + 1, 0), union
// area_i + area_j - inter, inter / max(union, 1)), each as an explicitly
// rounded intrinsic, so nvcc contracts nothing into an FMA; the division is
// IEEE (__fdiv_rn). The keep flags therefore equal the plain version's and
// JAX's bit for bit.

#include "tensor_core.cuh"

namespace dlimg {
namespace {

using u64 = unsigned long long;
constexpr int kChunkWords = 64;  // words of each of a block's 64 rows a stage holds
constexpr int kStages = 4;       // chunks in shared memory: kStages - 1 loading ahead
constexpr size_t kStageBytes = size_t(64) * kChunkWords * sizeof(u64);
static_assert(kChunkWords == 64, "the scan gives each lane two adjacent words of a chunk");

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fadd_rn(__fsub_rn(b.z, b.x), 1.f), 0.f),
                   fmaxf(__fadd_rn(__fsub_rn(b.w, b.y), 1.f), 0.f));
}

__device__ __forceinline__ float box_iou(float4 a, float area_a, float4 b) {
  const float iw = fmaxf(__fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.f), 0.f);
  const float ih = fmaxf(__fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.f), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, box_area(b)), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1.f));
}

__global__ void __launch_bounds__(256)
greedy_nms_mask_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                       const float* __restrict__ thresh, u64* __restrict__ mask,
                       u64* __restrict__ live, int m, int stride) {
  const int rb = blockIdx.y, w = blockIdx.x;
  if (w < rb) return;  // no j > i in an earlier word
  __shared__ float4 cols[64];
  const int t = threadIdx.x;
  const int j0 = w * 64;
  if (t < 64 && j0 + t < m) cols[t] = boxes[j0 + t];
  __syncthreads();
  // Four threads a row, sixteen columns each, then the row's word is put
  // together across the four lanes.
  const int q = t & 3;
  const int i = rb * 64 + (t >> 2);
  unsigned bits = 0;
  if (i < m) {
    const float th = *thresh;
    const float4 bi = boxes[i];
    const float ai = box_area(bi);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int jj = q * 16 + k, j = j0 + jj;
      if (j > i && j < m && box_iou(bi, ai, cols[jj]) > th) bits |= 1u << k;
    }
  }
  u64 word = static_cast<u64>(bits) << (16 * q);
  word |= __shfl_xor_sync(kFullMask, word, 1);
  word |= __shfl_xor_sync(kFullMask, word, 2);
  if (q == 0) mask[size_t(i) * stride + w] = word;
  if (w == rb && t < 64) {  // warps 0 and 1: the live word of rows 64 rb + t
    const int r = rb * 64 + t;
    const unsigned b = __ballot_sync(kFullMask, r < m && scores[r] > 0.f);
    if ((t & 31) == 0) reinterpret_cast<unsigned*>(live + rb)[t >> 5] = b;
  }
}

// One step of the diagonal: if the row's bit of `gone` is clear, the row is
// kept and its word is ORed in. Written as a predicated OR, so the step is
// two dependent instructions (a test that sets a predicate, the OR under
// it); as C++ the compiler makes it a shift, a test, a select and an OR.
__device__ __forceinline__ void keep_step(unsigned& gone, unsigned& other, unsigned bit,
                                          unsigned d, unsigned d_other) {
  asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\t"
      "and.b32 t, %0, %2;\n\t"
      "setp.eq.u32 p, t, 0;\n\t"
      "@p or.b32 %0, %0, %3;\n\t"
      "@p or.b32 %1, %1, %4;\n\t}"
      : "+r"(gone), "+r"(other)
      : "r"(bit), "r"(d), "r"(d_other));
}

__device__ __forceinline__ void keep_step(unsigned& gone, unsigned bit, unsigned d) {
  asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\t"
      "and.b32 t, %0, %1;\n\t"
      "setp.eq.u32 p, t, 0;\n\t"
      "@p or.b32 %0, %0, %2;\n\t}"
      : "+r"(gone)
      : "r"(bit), "r"(d));
}

// acc |= x where (kept & bit) != 0: a test and four predicated ORs.
__device__ __forceinline__ void or_if_kept(uint4& acc, unsigned kept, unsigned bit, uint4 x) {
  asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\t"
      "and.b32 t, %4, %5;\n\t"
      "setp.ne.u32 p, t, 0;\n\t"
      "@p or.b32 %0, %0, %6;\n\t"
      "@p or.b32 %1, %1, %7;\n\t"
      "@p or.b32 %2, %2, %8;\n\t"
      "@p or.b32 %3, %3, %9;\n\t}"
      : "+r"(acc.x), "+r"(acc.y), "+r"(acc.z), "+r"(acc.w)
      : "r"(kept), "r"(bit), "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w));
}

// Chunks of 64-row block rb: words [rb & ~1, stride) in kChunkWords steps.
__device__ __forceinline__ int chunks_of(int rb, int stride) {
  return (stride - (rb & ~1) + kChunkWords - 1) / kChunkWords;
}

__global__ void __launch_bounds__(32)
greedy_nms_scan_kernel(const u64* __restrict__ mask, const u64* __restrict__ live,
                       unsigned char* __restrict__ keep, int m, int nw, int stride) {
  extern __shared__ __align__(16) u64 sm[];
  u64* const stages = sm;                                   // kStages x 64 x kChunkWords
  u64* const removed = sm + kStages * 64 * kChunkWords;     // nw words
  const int lane = threadIdx.x;

  // The loads run kStages - 1 chunks ahead of the scan, in (row block,
  // chunk) order; chunk k lands in stage k % kStages.
  int load_rb = 0, load_c = 0;
  auto load_next = [&](u64* dst) {
    if (load_rb < nw) {
      const int w0 = (load_rb & ~1) + load_c * kChunkWords;
      const int pairs = min(kChunkWords, stride - w0) / 2;  // 16-byte copies a row
      if (lane < pairs) {
        const u64* src = mask + size_t(load_rb) * 64 * stride + w0 + 2 * lane;
        u64* to = dst + 2 * lane;
#pragma unroll 16
        for (int r = 0; r < 64; ++r, src += stride, to += kChunkWords)
          cp_async16(to, src, true);
      }
      if (++load_c == chunks_of(load_rb, stride)) {
        load_c = 0;
        ++load_rb;
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
  for (int k = 0; k + 1 < kStages; ++k) load_next(stages + k * 64 * kChunkWords);
  for (int w = lane; w < nw; w += 32) removed[w] = ~live[w];

  int cur = 0;
  u64 kept = 0;
  for (int rb = 0; rb < nw; ++rb) {
    const int n_chunks = chunks_of(rb, stride);
    for (int c = 0; c < n_chunks; ++c) {
      cp_async_wait<kStages - 2>();  // this chunk has landed
      // Every lane is done with the previous stage (and its removed words
      // are visible): refill it with the chunk kStages - 1 ahead.
      __syncwarp();
      load_next(stages + ((cur + kStages - 1) % kStages) * 64 * kChunkWords);
      const u64* tile = stages + cur * 64 * kChunkWords;
      const int w0 = (rb & ~1) + c * kChunkWords;
      if (c == 0) {
        // The diagonal, in registers: row r's word has bits only above r,
        // so rows 0-31 decide on the low half and carry the high half
        // along, rows 32-63 decide and write on the high half alone.
        const unsigned* diag = reinterpret_cast<const unsigned*>(tile + (rb - w0));
        unsigned lo = static_cast<unsigned>(removed[rb]);
        unsigned hi = static_cast<unsigned>(removed[rb] >> 32);
#pragma unroll
        for (int r = 0; r < 32; ++r)
          keep_step(lo, hi, 1u << r, diag[2 * r * kChunkWords], diag[2 * r * kChunkWords + 1]);
#pragma unroll
        for (int r = 32; r < 64; ++r) keep_step(hi, 1u << (r - 32), diag[2 * r * kChunkWords + 1]);
        const u64 gone = (static_cast<u64>(hi) << 32) | lo;
        kept = ~gone;
        if (lane == 0) removed[rb] = gone;
      }
      // The kept rows' words into the later words of the chunk: lane l owns
      // words w0 + 2l and w0 + 2l + 1 (one 16-byte load a row), ORed in
      // under the row's kept bit; even and odd rows into separate sums.
      uint4 acc[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
      const uint4* col = reinterpret_cast<const uint4*>(tile) + lane;
      const unsigned kept_lo = static_cast<unsigned>(kept);
      const unsigned kept_hi = static_cast<unsigned>(kept >> 32);
#pragma unroll
      for (int r = 0; r < 64; ++r)
        or_if_kept(acc[r & 1], r < 32 ? kept_lo : kept_hi, 1u << (r & 31),
                   col[r * (kChunkWords / 2)]);
      const int wa = w0 + 2 * lane;
      const u64 a = (static_cast<u64>(acc[0].y | acc[1].y) << 32) | (acc[0].x | acc[1].x);
      const u64 b = (static_cast<u64>(acc[0].w | acc[1].w) << 32) | (acc[0].z | acc[1].z);
      if (wa > rb && wa < nw) removed[wa] |= a;
      if (wa + 1 > rb && wa + 1 < nw) removed[wa + 1] |= b;
      cur = (cur + 1) % kStages;
    }
  }
  cp_async_wait<0>();
  __syncwarp();
  for (int i = lane; i < m; i += 32) keep[i] = !((removed[i >> 6] >> (i & 63)) & 1ull);
}

// Words of scratch for m candidates (ops/amg.py `nms_scratch_words`).
long long scratch_words(int m) {
  const long long nw = (static_cast<long long>(m) + 63) / 64;
  return nw * 64 * (nw + (nw & 1)) + nw;
}

}  // namespace
}  // namespace dlimg

// boxes (m, 4) float32, 16-byte aligned; scores (m,) float32; thresh one
// float32 on the device; keep (m,) bool; scratch, 16-byte aligned, of at
// least scratch_words(m) 64-bit words. Returns the launches' cudaError_t.
extern "C" int dlimg_greedy_nms(const void* boxes, const void* scores, const void* thresh,
                                void* keep, void* scratch, long long scratch_len, int m,
                                void* stream) {
  using namespace dlimg;
  if (m <= 0) return cudaSuccess;
  const int nw = (m + 63) / 64;
  const int stride = nw + (nw & 1);
  if (scratch_len < scratch_words(m)) return cudaErrorInvalidValue;
  static int smem_optin = -1;
  if (smem_optin < 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = kStages * kStageBytes + size_t(nw) * sizeof(u64);
  if (smem > size_t(smem_optin) || nw > 65535) return cudaErrorInvalidValue;
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin);
    if (err != cudaSuccess) return err;
    smem_set = size_t(smem_optin);
  }
  auto* mask = static_cast<u64*>(scratch);
  u64* live = mask + size_t(nw) * 64 * stride;
  auto st = static_cast<cudaStream_t>(stream);
  greedy_nms_mask_kernel<<<dim3(nw, nw), 256, 0, st>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const float*>(thresh), mask, live, m, stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  greedy_nms_scan_kernel<<<1, 32, smem, st>>>(mask, live, static_cast<unsigned char*>(keep),
                                              m, nw, stride);
  return cudaGetLastError();
}
