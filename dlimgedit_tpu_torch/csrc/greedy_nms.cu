// Exact greedy box NMS over score-sorted candidates, one launch.
//
// Replaces the `lax.fori_loop` of dlimgedit_tpu/ops/amg.py:175-180
// (`greedy_nms`, automatic mask generation). That loop is not a Pallas
// kernel: XLA runs it as M dependent steps over the rows of an (M, M) IoU
// matrix. Written in PyTorch it is three or four small launches a row
// (~7000 nodes of a CUDA graph at M = 2304) for a few kilobytes of data.
//
// Bound. The work is M (M - 1) / 2 IoU tests at most (only the rows of kept
// candidates test, against the later candidates still kept), ~16 float32
// operations each, on ~21 bytes a candidate: at M = 2304 under a
// microsecond at the card's float32 rate, and far less for the bytes. The
// kernel is bound by neither: it is bound by latency, the M dependent
// steps, each a barrier of the block and a few shared-memory reads.
//
// Design. One block of kThreads threads. The keep flags live in shared
// memory, one byte a candidate, and start as score > 0. Row i runs in
// order; when keep[i] holds, the block splits the later candidates
// j > i among its threads, each clears keep[j] when IoU(i, j) > thresh,
// and one barrier ends the row. A row whose candidate is already cleared
// writes nothing, so every thread skips it without a barrier (keep[i] was
// last written before the barrier of an earlier kept row, so every thread
// reads the same value). The boxes sit in shared memory too when
// M * 17 bytes fit in what a block may use (M up to ~13600 on an H100);
// above that the block reads box j from global memory (L2) instead of
// refusing. The threshold is read through a device pointer, so a CUDA
// graph replay uses the threshold's current value.
//
// Exactness. The IoU is computed with the plain version's float32 ops in
// its order (areas max(x1 - x0 + 1, 0) * max(y1 - y0 + 1, 0), union
// area_i + area_j - inter, inter / max(union, 1)), each as an explicitly
// rounded intrinsic, so nvcc contracts nothing into an FMA; the division is
// IEEE (__fdiv_rn). The keep flags therefore equal the plain version's and
// JAX's bit for bit.

#include "common.cuh"

namespace dlimg {
namespace {

constexpr int kThreads = 1024;

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

template <bool kBoxesInSmem>
__global__ void __launch_bounds__(kThreads)
greedy_nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                  const float* __restrict__ thresh, unsigned char* __restrict__ keep_out,
                  int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);
  unsigned char* keep = smem + (kBoxesInSmem ? size_t(m) * sizeof(float4) : 0);
  const float t = *thresh;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    if (kBoxesInSmem) sbox[j] = boxes[j];
    keep[j] = scores[j] > 0.f;
  }
  __syncthreads();
  for (int i = 0; i + 1 < m; ++i) {
    if (!keep[i]) continue;  // the same value in every thread: no barrier
    const float4 bi = kBoxesInSmem ? sbox[i] : __ldg(boxes + i);
    const float ai = box_area(bi);
    for (int j = i + 1 + threadIdx.x; j < m; j += kThreads) {
      if (!keep[j]) continue;
      const float4 bj = kBoxesInSmem ? sbox[j] : __ldg(boxes + j);
      if (box_iou(bi, ai, bj) > t) keep[j] = 0;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < m; j += kThreads) keep_out[j] = keep[j];
}

template <bool kBoxesInSmem>
cudaError_t launch(const float4* boxes, const float* scores, const float* thresh,
                   unsigned char* keep, int m, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_nms_kernel<kBoxesInSmem>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  greedy_nms_kernel<kBoxesInSmem><<<1, kThreads, smem, stream>>>(boxes, scores, thresh,
                                                                 keep, m);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dlimg

// boxes (m, 4) float32, 16-byte aligned; scores (m,) float32; thresh one
// float32 on the device; keep (m,) bool. Returns the launch's cudaError_t.
extern "C" int dlimg_greedy_nms(const void* boxes, const void* scores, const void* thresh,
                                void* keep, int m, void* stream) {
  using namespace dlimg;
  if (m <= 0) return cudaSuccess;
  static int smem_optin = -1;
  if (smem_optin < 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  const auto* b = static_cast<const float4*>(boxes);
  const auto* s = static_cast<const float*>(scores);
  const auto* t = static_cast<const float*>(thresh);
  auto* k = static_cast<unsigned char*>(keep);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t with_boxes = size_t(m) * (sizeof(float4) + 1);
  if (with_boxes <= size_t(smem_optin)) return launch<true>(b, s, t, k, m, with_boxes, st);
  return launch<false>(b, s, t, k, m, size_t(m), st);
}
