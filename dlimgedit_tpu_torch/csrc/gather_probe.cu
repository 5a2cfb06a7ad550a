// K8: the shared-memory gather probe.
//
// Replaces the TPU kernel tools/probe_vmem_gather.py:53 `run_gather` (Pallas
// body `gather_kernel`, :35), a measurement tool: how fast can a kernel
// gather rows of a table that sits in on-chip memory (BiRefNet's deformable
// convolution samples one row per (pixel, tap))? It computes
//   out[r, l] = sum_{i < reps} float(table[(idx[r, l] + i) mod rows, l])
// with the sum taken in order i = 0, 1, ... from 0, as the JAX loop does.
//
// What bounds it on an H100: bytes (the 1 MB bf16 table, 2 MB of indices and
// 2 MB of float32 output at the probe's 4096 x 128: ~1.6 us at 3.35 TB/s);
// the gathers themselves are 0.5-1 M shared-memory reads.
//
// The TPU probe holds the whole table in VMEM; 1 MB does not fit an SM's
// 227 KB. But lane l of the output only reads column l, so a block stages a
// slab of columns for every row (32 bytes a row: 16 bf16 or 8 float32
// columns, 128 KB for 4096 rows) and gathers from shared memory; the slabs x
// row chunks grid fills the SMs (8 x 16 = 128 blocks in bf16).
//
// The earlier design staged each slab with scalar 2-byte loads,
// an integer divide for each element, by 256 threads, with one block on an
// SM (the slab fills its shared memory): few loads in flight for 16 MB of
// strided L2 reads (16 row chunks each read the whole table), and an integer
// `%` on every rep of the gather. 0.02743 ms a call at reps 8, row-replicated
// indices, bf16 (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W), 6% of the
// bound.
//
// Design: 1024 threads a block. Where a slab row is whole and 16-byte
// aligned (lanes * element bytes a multiple of 16, a full slab), it is
// staged as two 16-byte cp.async copies a row, eight a thread at the
// probe's shape, all in flight together; a ragged last slab or an
// unaligned width takes scalar loads (the slab width is a power of two: a
// shift and a mask, no divide). A thread's first four rows' indices load
// before the staging, so their latency hides behind it. The gather takes
// one `%` an output (the start row, made non-negative) and then steps the
// row with a conditional wrap, no `%` a rep. The sum stays in order i = 0, 1, ..., so the result
// stays bit-equal to the plain version. Every row chunk still reads its
// slab from L2: 16 MB of L2 reads at the probe's shape, against 5.2 MB of
// device memory traffic in the bound. ~0.0093 ms a call at reps 8
// (chip_smoke.py phase 2, the same card), 17% of the bound; an empty
// kernel launched back to back already takes ~0.002 ms, more than the
// whole bound, so half of it is out of reach.
#include <stdint.h>

#include "tensor_core.cuh"

namespace dlimg {

constexpr int kGpThreads = 1024;
constexpr int kPre = 4;  // indices a thread loads ahead of the staging

template <typename T>
__global__ void __launch_bounds__(kGpThreads)
    gather_probe_kernel(const T* table, const int* idx, float* out, int rows, int lanes,
                        int reps, int rows_per_block, bool vec) {
  constexpr int L = 32 / sizeof(T);  // columns per slab
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);  // rows x L
  const int l0 = blockIdx.x * L;
  const int tid = static_cast<int>(threadIdx.x);
  const int c = tid % L;
  const int l = l0 + c;
  constexpr int step = kGpThreads / L;  // rows a pass of the block covers
  const int chunk = static_cast<int>(blockIdx.y);
  const int r0 = chunk * rows_per_block + tid / L;
  const int r_end = min(rows, (chunk + 1) * rows_per_block);
  // The first kPre rows' indices load before the slab, so their latency
  // hides behind the staging.
  int pre[kPre];
#pragma unroll
  for (int j = 0; j < kPre; ++j) {
    const int r = r0 + j * step;
    pre[j] = l < lanes && r < r_end ? idx[static_cast<size_t>(r) * lanes + l] : 0;
  }
  if (vec && l0 + L <= lanes) {
    // Two 16-byte halves a row (lanes * sizeof(T) is a multiple of 16),
    // straight into shared memory: every copy of the block in flight at once.
    const int n = rows * 2;
    for (int e = tid; e < n; e += kGpThreads) {
      const int r = e >> 1, h = e & 1;
      cp_async16(slab + r * L + h * (L / 2),
                 table + static_cast<size_t>(r) * lanes + l0 + h * (L / 2), true);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    const int n = rows * L;
#pragma unroll 4
    for (int e = tid; e < n; e += kGpThreads) {
      const int r = e / L, cc = e % L;  // L is a power of two: a shift, a mask
      slab[e] = l0 + cc < lanes ? table[static_cast<size_t>(r) * lanes + l0 + cc]
                                : from_float<T>(0.f);
    }
  }
  __syncthreads();
  if (l >= lanes) return;
  // out = sum over i < reps of slab[(base + i) mod rows], in order from 0.
  auto gather = [&](int base) {
    int row = base % rows;
    if (row < 0) row += rows;
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < reps; ++i) {
      acc += to_float(slab[row * L + c]);
      if (++row == rows) row = 0;
    }
    return acc;
  };
#pragma unroll
  for (int j = 0; j < kPre; ++j) {
    const int r = r0 + j * step;
    if (r < r_end) out[static_cast<size_t>(r) * lanes + l] = gather(pre[j]);
  }
  for (int r = r0 + kPre * step; r < r_end; r += step) {
    const size_t at = static_cast<size_t>(r) * lanes + l;
    out[at] = gather(idx[at]);
  }
}

template <typename T>
cudaError_t launch_gather_probe(const T* table, const int* idx, float* out, int rows,
                                int lanes, int reps, int row_chunks, cudaStream_t stream) {
  constexpr int L = 32 / sizeof(T);
  void (*kernel)(const T*, const int*, float*, int, int, int, int, bool) =
      &gather_probe_kernel<T>;
  const size_t smem = static_cast<size_t>(rows) * L * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const bool vec = (static_cast<size_t>(lanes) * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0;
  const int rows_per_block = (rows + row_chunks - 1) / row_chunks;
  const dim3 grid((lanes + L - 1) / L, (rows + rows_per_block - 1) / rows_per_block);
  kernel<<<grid, kGpThreads, smem, stream>>>(table, idx, out, rows, lanes, reps,
                                             rows_per_block, vec);
  return cudaGetLastError();
}

}  // namespace dlimg

// table: (rows, lanes) contiguous, float32 or bfloat16; idx: (rows, lanes)
// int32 contiguous; out: (rows, lanes) float32. rows * 32 bytes must fit a
// block's shared memory (rows <= 7264).
extern "C" int dlimg_gather_probe(const void* table, const void* idx, void* out, int rows,
                                  int lanes, int reps, int row_chunks, int dtype,
                                  void* stream) {
  if (rows <= 0 || lanes <= 0) return 0;
  if (reps < 0 || row_chunks <= 0 || row_chunks > 65535 || rows > 7264)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  float* op = static_cast<float*>(out);
  if (dtype == dlimg::kDtypeF32)
    return dlimg::launch_gather_probe(static_cast<const float*>(table), ip, op, rows, lanes,
                                      reps, row_chunks, s);
  if (dtype == dlimg::kDtypeBF16)
    return dlimg::launch_gather_probe(static_cast<const __nv_bfloat16*>(table), ip, op,
                                      rows, lanes, reps, row_chunks, s);
  return cudaErrorInvalidValue;
}
