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
// 2 MB of float32 output at the probe's 4096 x 128: ~1.5 us at 3.35 TB/s);
// the gathers themselves are 0.5-1 M shared-memory reads.
//
// Design. The TPU probe holds the whole table in VMEM; 1 MB does not fit an
// SM's 227 KB. But lane l of the output only reads column l, so a block
// stages a slab of columns for every row (32 bytes a row: 16 bf16 or 8
// float32 columns, 128 KB for 4096 rows) and gathers from shared memory.
// The slabs x row chunks grid is sized by the caller to fill the SMs; each
// block stages its slab whole and computes its chunk of rows. Indices that
// are the same across a row's lanes (the deformable-convolution pattern) read
// one 32-byte slab row per row group; independent per-lane indices scatter
// over the shared-memory banks, which is what the probe measures.
#include "common.cuh"

namespace dlimg {

constexpr int kGpThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kGpThreads)
    gather_probe_kernel(const T* table, const int* idx, float* out, int rows, int lanes,
                        int reps, int rows_per_block) {
  constexpr int L = 32 / sizeof(T);  // columns per slab
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);  // rows x L
  const int l0 = blockIdx.x * L;
  for (int e = threadIdx.x; e < rows * L; e += kGpThreads) {
    const int r = e / L, c = e % L;
    slab[e] = l0 + c < lanes ? table[static_cast<size_t>(r) * lanes + l0 + c]
                             : from_float<T>(0.f);
  }
  __syncthreads();
  const int c = threadIdx.x % L;
  const int l = l0 + c;
  if (l >= lanes) return;
  const int chunk = static_cast<int>(blockIdx.y);
  const int r_end = min(rows, (chunk + 1) * rows_per_block);
  for (int r = chunk * rows_per_block + static_cast<int>(threadIdx.x) / L; r < r_end;
       r += kGpThreads / L) {
    const size_t at = static_cast<size_t>(r) * lanes + l;
    const int base = idx[at];
    float acc = 0.f;
    for (int i = 0; i < reps; ++i) {
      int row = (base + i) % rows;
      if (row < 0) row += rows;
      acc += to_float(slab[row * L + c]);
    }
    out[at] = acc;
  }
}

template <typename T>
cudaError_t launch_gather_probe(const T* table, const int* idx, float* out, int rows,
                                int lanes, int reps, int row_chunks, cudaStream_t stream) {
  constexpr int L = 32 / sizeof(T);
  void (*kernel)(const T*, const int*, float*, int, int, int, int) = &gather_probe_kernel<T>;
  const size_t smem = static_cast<size_t>(rows) * L * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int rows_per_block = (rows + row_chunks - 1) / row_chunks;
  const dim3 grid((lanes + L - 1) / L, (rows + rows_per_block - 1) / rows_per_block);
  kernel<<<grid, kGpThreads, smem, stream>>>(table, idx, out, rows, lanes, reps,
                                             rows_per_block);
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
