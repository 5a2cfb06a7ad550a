// Python-free serving backend of the PyTorch port: runs the programs of a
// serving bundle (python -m dlimgedit_tpu_torch.tools.aot_export --program
// serving) with libtorch's ATen, no Python in the process. The port's
// counterpart of the JAX package's native/src/pjrt_backend.hpp, with its
// interface (create, variant, image_size, buckets, run, fetch, release,
// validate).
//
// Built as its own shared library, libdlimgedit_tpu_torch_serving.so
// (native_build.py), linked against libtorch. The port's C library
// (capi.cpp) links no libtorch: with DLIMG_PJRT_BUNDLE set it dlopens this
// library from its own directory and reaches it through the plain C table
// at the end of this header (dlimg_serving_init).
//
// The programs are C++ that mirrors the port's Python modules op for op
// (torch_programs.cpp). On cuda:0 each program is captured into a CUDA
// graph at its first call, after an eager warm-up, as the Python
// Executable does (runtime/environment.py); kernels K1 (fused LayerNorm)
// and K2 (TinyViT window attention) are launched through the port's kernel
// library, whose path the bundle names. On the CPU the programs run
// eagerly and K1 / K2 take their plain versions.
//
// One program runs at a time per backend, under its lock; host data a
// caller fills (Arg::fill) is written under that lock too. A host that
// shares libtorch with this library: while a program runs eagerly (every
// CPU run; on CUDA a program's warm-up and capture) ATen's process-wide
// float32 precision flags hold full float32 precision (models/common.py
// full_precision), and the host's values are put back after it.
#pragma once

#include <cstddef>
#include <cstdint>
#include <string>
#include <vector>

namespace dlimg_torch {

struct Backend;  // opaque: the bundle, its loaded programs and weights
struct Buf;      // opaque: a tensor on the backend's device

// One argument to run(): host data (copied to the device), host data the
// caller writes into the program's own buffer (fill), or a tensor returned
// by an earlier run (e.g. the cached image embedding).
struct Arg {
  const void* host = nullptr;  // host path: data + dims + dtype
  std::vector<int64_t> dims;
  std::string dtype;           // "uint8" | "int32" | "float32"
  Buf* dev = nullptr;          // device path (takes precedence)
  // Fill path (when host is null): fill(fill_ctx, dst) writes the
  // argument, of the spec's dims and dtype, into dst under the backend's
  // lock, just before the run: on CUDA dst is the program's pinned staging
  // buffer, which the copy to the device reads in place (as the Python path
  // packs its canvas into pinned memory); on the CPU a buffer the program
  // reads where it lies.
  void (*fill)(void* fill_ctx, void* dst) = nullptr;
  void* fill_ctx = nullptr;
};

enum Device { kCpu = 0, kCuda = 1 };

// Open a serving bundle for a device: kCuda is cuda:0 and fails without
// CUDA; kCpu is the CPU. nullptr + err on failure, e.g. a JAX bundle or a
// bundle exported for the other device.
Backend* create(const std::string& bundle_dir, int device, std::string* err);
void destroy(Backend*);

// Bundle metadata (serving.txt).
const std::string& variant(Backend*);
int image_size(Backend*);
const std::vector<int>& buckets(Backend*);

// Run program `name` (loaded at its first call: its spec, and the weights
// no earlier program loaded to the device: each weight is held once). Outputs are tensors on the device, each a copy the caller owns;
// fetch() copies one to the host. false + err on failure.
bool run(Backend*, const std::string& name, const std::vector<Arg>& args,
         std::vector<Buf*>* outs, std::string* err);
bool fetch(Backend*, Buf*, void* dst, size_t dst_size, std::string* err);
void release(Backend*, Buf*);

// Run `name` on the sample inputs the exporter saved (<name>.in<k>.npy of
// the spec's "ind" rows) and compare every output byte for byte with
// <name>.out<i>.npy, the port's Python path's outputs.
bool validate(Backend*, const std::string& name, std::string* report,
              std::string* err);

// The weights held on the backend's device: their number and bytes.
void held_weights(Backend*, int64_t* count, int64_t* bytes);

}  // namespace dlimg_torch

// ---------------------------------------------------------------------------
// The plain C table capi.cpp reaches through dlopen/dlsym.
// ---------------------------------------------------------------------------

#define DLIMG_SERVING_ABI 2

extern "C" {

typedef struct dlimg_serving_arg {
  const void* host;    // host data, or null when dev or fill is given
  const int64_t* dims;
  int ndim;
  const char* dtype;   // "uint8" | "int32" | "float32"
  void* dev;           // a buffer from an earlier run, or null
  // Host data written under the backend's lock (dlimg_torch::Arg::fill).
  void (*fill)(void* fill_ctx, void* dst);
  void* fill_ctx;
} dlimg_serving_arg;

typedef struct dlimg_serving_api {
  int abi;  // DLIMG_SERVING_ABI
  // Errors: a null / non-zero return; the message in last_error() (per
  // thread).
  void* (*create)(const char* bundle_dir, int device);
  void (*destroy)(void* backend);
  const char* (*variant)(void* backend);
  int (*image_size)(void* backend);
  int (*bucket_count)(void* backend);
  int (*bucket)(void* backend, int i);
  int (*run)(void* backend, const char* name, const dlimg_serving_arg* args,
             int n_args, void** outs, int max_outs, int* n_outs);
  int (*fetch)(void* backend, void* buf, void* dst, size_t dst_size);
  void (*release)(void* backend, void* buf);
  const char* (*last_error)(void);
  int (*cuda_available)(void);
} dlimg_serving_api;

typedef const dlimg_serving_api* (*dlimg_serving_init_fn)(void);

// Exported by libdlimgedit_tpu_torch_serving.so.
const dlimg_serving_api* dlimg_serving_init(void);
// For test programs: the launches of K1 and K2 made by this library's
// programs since the process started or the last reset (a graph replay
// adds what its capture counted), and the replay check: every captured
// graph of every live backend replayed and its eager program run on the
// same static inputs, the outputs compared byte for byte, a line per graph
// into `report`; -> the number of graphs held, -1 on a difference.
void dlimg_serving_launches(int64_t* layer_norm, int64_t* levit_attention);
void dlimg_serving_reset_launches(void);
int dlimg_serving_check_replays(char* report, size_t report_size);

}  // extern "C"
