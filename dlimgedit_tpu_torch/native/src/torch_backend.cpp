// The port's Python-free serving backend (see torch_backend.hpp): the
// bundle, its programs' weights on the device, and the executable cache.
//
// A bundle directory (tools/aot_export.py --program serving) holds
//   serving.txt          key \t value: format, variant, backend, image_size,
//                        buckets, batch, compute_dtype, decoder_heads, the
//                        encoder and its kernel route, a ViT's geometry,
//                        the amg grid and winners, the BiRefNet programs
//                        and configuration (bundle.hpp)
//   kernels_path.txt     the port's kernel library (a cuda bundle only)
//   weights/<name>.npy   each state_dict tensor once, whichever programs
//                        use it; a BiRefNet's under birefnet.<kind>., with
//                        its index tables (tables.*)
//   <name>.spec.txt      one row per argument, then per output:
//                          inw <dtype> <d0,d1,..> <state_dict name>  weight
//                          ind <dtype> <d0,d1,..>                    dynamic
//                          out <dtype> <d0,d1,..>
//   <name>.in<k>.npy     sample value of the k-th dynamic argument
//   <name>.out<i>.npy    the port's Python path's outputs on the samples
//
// The backend holds each weight once on its device, for every program.
//
// On cuda:0 each program is an Executable as runtime/environment.py makes
// one: the first call runs it eagerly on a side stream (the warm-up, whose
// result it returns), then captures it into a CUDA graph with static input
// buffers; later calls copy their inputs into those buffers (host data
// through a pinned staging buffer) and replay. Launch counters: a capture
// takes back what it counted and each replay adds it again. A batch
// decode forks each prompt's work onto streams of the calling thread, held
// by the backend (a stream in a capture may carry no other thread's work).
#include "torch_backend.hpp"

#include <ATen/ATen.h>
#include <ATen/Parallel.h>
#include <c10/core/InferenceMode.h>
#include <dlfcn.h>

#include <algorithm>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <sstream>
#include <thread>

#include "bundle.hpp"
#include "npy.hpp"
#include "torch_programs.hpp"

#ifdef DLIMG_SERVING_CUDA
#include <ATen/cuda/CUDAContext.h>
#include <ATen/cuda/CUDAEvent.h>
#include <ATen/cuda/CUDAGraph.h>
#include <c10/cuda/CUDACachingAllocator.h>
#include <c10/cuda/CUDAFunctions.h>
#include <c10/cuda/CUDAGuard.h>
#endif

namespace dlimg_torch {
namespace {

using at::Tensor;

std::string read_file(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return "";
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

std::string trim(std::string s) {
  while (!s.empty() && (s.back() == '\n' || s.back() == '\r' ||
                        s.back() == ' ' || s.back() == '\t'))
    s.pop_back();
  return s;
}

at::ScalarType scalar_type(const std::string& dtype) {
  if (dtype == "float32") return at::kFloat;
  if (dtype == "bfloat16") return at::kBFloat16;
  if (dtype == "int32") return at::kInt;
  if (dtype == "int64") return at::kLong;
  if (dtype == "uint8") return at::kByte;
  if (dtype == "int8") return at::kChar;
  throw std::runtime_error("unsupported dtype " + dtype);
}

std::string dims_str(const std::vector<int64_t>& dims) {
  std::string s;
  for (size_t i = 0; i < dims.size(); ++i)
    s += (i ? "," : "") + std::to_string(dims[i]);
  return s;
}

struct SpecRow {
  std::string kind;  // inw | ind | out
  std::string dtype;
  std::vector<int64_t> dims;
  std::string name;  // weights only
};

std::vector<SpecRow> read_spec(const std::string& path) {
  std::ifstream f(path);
  if (!f) throw std::runtime_error("no program spec " + path);
  std::vector<SpecRow> rows;
  std::string line;
  while (std::getline(f, line)) {
    if (trim(line).empty()) continue;
    // Columns are single-space separated; dims may be empty (a scalar).
    std::vector<std::string> col;
    std::stringstream ls(trim(line));
    std::string tok;
    while (std::getline(ls, tok, ' ')) col.push_back(tok);
    if (col.size() < 2)
      throw std::runtime_error("malformed spec row '" + line + "' in " +
                               path);
    SpecRow r;
    r.kind = col[0];
    r.dtype = col[1];
    if (col.size() > 2 && !col[2].empty()) {
      std::stringstream ds(col[2]);
      while (std::getline(ds, tok, ',')) r.dims.push_back(std::stoll(tok));
    }
    if (col.size() > 3) r.name = col[3];
    if (r.kind != "inw" && r.kind != "ind" && r.kind != "out")
      throw std::runtime_error("unknown spec row kind '" + r.kind + "' in " +
                               path);
    if (r.kind == "inw" && r.name.empty())
      throw std::runtime_error("weight row without a name in " + path);
    rows.push_back(r);
  }
  return rows;
}

Tensor tensor_from_npy(const dlimg_npy::Npy& npy) {
  at::ScalarType t = scalar_type(npy.dtype);
  return at::from_blob(const_cast<char*>(npy.data.data()), npy.shape,
                       at::TensorOptions().dtype(t))
      .clone();
}

// torch_programs.cpp's counters: the launches of K1, K2, K3, K4, K5, P1,
// P2 and P3, in that order (dlimg_serving_launches), then the int8
// linears the dispatch took, s8 x s8 and dequantised
// (dlimg_serving_int8_linears). A capture takes back what it counted and
// each replay adds it again, for every counter.
constexpr int kKernels = 8;
constexpr int kCounted = kKernels + 2;
std::atomic<int64_t>* const kCounters[kCounted] = {
    &g_layer_norm_launches,     &g_levit_attention_launches,
    &g_add_layer_norm_launches, &g_relpos_global_launches,
    &g_relpos_windowed_launches, &g_greedy_nms_launches,
    &g_quantize_rows_launches,  &g_int8_epilogue_launches,
    &g_int8_products,           &g_dequantised_products};

struct Launches {
  int64_t n[kCounted] = {};
};

Launches counted() {
  Launches l;
  for (int i = 0; i < kCounted; ++i) l.n[i] = kCounters[i]->load();
  return l;
}

// after - before
Launches since(const Launches& before) {
  Launches d = counted();
  for (int i = 0; i < kCounted; ++i) d.n[i] -= before.n[i];
  return d;
}

void add_launches(const Launches& d, int sign) {
  for (int i = 0; i < kCounted; ++i) *kCounters[i] += sign * d.n[i];
}

// models/common.py full_precision: float32 products and convolutions at
// full float32 precision while a program runs eagerly, whatever the host's
// flags (a CUDA graph keeps the algorithms chosen at its capture, so a
// capture runs inside too). ATen's flags are process-wide, so this holds
// for every thread while any guard lives: the first guard sets each flag
// that differs, the last puts back the host's value if the flag still
// holds the guard's. A flag ATen refuses to read (a mix of its per-backend
// leaves the host made) is left alone.
class FullPrecision {
 public:
  FullPrecision() {
    State& s = state();
    std::lock_guard<std::mutex> lk(s.mu);
    if (s.depth++ > 0) return;
    at::Context& ctx = at::globalContext();
    bool tf32 = false;
    s.matmul = readable(matmul_name, &s.matmul_was) &&
               s.matmul_was != "highest";
    if (s.matmul) ctx.setFloat32MatmulPrecision("highest");
    s.cublas = readable([&] { return ctx.allowTF32CuBLAS(); }, &tf32) && tf32;
    if (s.cublas) ctx.setAllowTF32CuBLAS(false);
    s.cudnn = readable([&] { return ctx.allowTF32CuDNN(); }, &tf32) && tf32;
    if (s.cudnn) ctx.setAllowTF32CuDNN(false);
  }
  ~FullPrecision() {
    State& s = state();
    std::lock_guard<std::mutex> lk(s.mu);
    if (--s.depth > 0) return;
    at::Context& ctx = at::globalContext();
    std::string matmul;
    bool tf32 = true;
    if (s.matmul && readable(matmul_name, &matmul) && matmul == "highest")
      ctx.setFloat32MatmulPrecision(s.matmul_was);
    if (s.cublas && readable([&] { return ctx.allowTF32CuBLAS(); }, &tf32) &&
        !tf32)
      ctx.setAllowTF32CuBLAS(true);
    if (s.cudnn && readable([&] { return ctx.allowTF32CuDNN(); }, &tf32) &&
        !tf32)
      ctx.setAllowTF32CuDNN(true);
  }
  FullPrecision(const FullPrecision&) = delete;
  FullPrecision& operator=(const FullPrecision&) = delete;

 private:
  struct State {
    std::mutex mu;
    int depth = 0;
    bool matmul = false, cublas = false, cudnn = false;  // set by the guard
    std::string matmul_was;
  };
  static State& state() {
    static State s;
    return s;
  }
  // *out = get(); false when ATen refuses to read the flag.
  template <class Get, class T>
  static bool readable(Get get, T* out) {
    try {
      *out = get();
      return true;
    } catch (const std::exception&) {
      return false;
    }
  }
  static std::string matmul_name() {
    switch (at::globalContext().float32MatmulPrecision()) {
      case at::Float32MatmulPrecision::HIGH: return "high";
      case at::Float32MatmulPrecision::MEDIUM: return "medium";
      default: return "highest";
    }
  }
};

using ProgramFn = std::vector<Tensor> (*)(const Weights&,
                                          const ProgramConfig&,
                                          const std::vector<Tensor>&);

// The whole program runs in inference mode (runtime/environment.py
// _scoped) and at full float32 precision.
struct Program {
  std::string name;
  ProgramFn fn = nullptr;
  ProgramConfig cfg;
  const Weights* weights = nullptr;  // the backend's, shared
  // A BiRefNet program's weights by their name in its model: the
  // backend's tensors, without the kind's prefix.
  Weights own;
  std::vector<SpecRow> dynamic;
  // One per dynamic argument, made at its first use: the buffer a caller
  // fills (Arg::fill); on CUDA pinned, and the staging of every host
  // argument on its way to the device.
  std::vector<Tensor> host;
  std::vector<Tensor> eager(const std::vector<Tensor>& in) const {
    c10::InferenceMode guard;
    FullPrecision precision;
    return fn(*weights, cfg, in);
  }
#ifdef DLIMG_SERVING_CUDA
  std::unique_ptr<at::cuda::CUDAGraph> graph;
  std::vector<Tensor> static_in, static_out;
  Launches captured;
  std::unique_ptr<at::cuda::CUDAEvent> staged;  // the last copy_in's
#endif
};

}  // namespace

struct Buf {
  Tensor t;
};

struct Backend {
  std::string dir;
  at::Device device{at::kCPU};
  dlimg_bundle::Index index;  // serving.txt
  void* kernel_lib = nullptr;
  Kernels kernels;
  Tensor pixel_mean, pixel_std;
  Tensor imagenet_mean, imagenet_std;  // runtime/birefnet.py IMAGENET_*
  Weights weights;  // on the device, each once, for every program
  std::map<std::string, std::unique_ptr<Program>> programs;
  // A batch decode's fork streams (cudaStream_t), per calling thread.
  std::map<std::thread::id, std::vector<void*>> forks;
  // One program runs at a time (graphs, static and host buffers, forks).
  std::mutex mu;
};

namespace {

std::mutex g_registry_mu;
std::set<Backend*> g_registry;  // live backends, for check_replays

void load_kernels(Backend* be) {
  std::string so = trim(read_file(be->dir + "/kernels_path.txt"));
  if (so.empty())
    throw std::runtime_error(
        be->dir + "/kernels_path.txt names no kernel library: a bundle "
                  "served on CUDA is exported with --backend gpu");
  be->kernel_lib = dlopen(so.c_str(), RTLD_NOW | RTLD_LOCAL);
  if (!be->kernel_lib)
    throw std::runtime_error("dlopen " + so + ": " + dlerror());
  auto entry = [&](const char* name) {
    void* f = dlsym(be->kernel_lib, name);
    if (!f) throw std::runtime_error(so + " lacks " + name);
    return f;
  };
  Kernels& k = be->kernels;
  k.layer_norm = reinterpret_cast<Kernels::LayerNorm>(entry("dlimg_layer_norm"));
  k.levit_attention = reinterpret_cast<Kernels::LevitAttention>(
      entry("dlimg_levit_attention"));
  k.add_layer_norm = reinterpret_cast<Kernels::AddLayerNorm>(
      entry("dlimg_add_layer_norm"));
  k.relpos_attention_global = reinterpret_cast<Kernels::RelposGlobal>(
      entry("dlimg_relpos_attention_global"));
  k.relpos_attention_windowed = reinterpret_cast<Kernels::RelposWindowed>(
      entry("dlimg_relpos_attention_windowed"));
  k.greedy_nms = reinterpret_cast<Kernels::GreedyNms>(
      entry("dlimg_greedy_nms"));
  k.quantize_rows_int8 = reinterpret_cast<Kernels::QuantizeRows>(
      entry("dlimg_quantize_rows_int8"));
  k.int8_epilogue = reinterpret_cast<Kernels::Int8Epilogue>(
      entry("dlimg_int8_epilogue"));
}

// The calling thread's first n fork streams, made at their first use.
std::vector<void*> fork_streams(Backend* be, int64_t n) {
#ifdef DLIMG_SERVING_CUDA
  std::vector<void*>& mine = be->forks[std::this_thread::get_id()];
  while (int64_t(mine.size()) < n) {
    cudaStream_t s = nullptr;
    cudaError_t rc = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
    if (rc != cudaSuccess)
      throw std::runtime_error(std::string("cudaStreamCreateWithFlags: ") +
                               cudaGetErrorString(rc));
    mine.push_back(s);
  }
  return std::vector<void*>(mine.begin(), mine.begin() + n);
#else
  throw std::runtime_error("this serving library was built without CUDA");
#endif
}

// Weight row `r` in be->weights: read from weights/<name>.npy to the
// device at its first use, else checked against the spec. A w_q8 weight
// (in, out) is held as a view of column-major storage, as QuantLinear
// holds it: cuBLASLt's fast int8 products take only that layout.
void load_weight(Backend* be, const SpecRow& r) {
  auto held = be->weights.find(r.name);
  if (held != be->weights.end()) {
    if (held->second.scalar_type() != scalar_type(r.dtype) ||
        held->second.sizes().vec() != r.dims)
      throw std::runtime_error("weight " + r.name + " is held as " +
                               std::string(c10::toString(
                                   held->second.scalar_type())) +
                               " (" + dims_str(held->second.sizes().vec()) +
                               "), a spec names " + r.dtype + " (" +
                               dims_str(r.dims) + ")");
    return;
  }
  dlimg_npy::Npy npy;
  std::string err;
  std::string path = be->dir + "/weights/" + r.name + ".npy";
  if (!dlimg_npy::load_npy(path, &npy, &err)) throw std::runtime_error(err);
  if (npy.dtype != r.dtype || npy.shape != r.dims)
    throw std::runtime_error(path + ": " + npy.dtype + " (" +
                             dims_str(npy.shape) + ") is not the spec's " +
                             r.dtype + " (" + dims_str(r.dims) + ")");
  Tensor t = tensor_from_npy(npy).to(be->device);
  const std::string q8 = ".w_q8";
  if (r.name.size() > q8.size() &&
      r.name.compare(r.name.size() - q8.size(), q8.size(), q8) == 0) {
    if (t.dim() != 2)
      throw std::runtime_error(path + ": a w_q8 weight is (in, out)");
    t = t.t().contiguous().t();
  }
  be->weights[r.name] = t;
}

// A ProgramConfig with the bundle's rows (serving.txt) and the device's.
ProgramConfig base_config(Backend* be) {
  ProgramConfig c;
  const dlimg_bundle::Index& ix = be->index;
  c.image_size = ix.image_size;
  c.compute_dtype = scalar_type(ix.compute_dtype);
  c.decoder_heads = ix.decoder_heads;
  c.vit = ix.encoder == "vit";
  c.kernel_route = ix.kernel_route;
  c.num_heads = ix.num_heads;
  c.window_size = ix.window_size;
  c.global_attn_indexes = ix.global_attn_indexes;
  c.patch_size = ix.patch_size;
  c.layer_norm_eps = ix.layer_norm_eps;
  c.kernels = be->device.is_cuda() ? &be->kernels : nullptr;
  return c;
}

// serve_birefnet_<kind>_<bucket>: the kind's row of serving.txt and its
// configuration; -> the kind.
std::string birefnet_config(Backend* be, Program* p, const std::string& spec) {
  const auto cut = spec.rfind('_');
  const std::string kind = spec.substr(0, cut);
  const dlimg_bundle::Index& ix = be->index;
  const dlimg_bundle::BirefProgram* row = nullptr;
  for (const auto& r : ix.birefnet)
    if (cut != std::string::npos && r.kind == kind &&
        std::to_string(r.bucket) == spec.substr(cut + 1))
      row = &r;
  if (!row)
    throw std::runtime_error("program " + p->name + " is not in serving.txt's "
                             "birefnet row");
  p->cfg.bucket = row->bucket;
  BirefConfig& b = p->cfg.biref;
  b.resolution = row->resolution;
  b.depths = ix.birefnet_depths;
  b.num_heads = ix.birefnet_num_heads;
  b.window = ix.birefnet_window;
  b.patch_size = ix.birefnet_patch_size;
  b.layer_norm_eps = ix.birefnet_layer_norm_eps;
  b.aspp_kernel_sizes = ix.birefnet_aspp_kernel_sizes;
  b.mul_scl_ipt = ix.birefnet_mul_scl_ipt == "cat";
  b.cxt_num = ix.birefnet_cxt_num;
  b.deform8 = ix.deform8;
  p->cfg.imagenet_mean = be->imagenet_mean;
  p->cfg.imagenet_std = be->imagenet_std;
  p->fn = birefnet_program;
  return kind;
}

// serving.txt's BiRefNet rows against a program's weights: a bundle whose
// rows and weights disagree is refused.
void check_birefnet_rows(const dlimg_bundle::Index& ix, const Weights& w,
                         const std::string& name) {
  auto width = [&](const std::string& key) {
    auto it = w.find(key);
    return it == w.end() ? int64_t(-1) : it->second.size(0);
  };
  bool ok = width("backbone.patch_embed.w") == ix.birefnet_embed_dim &&
            width("squeeze.conv_in.w") == ix.birefnet_decoder_channels[0] &&
            width("squeeze.aspp.gap.w") == ix.birefnet_decoder_channels[1] &&
            width("decoder.gdt4.w") == ix.birefnet_decoder_channels[2];
  for (size_t i = 0; ok && i < ix.birefnet_depths.size(); ++i) {
    const std::string s = "backbone.stages." + std::to_string(i) + ".blocks.";
    ok = w.count(s + std::to_string(ix.birefnet_depths[i] - 1) + ".qkv.w") &&
         !w.count(s + std::to_string(ix.birefnet_depths[i]) + ".qkv.w");
  }
  if (!ok)
    throw std::runtime_error(name + ": the weights do not match serving.txt's "
                             "birefnet_embed_dim, _depths or "
                             "_decoder_channels");
}

// serving.txt's quant row against an embed program's weights
// (bundle.hpp quant_mismatch): a bundle whose row and weights disagree is
// refused.
void check_quant_rows(const dlimg_bundle::Index& ix,
                      const std::vector<SpecRow>& rows,
                      const std::string& name) {
  std::vector<std::pair<std::string, size_t>> weights;
  for (const SpecRow& r : rows)
    if (r.kind == "inw") weights.emplace_back(r.name, r.dims.size());
  const std::string problem = dlimg_bundle::quant_mismatch(ix, weights);
  if (!problem.empty()) throw std::runtime_error(name + ": " + problem);
}

// serve_<embed|decode|decode3|decode_batch<N>|amg>_<variant>_<bucket>, or
// serve_birefnet_<kind>_<bucket>
Program* get_program(Backend* be, const std::string& name) {
  auto it = be->programs.find(name);
  if (it != be->programs.end()) return it->second.get();
  auto p = std::make_unique<Program>();
  p->name = name;
  p->cfg = base_config(be);
  const std::string biref = "serve_birefnet_";
  std::string prefix;  // a BiRefNet's weights: birefnet.<kind>.
  if (name.compare(0, biref.size(), biref) == 0) {
    prefix = "birefnet." + birefnet_config(be, p.get(),
                                           name.substr(biref.size())) + ".";
  } else {
    const std::string tail = "_" + be->index.variant + "_";
    auto pos = name.rfind(tail);
    if (pos == std::string::npos)
      throw std::runtime_error("program " + name + " is not of variant " +
                               be->index.variant);
    const std::string head = name.substr(0, pos);
    p->cfg.bucket = std::stoi(name.substr(pos + tail.size()));
    const std::string batch = "serve_decode_batch";
    if (head == "serve_embed") {
      p->fn = embed_program;
      p->cfg.pixel_mean = be->pixel_mean;
      p->cfg.pixel_std = be->pixel_std;
    } else if (head == "serve_decode" || head == "serve_decode3") {
      p->fn = decode_program;
      p->cfg.multimask = head == "serve_decode3";
    } else if (head.compare(0, batch.size(), batch) == 0 &&
               head.size() > batch.size() &&
               head.find_first_not_of("0123456789", batch.size()) ==
                   std::string::npos) {
      p->fn = decode_batch_program;
      p->cfg.fork_streams = [be](int64_t n) { return fork_streams(be, n); };
    } else if (head == "serve_amg") {
      const dlimg_bundle::Index& ix = be->index;
      if (ix.amg_grid <= 0)
        throw std::runtime_error("program " + name + ": serving.txt has no "
                                 "amg row");
      p->fn = amg_program;
      p->cfg.amg_grid = ix.amg_grid;
      p->cfg.amg_masks = ix.amg_masks;
      p->cfg.amg_prenms =
          dlimg_bundle::prenms_pool(ix.amg_grid * ix.amg_grid, ix.amg_masks);
    } else {
      throw std::runtime_error("program " + name +
                               " is none of serve_embed, serve_decode, "
                               "serve_decode3, serve_decode_batch<N>, "
                               "serve_amg, serve_birefnet");
    }
  }
  const std::vector<SpecRow> rows =
      read_spec(be->dir + "/" + name + ".spec.txt");
  if (p->fn == embed_program) check_quant_rows(be->index, rows, name);
  for (const SpecRow& r : rows) {
    if (r.kind == "ind") {
      p->dynamic.push_back(r);
    } else if (r.kind == "inw") {
      load_weight(be, r);
      if (!prefix.empty()) {
        if (r.name.compare(0, prefix.size(), prefix) != 0)
          throw std::runtime_error(name + ": weight " + r.name +
                                   " lacks the prefix " + prefix);
        p->own[r.name.substr(prefix.size())] = be->weights.at(r.name);
      }
    }
  }
  if (!prefix.empty()) check_birefnet_rows(be->index, p->own, name);
  p->weights = prefix.empty() ? &be->weights : &p->own;
  p->host.resize(p->dynamic.size());
  Program* raw = p.get();
  be->programs[name] = std::move(p);
  return raw;
}

void check_inputs(const Program* p, const std::vector<Tensor>& in) {
  if (in.size() != p->dynamic.size())
    throw std::runtime_error(p->name + ": " + std::to_string(in.size()) +
                             " arguments given, the spec has " +
                             std::to_string(p->dynamic.size()));
  for (size_t i = 0; i < in.size(); ++i) {
    const SpecRow& r = p->dynamic[i];
    if (in[i].scalar_type() != scalar_type(r.dtype) ||
        in[i].sizes().vec() != r.dims)
      throw std::runtime_error(p->name + ": argument " + std::to_string(i) +
                               " is not the spec's " + r.dtype + " (" +
                               dims_str(r.dims) + ")");
  }
}

// Argument i's host buffer, free to be written: made at its first use
// (pinned on CUDA), else on CUDA its last copy to the device has completed.
Tensor& host_buffer(Backend* be, Program* p, size_t i) {
  Tensor& buf = p->host[i];
  if (!buf.defined())
    buf = at::empty(p->dynamic[i].dims,
                    at::TensorOptions()
                        .dtype(scalar_type(p->dynamic[i].dtype))
                        .pinned_memory(be->device.is_cuda()));
#ifdef DLIMG_SERVING_CUDA
  else if (p->staged)
    p->staged->synchronize();
#endif
  return buf;
}

#ifdef DLIMG_SERVING_CUDA

std::vector<Tensor> clone_all(const std::vector<Tensor>& ts) {
  std::vector<Tensor> out;
  for (const Tensor& t : ts) out.push_back(t.clone());
  return out;
}

// Executable._warm_up_and_capture: the eager warm-up on a side stream,
// then the capture of the program on static copies of its inputs.
std::vector<Tensor> warm_up_and_capture(Backend* be, Program* p,
                                        const std::vector<Tensor>& args) {
  std::vector<Tensor> inputs;
  for (const Tensor& a : args) inputs.push_back(a.to(be->device));
  at::cuda::CUDAStream caller = at::cuda::getCurrentCUDAStream();
  at::cuda::CUDAStream side = at::cuda::getStreamFromPool(false);
  std::vector<Tensor> out;
  {
    at::cuda::CUDAEvent ready;
    ready.record(caller);
    ready.block(side);
    c10::cuda::CUDAStreamGuard guard(side);
    out = p->eager(inputs);
    at::cuda::CUDAEvent done;
    done.record(side);
    done.block(caller);
  }
  std::vector<Tensor> result = clone_all(out);
  std::vector<Tensor> static_in;
  for (const Tensor& a : inputs) {
    Tensor buf = at::empty_like(a);
    buf.copy_(a);
    static_in.push_back(buf);
  }
  Launches before = counted();
  auto graph = std::make_unique<at::cuda::CUDAGraph>();
  std::vector<Tensor> static_out;
  c10::cuda::device_synchronize();
  c10::cuda::CUDACachingAllocator::emptyCache();
  try {
    c10::cuda::CUDAStreamGuard guard(side);
    graph->capture_begin({0, 0}, cudaStreamCaptureModeThreadLocal);
    try {
      static_out = p->eager(static_in);
    } catch (...) {
      try {
        graph->capture_end();
      } catch (...) {
      }
      throw;
    }
    graph->capture_end();
  } catch (const std::exception& e) {
    add_launches(since(before), -1);
    throw std::runtime_error("CUDA graph of " + p->name +
                             ": capture failed: " + e.what());
  }
  p->captured = since(before);
  add_launches(p->captured, -1);
  p->static_in = std::move(static_in);
  p->static_out = std::move(static_out);
  p->graph = std::move(graph);
  return result;
}

// Executable._copy_in: host data through pinned staging, asynchronously
// (in place when the caller filled the staging buffer, Arg::fill).
void copy_in(Backend* be, Program* p, const std::vector<Tensor>& args) {
  for (size_t i = 0; i < args.size(); ++i) {
    Tensor a = args[i];
    Tensor& buf = p->static_in[i];
    if (a.is_same(buf)) continue;
    if (a.device() != buf.device()) {
      Tensor& stage = p->host[i];
      if (!(stage.defined() && a.data_ptr() == stage.data_ptr()))
        host_buffer(be, p, i).copy_(a);
      a = stage;
    }
    buf.copy_(a, /*non_blocking=*/true);
  }
  p->staged = std::make_unique<at::cuda::CUDAEvent>();
  p->staged->record(at::cuda::getCurrentCUDAStream());
}

void replay(Program* p) {
  p->graph->replay();
  add_launches(p->captured, +1);
}

#endif  // DLIMG_SERVING_CUDA

std::vector<Tensor> run_program(Backend* be, Program* p,
                                const std::vector<Tensor>& args) {
  check_inputs(p, args);
  if (!be->device.is_cuda()) return p->eager(args);
#ifdef DLIMG_SERVING_CUDA
  c10::cuda::CUDAGuard device_guard(be->device);
  if (!p->graph) return warm_up_and_capture(be, p, args);
  copy_in(be, p, args);
  replay(p);
  return clone_all(p->static_out);
#else
  throw std::runtime_error("this serving library was built without CUDA");
#endif
}

// ROADMAP C6: the process's first call of MKL's vector math (at::sin of
// the prompt encoder's dense positional encoding, 16 x 16 x 128 values at
// image size 256, split over the OpenMP threads) now and then computes a
// worker thread's share on another path, up to 2524 ulp from the usual
// result; every later call gives the usual one. A CPU backend makes the
// encoding's first sin and cos itself, on every thread of the pool, and
// drops their results.
void warm_vector_math() {
  c10::InferenceMode guard;
  const int64_t n =
      at::internal::GRAIN_SIZE * std::max<int64_t>(1, at::get_num_threads());
  Tensor x = at::linspace(-8.0, 8.0, n, at::kFloat);
  at::sin(x);
  at::cos(x);
}

bool bytes_equal(const Tensor& a, const Tensor& b) {
  Tensor x = a.contiguous().cpu(), y = b.contiguous().cpu();
  return x.scalar_type() == y.scalar_type() && x.sizes() == y.sizes() &&
         std::memcmp(x.data_ptr(), y.data_ptr(), x.nbytes()) == 0;
}

}  // namespace

Backend* create(const std::string& bundle_dir, int device, std::string* err) {
  try {
    auto be = std::make_unique<Backend>();
    be->dir = bundle_dir;
    std::string problem = dlimg_bundle::read_index(bundle_dir, &be->index);
    if (!problem.empty()) throw std::runtime_error(problem);
    scalar_type(be->index.compute_dtype);  // a known dtype
    const std::string want = device == kCuda ? "gpu" : "cpu";
    if (be->index.backend != want)
      throw std::runtime_error(
          bundle_dir + " was exported for backend " + be->index.backend +
          ", not " + want + " (re-export with --backend " + want + ")");
    if (device == kCuda) {
#ifdef DLIMG_SERVING_CUDA
      if (!at::globalContext().hasCUDA() || c10::cuda::device_count() < 1)
        throw std::runtime_error("backend gpu (cuda:0) requested, but no "
                                 "CUDA device is available");
      be->device = at::Device(at::kCUDA, 0);
      load_kernels(be.get());
#else
      throw std::runtime_error("backend gpu (cuda:0) requested, but this "
                               "serving library was built without CUDA");
#endif
    } else if (device != kCpu) {
      throw std::runtime_error("unknown device " + std::to_string(device));
    }
    // ops/preprocess.py _pixel_stats: float32 from Python's doubles.
    be->pixel_mean = at::tensor(std::vector<double>{123.675, 116.28, 103.53},
                                at::dtype(at::kDouble))
                         .to(at::kFloat)
                         .to(be->device);
    be->pixel_std = at::tensor(std::vector<double>{58.395, 57.12, 57.375},
                               at::dtype(at::kDouble))
                        .to(at::kFloat)
                        .to(be->device);
    // runtime/birefnet.py _imagenet_stats: float32 from Python's doubles.
    be->imagenet_mean = at::tensor(std::vector<double>{0.485, 0.456, 0.406},
                                   at::dtype(at::kDouble))
                            .to(at::kFloat)
                            .to(be->device);
    be->imagenet_std = at::tensor(std::vector<double>{0.229, 0.224, 0.225},
                                  at::dtype(at::kDouble))
                           .to(at::kFloat)
                           .to(be->device);
    if (!be->device.is_cuda()) warm_vector_math();
    std::lock_guard<std::mutex> lk(g_registry_mu);
    g_registry.insert(be.get());
    if (err) err->clear();
    return be.release();
  } catch (const std::exception& e) {
    if (err) *err = e.what();
    return nullptr;
  }
}

void destroy(Backend* be) {
  if (!be) return;
  {
    std::lock_guard<std::mutex> lk(g_registry_mu);
    g_registry.erase(be);
  }
  {
    std::lock_guard<std::mutex> lk(be->mu);
    be->programs.clear();
    be->weights.clear();
#ifdef DLIMG_SERVING_CUDA
    if (!be->forks.empty()) {
      c10::cuda::device_synchronize();
      for (auto& kv : be->forks)
        for (void* s : kv.second)
          cudaStreamDestroy(static_cast<cudaStream_t>(s));
    }
#endif
  }
  // The kernel library stays loaded: graphs destroyed above may still be
  // referenced by work queued on the device.
  delete be;
}

const std::string& variant(Backend* b) { return b->index.variant; }
int image_size(Backend* b) { return b->index.image_size; }
const std::vector<int>& buckets(Backend* b) { return b->index.buckets; }
const std::vector<int>& batch_sizes(Backend* b) { return b->index.batch; }

bool run(Backend* be, const std::string& name, const std::vector<Arg>& args,
         std::vector<Buf*>* outs, std::string* err) {
  try {
    std::lock_guard<std::mutex> lk(be->mu);
    Program* p = get_program(be, name);
    std::vector<Tensor> in;
    for (size_t i = 0; i < args.size(); ++i) {
      const Arg& a = args[i];
      if (a.dev) {
        in.push_back(a.dev->t);
      } else if (a.host) {
        in.push_back(at::from_blob(const_cast<void*>(a.host), a.dims,
                                   at::TensorOptions().dtype(
                                       scalar_type(a.dtype))));
      } else if (a.fill) {
        if (i >= p->dynamic.size() || a.dims != p->dynamic[i].dims ||
            a.dtype != p->dynamic[i].dtype)
          throw std::runtime_error("argument " + std::to_string(i) +
                                   " to fill is not of the spec");
        Tensor& buf = host_buffer(be, p, i);
        a.fill(a.fill_ctx, buf.data_ptr());
        in.push_back(buf);
      } else {
        throw std::runtime_error("argument " + std::to_string(i) +
                                 " has no data");
      }
    }
    std::vector<Tensor> out = run_program(be, p, in);
    outs->clear();
    for (Tensor& t : out) outs->push_back(new Buf{t});
    return true;
  } catch (const std::exception& e) {
    if (err) *err = name + ": " + e.what();
    return false;
  }
}

bool fetch(Backend* be, Buf* buf, void* dst, size_t dst_size,
           std::string* err) {
  try {
    std::lock_guard<std::mutex> lk(be->mu);
    Tensor t = buf->t.contiguous();
    if (t.nbytes() != dst_size)
      throw std::runtime_error("fetch of " + std::to_string(t.nbytes()) +
                               " bytes into " + std::to_string(dst_size));
    at::from_blob(dst, t.sizes(), at::TensorOptions().dtype(t.scalar_type()))
        .copy_(t);
    return true;
  } catch (const std::exception& e) {
    if (err) *err = std::string("fetch: ") + e.what();
    return false;
  }
}

void release(Backend*, Buf* buf) { delete buf; }

bool validate(Backend* be, const std::string& name, std::string* report,
              std::string* err) {
  try {
    std::vector<SpecRow> rows = read_spec(be->dir + "/" + name + ".spec.txt");
    std::vector<dlimg_npy::Npy> dyn, want;
    for (const SpecRow& r : rows) {
      if (r.kind == "inw") continue;
      std::vector<dlimg_npy::Npy>& into = r.kind == "ind" ? dyn : want;
      std::string path = be->dir + "/" + name +
                         (r.kind == "ind" ? ".in" : ".out") +
                         std::to_string(into.size()) + ".npy";
      dlimg_npy::Npy npy;
      std::string e;
      if (!dlimg_npy::load_npy(path, &npy, &e)) throw std::runtime_error(e);
      into.push_back(std::move(npy));
    }
    std::vector<Arg> args;
    for (const dlimg_npy::Npy& d : dyn) {
      Arg a;
      a.host = d.data.data();
      a.dims = d.shape;
      a.dtype = d.dtype;
      args.push_back(a);
    }
    std::vector<Buf*> outs;
    std::string e;
    if (!run(be, name, args, &outs, &e)) throw std::runtime_error(e);
    bool ok = outs.size() == want.size();
    std::ostringstream rep;
    if (!ok)
      rep << name << ": " << outs.size() << " outputs, the spec lists "
          << want.size() << "\n";
    for (size_t i = 0; ok && i < outs.size(); ++i) {
      std::string got(want[i].data.size(), '\0');
      if (!fetch(be, outs[i], &got[0], got.size(), &e)) {
        ok = false;
        rep << name << " out" << i << ": " << e << "\n";
        break;
      }
      size_t n_diff = 0;
      for (size_t b = 0; b < got.size(); ++b)
        n_diff += got[b] != want[i].data[b];
      rep << name << " out" << i << ": " << n_diff << "/" << got.size()
          << " bytes differ\n";
      ok = ok && n_diff == 0;
    }
    for (Buf* o : outs) release(be, o);
    if (report) *report = rep.str();
    if (!ok && err) *err = "output mismatch (see report)";
    return ok;
  } catch (const std::exception& e) {
    if (err) *err = e.what();
    return false;
  }
}

void held_weights(Backend* be, int64_t* count, int64_t* bytes) {
  std::lock_guard<std::mutex> lk(be->mu);
  int64_t n = 0;
  for (const auto& kv : be->weights) n += int64_t(kv.second.nbytes());
  if (count) *count = int64_t(be->weights.size());
  if (bytes) *bytes = n;
}

namespace {

// For every captured graph of every live backend: replay it on its static
// inputs, run its eager program on the same inputs, and compare the
// outputs byte for byte (the launch counters are left as they were).
// -> the number of graphs held; -1 + err on a difference or a failure.
int check_replays(std::string* report, std::string* err) {
  std::ostringstream rep;
  int held = 0;
  try {
#ifdef DLIMG_SERVING_CUDA
    std::lock_guard<std::mutex> reg(g_registry_mu);
    for (Backend* be : g_registry) {
      std::lock_guard<std::mutex> lk(be->mu);
      c10::cuda::CUDAGuard device_guard(be->device);
      for (auto& kv : be->programs) {
        Program* p = kv.second.get();
        if (!p->graph) continue;
        Launches saved = counted();
        replay(p);
        std::vector<Tensor> got = clone_all(p->static_out);
        std::vector<Tensor> want = p->eager(p->static_in);
        add_launches(since(saved), -1);
        bool same = got.size() == want.size();
        for (size_t i = 0; same && i < got.size(); ++i)
          same = bytes_equal(got[i], want[i]);
        rep << p->name << ": replay " << (same ? "==" : "!=") << " eager\n";
        if (!same)
          throw std::runtime_error(p->name + ": the graph's replay differs "
                                             "from its eager program");
        ++held;
      }
    }
#endif
  } catch (const std::exception& e) {
    if (report) *report = rep.str();
    if (err) *err = e.what();
    return -1;
  }
  if (report) *report = rep.str();
  return held;
}

}  // namespace
}  // namespace dlimg_torch

// ---------------------------------------------------------------------------
// The C table
// ---------------------------------------------------------------------------

namespace {

thread_local std::string g_serving_error;

using dlimg_torch::Backend;
using dlimg_torch::Buf;

void* c_create(const char* dir, int device) {
  std::string err;
  Backend* be = dlimg_torch::create(dir ? dir : "", device, &err);
  if (!be) g_serving_error = err;
  return be;
}

void c_destroy(void* be) { dlimg_torch::destroy(static_cast<Backend*>(be)); }

const char* c_variant(void* be) {
  return dlimg_torch::variant(static_cast<Backend*>(be)).c_str();
}

int c_image_size(void* be) {
  return dlimg_torch::image_size(static_cast<Backend*>(be));
}

int c_bucket_count(void* be) {
  return int(dlimg_torch::buckets(static_cast<Backend*>(be)).size());
}

int c_bucket(void* be, int i) {
  return dlimg_torch::buckets(static_cast<Backend*>(be)).at(size_t(i));
}

int c_batch_count(void* be) {
  return int(dlimg_torch::batch_sizes(static_cast<Backend*>(be)).size());
}

int c_batch_size(void* be, int i) {
  return dlimg_torch::batch_sizes(static_cast<Backend*>(be)).at(size_t(i));
}

void c_launches(int64_t* counts, int n) {
  dlimg_torch::Launches l = dlimg_torch::counted();
  for (int i = 0; i < n && i < dlimg_torch::kKernels; ++i) counts[i] = l.n[i];
}

void c_int8_linears(int64_t* counts, int n) {
  dlimg_torch::Launches l = dlimg_torch::counted();
  for (int i = 0; i < n && i < dlimg_torch::kCounted - dlimg_torch::kKernels;
       ++i)
    counts[i] = l.n[dlimg_torch::kKernels + i];
}

void c_reset_launches() {
  for (auto* c : dlimg_torch::kCounters) *c = 0;
}

int c_run(void* be, const char* name, const dlimg_serving_arg* args,
          int n_args, void** outs, int max_outs, int* n_outs) {
  std::vector<dlimg_torch::Arg> a(size_t(std::max(n_args, 0)));
  for (int i = 0; i < n_args; ++i) {
    a[i].host = args[i].host;
    a[i].dims.assign(args[i].dims, args[i].dims + args[i].ndim);
    a[i].dtype = args[i].dtype ? args[i].dtype : "";
    a[i].dev = static_cast<Buf*>(args[i].dev);
    a[i].fill = args[i].fill;
    a[i].fill_ctx = args[i].fill_ctx;
  }
  std::vector<Buf*> o;
  std::string err;
  if (!dlimg_torch::run(static_cast<Backend*>(be), name, a, &o, &err)) {
    g_serving_error = err;
    return 1;
  }
  if (int(o.size()) > max_outs) {
    for (Buf* b : o) dlimg_torch::release(static_cast<Backend*>(be), b);
    g_serving_error = std::string(name) + ": " + std::to_string(o.size()) +
                      " outputs, room for " + std::to_string(max_outs);
    return 1;
  }
  for (size_t i = 0; i < o.size(); ++i) outs[i] = o[i];
  *n_outs = int(o.size());
  return 0;
}

int c_fetch(void* be, void* buf, void* dst, size_t dst_size) {
  std::string err;
  if (!dlimg_torch::fetch(static_cast<Backend*>(be), static_cast<Buf*>(buf),
                          dst, dst_size, &err)) {
    g_serving_error = err;
    return 1;
  }
  return 0;
}

void c_release(void* be, void* buf) {
  dlimg_torch::release(static_cast<Backend*>(be), static_cast<Buf*>(buf));
}

const char* c_last_error() { return g_serving_error.c_str(); }

int c_cuda_available() {
#ifdef DLIMG_SERVING_CUDA
  try {
    return at::globalContext().hasCUDA() && c10::cuda::device_count() > 0;
  } catch (...) {
    return 0;
  }
#else
  return 0;
#endif
}

const dlimg_serving_api kApi = {
    DLIMG_SERVING_ABI, c_create,        c_destroy,   c_variant,
    c_image_size,      c_bucket_count,  c_bucket,    c_batch_count,
    c_batch_size,      c_run,           c_fetch,     c_release,
    c_last_error,      c_cuda_available, c_launches, c_reset_launches,
};

}  // namespace

extern "C" __attribute__((visibility("default"))) const dlimg_serving_api*
dlimg_serving_init(void) {
  return &kApi;
}

extern "C" __attribute__((visibility("default"))) void dlimg_serving_launches(
    int64_t* counts, int n) {
  c_launches(counts, n);
}

extern "C" __attribute__((visibility("default"))) void
dlimg_serving_reset_launches(void) {
  c_reset_launches();
}

extern "C" __attribute__((visibility("default"))) void
dlimg_serving_int8_linears(int64_t* counts, int n) {
  c_int8_linears(counts, n);
}

extern "C" __attribute__((visibility("default"))) void
dlimg_serving_held_weights(int64_t* count, int64_t* bytes) {
  int64_t n = 0, b = 0;
  std::lock_guard<std::mutex> reg(dlimg_torch::g_registry_mu);
  for (dlimg_torch::Backend* be : dlimg_torch::g_registry) {
    int64_t bn = 0, bb = 0;
    dlimg_torch::held_weights(be, &bn, &bb);
    n += bn;
    b += bb;
  }
  if (count) *count = n;
  if (bytes) *bytes = b;
}

extern "C" __attribute__((visibility("default"))) int
dlimg_serving_check_replays(char* report, size_t report_size) {
  std::string rep, err;
  int n = dlimg_torch::check_replays(&rep, &err);
  if (n < 0) rep += err + "\n";
  if (report && report_size) {
    size_t k = std::min(rep.size(), report_size - 1);
    std::memcpy(report, rep.data(), k);
    report[k] = '\0';
  }
  return n;
}
