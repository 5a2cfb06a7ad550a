// A serving bundle's index, serving.txt (tools/aot_export.py --program
// serving), and the refusals of what is not the port's bundle. Read by the
// port's C library (capi.cpp: is_backend_supported and the refusals before
// it loads the serving library) and by the serving backend
// (torch_backend.cpp): one parser and one format name. Header-only, no
// libtorch.
#pragma once

#include <algorithm>
#include <fstream>
#include <sstream>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

namespace dlimg_bundle {

// tools/aot_export.py FORMAT.
constexpr char kFormat[] = "dlimgedit_tpu_torch-serving-5";
constexpr char kExporter[] =
    "python -m dlimgedit_tpu_torch.tools.aot_export --program serving";

// A BiRefNet program of the bundle: serve_birefnet_<kind>_<bucket>, its
// model's input side `resolution`.
struct BirefProgram {
  std::string kind;  // "general" | "high_res"
  int bucket = 0;
  int resolution = 0;
};

struct Index {
  std::string variant;
  std::string backend;        // "cpu" | "gpu", as exported
  std::string compute_dtype;  // the encoder's dtype
  int image_size = 1024;
  int decoder_heads = 8;
  std::vector<int> buckets;   // ascending
  std::vector<int> batch;     // serve_decode_batch<N> sizes, ascending
  std::string encoder;        // "tinyvit" | "vit"
  // The encoder's kernel route (models/sam.py with_kernels): K1 / K2 for
  // TinyViT, K1 / K3 / K4 / K5 for a ViT; off, the plain versions run.
  bool kernel_route = false;
  // A ViT's geometry (SamViTConfig).
  int num_heads = 0;
  int window_size = 0;
  std::vector<int> global_attn_indexes;
  int patch_size = 16;
  double layer_norm_eps = 1e-6;
  // Automatic mask generation (serve_amg_<variant>_<bucket>): the point
  // grid's side and the winners K; none when amg_grid is 0.
  int amg_grid = 0;
  int amg_masks = 0;
  // BiRefNet segment_objects: the programs, and the configuration they
  // share (models/birefnet.py BiRefNetConfig, its Swin's SwinConfig).
  std::vector<BirefProgram> birefnet;
  int birefnet_embed_dim = 0;
  std::vector<int> birefnet_depths, birefnet_num_heads;
  int birefnet_window = 0;
  int birefnet_patch_size = 0;
  double birefnet_layer_norm_eps = 0.0;
  // dec_inter_channels, aspp_channelster, gdt_channels
  std::vector<int> birefnet_decoder_channels;
  std::vector<int> birefnet_aspp_kernel_sizes;
  std::string birefnet_mul_scl_ipt;  // "cat" | "none"
  int birefnet_cxt_num = -1;
  // The quant row (JAX's spelling: w8, a8, deform8, comma-separated):
  // int8 encoder weights (Options.quantize_encoder), int8 activations
  // too (quantize_activations; needs w8), BiRefNet's int8 corner stack
  // (birefnet_int8_deform).
  bool w8 = false;
  bool a8 = false;
  bool deform8 = false;
};

// The quant row's modes, as JAX's exporter spells the row; "none" when
// the bundle has none.
inline std::string quant_modes(const Index& idx) {
  std::string out;
  for (auto [on, name] : {std::pair<bool, const char*>{idx.w8, "w8"},
                          {idx.a8, "a8"},
                          {idx.deform8, "deform8"}})
    if (on) out += (out.empty() ? "" : ",") + std::string(name);
  return out.empty() ? "none" : out;
}

// serving.txt's quant row against the weight rows (state_dict name, rank)
// of an embed program: with w8 every 2-D weight of a linear that
// ops/quant.py quantize_encoder makes int8 (its last name segment in
// QUANT_KEYS) is int8, w_q8 with a8 and w_q without; with no w8 none is.
// -> "" when they agree, else what the weights hold.
inline std::string quant_mismatch(
    const Index& ix,
    const std::vector<std::pair<std::string, size_t>>& weights) {
  static const char* const kQuantKeys[] = {"qkv", "proj", "fc1",
                                           "fc2", "lin1", "lin2"};
  auto ends = [](const std::string& s, const std::string& suffix) {
    return s.size() > suffix.size() &&
           s.compare(s.size() - suffix.size(), suffix.size(), suffix) == 0;
  };
  int n_q = 0, n_q8 = 0, n_float = 0;
  for (const auto& [name, rank] : weights) {
    if (ends(name, ".w_q8")) {
      ++n_q8;
    } else if (ends(name, ".w_q")) {
      ++n_q;
    } else if (ends(name, ".w") && rank == 2) {
      const std::string mod = name.substr(0, name.size() - 2);
      const std::string last = mod.substr(mod.rfind('.') + 1);
      for (const char* key : kQuantKeys) n_float += last == key;
    }
  }
  const bool ok = ix.a8   ? n_q8 > 0 && n_q == 0 && n_float == 0
                  : ix.w8 ? n_q > 0 && n_q8 == 0 && n_float == 0
                          : n_q == 0 && n_q8 == 0;
  if (ok) return "";
  return "serving.txt's quant row (" + quant_modes(ix) +
         ") does not match the weights: " + std::to_string(n_q8) +
         " w_q8, " + std::to_string(n_q) + " w_q and " +
         std::to_string(n_float) +
         " float weights of the int8 linears (qkv, proj, fc1, fc2, lin1, "
         "lin2)";
}

// runtime/amg.py _prenms_pool: the pre-NMS pool of a grid of G points (3G
// candidates), at least 3/4 of them, floored at 256 and at 4x the winners.
inline int prenms_pool(int G, int max_masks) {
  return std::min(3 * G, std::max({256, 3 * G * 3 / 4, 4 * max_masks}));
}

// "a:b" -> {a, b}, each a positive integer; throws otherwise.
inline std::vector<int> colon_ints(const std::string& val) {
  std::vector<int> out;
  std::stringstream ss(val);
  std::string tok;
  while (std::getline(ss, tok, ':')) {
    size_t used = 0;
    int v = std::stoi(tok, &used);
    if (used != tok.size() || v < 1) throw std::invalid_argument(tok);
    out.push_back(v);
  }
  return out;
}

// "a,b,c" -> ints; throws on a token that is not one.
inline std::vector<int> int_list(const std::string& val) {
  std::vector<int> out;
  std::stringstream bs(val);
  std::string tok;
  while (std::getline(bs, tok, ',')) {
    if (tok.empty()) continue;
    size_t used = 0;
    int v = std::stoi(tok, &used);
    if (used != tok.size()) throw std::invalid_argument(tok);
    out.push_back(v);
  }
  return out;
}

inline bool flag(const std::string& val) {
  if (val != "0" && val != "1") throw std::invalid_argument(val);
  return val == "1";
}

// Reads dir/serving.txt into *out. -> "" for a bundle of the port's
// exporter, else why `dir` is none: a JAX bundle, another format (an
// older export), a malformed or missing row, a quant row with an unknown
// mode or a8 without w8, or a gpu bundle with the encoder's kernel route
// off.
inline std::string read_index(const std::string& dir, Index* out) {
  const std::string where = "DLIMG_PJRT_BUNDLE=" + dir;
  const std::string write = ": write the port's bundle with " +
                            std::string(kExporter);
  if (std::ifstream(dir + "/plugin_path.txt"))
    return where + " is a JAX PJRT serving bundle (plugin_path.txt, .pjrt "
                   "programs): its serving.txt does not name the port's "
                   "bundle format " + std::string(kFormat) + write;
  std::ifstream f(dir + "/serving.txt");
  if (!f) return where + " holds no serving.txt" + write;
  Index idx;
  std::string line, format, quant;
  bool has_quant = false;
  try {
    while (std::getline(f, line)) {
      auto t = line.find('\t');
      if (t == std::string::npos) continue;
      std::string key = line.substr(0, t), val = line.substr(t + 1);
      while (!val.empty() && (val.back() == '\r' || val.back() == ' '))
        val.pop_back();
      if (key == "format") format = val;
      else if (key == "quant") {
        quant = val;
        has_quant = true;
      }
      else if (key == "variant") idx.variant = val;
      else if (key == "backend") idx.backend = val;
      else if (key == "compute_dtype") idx.compute_dtype = val;
      else if (key == "image_size") idx.image_size = std::stoi(val);
      else if (key == "decoder_heads") idx.decoder_heads = std::stoi(val);
      else if (key == "buckets") idx.buckets = int_list(val);
      else if (key == "batch") idx.batch = int_list(val);
      else if (key == "encoder") idx.encoder = val;
      else if (key == "kernel_route") idx.kernel_route = flag(val);
      else if (key == "num_heads") idx.num_heads = std::stoi(val);
      else if (key == "window_size") idx.window_size = std::stoi(val);
      else if (key == "global_attn_indexes")
        idx.global_attn_indexes = int_list(val);
      else if (key == "patch_size") idx.patch_size = std::stoi(val);
      else if (key == "layer_norm_eps") idx.layer_norm_eps = std::stod(val);
      else if (key == "amg") {
        std::vector<int> gk = colon_ints(val);
        if (gk.size() != 2) throw std::invalid_argument(val);
        idx.amg_grid = gk[0];
        idx.amg_masks = gk[1];
      } else if (key == "birefnet") {
        std::stringstream bs(val);
        std::string spec;
        while (std::getline(bs, spec, ',')) {
          auto cut = spec.find(':');
          if (cut == std::string::npos) throw std::invalid_argument(spec);
          std::vector<int> br = colon_ints(spec.substr(cut + 1));
          if (br.size() != 2) throw std::invalid_argument(spec);
          idx.birefnet.push_back({spec.substr(0, cut), br[0], br[1]});
        }
      } else if (key == "birefnet_embed_dim")
        idx.birefnet_embed_dim = std::stoi(val);
      else if (key == "birefnet_depths") idx.birefnet_depths = int_list(val);
      else if (key == "birefnet_num_heads")
        idx.birefnet_num_heads = int_list(val);
      else if (key == "birefnet_window") idx.birefnet_window = std::stoi(val);
      else if (key == "birefnet_patch_size")
        idx.birefnet_patch_size = std::stoi(val);
      else if (key == "birefnet_layer_norm_eps")
        idx.birefnet_layer_norm_eps = std::stod(val);
      else if (key == "birefnet_decoder_channels")
        idx.birefnet_decoder_channels = int_list(val);
      else if (key == "birefnet_aspp_kernel_sizes")
        idx.birefnet_aspp_kernel_sizes = int_list(val);
      else if (key == "birefnet_mul_scl_ipt") idx.birefnet_mul_scl_ipt = val;
      else if (key == "birefnet_cxt_num") idx.birefnet_cxt_num = std::stoi(val);
    }
  } catch (const std::exception&) {
    return where + ": malformed serving.txt line '" + line + "'" + write;
  }
  if (format != kFormat)
    return where + ": serving.txt names the bundle format '" + format +
           "', not the port's " + std::string(kFormat) +
           " (an older export is not read)" + write;
  if (has_quant) {
    std::stringstream qs(quant);
    std::string mode;
    bool any = false;
    while (std::getline(qs, mode, ',')) {
      any = true;
      if (mode == "w8") idx.w8 = true;
      else if (mode == "a8") idx.a8 = true;
      else if (mode == "deform8") idx.deform8 = true;
      else
        return where + ": serving.txt's quant row names an unknown mode '" +
               mode + "' (the modes are w8, a8, deform8)" + write;
    }
    if (!any)
      return where + ": serving.txt's quant row names no mode" + write;
    if (idx.a8 && !idx.w8)
      return where + ": serving.txt's quant row names a8 without w8 (int8 "
                     "activations run on int8 weights)" + write;
  }
  if (idx.buckets.empty() || idx.variant.empty() || idx.backend.empty())
    return where + ": serving.txt has no variant, backend or buckets" + write;
  if (idx.encoder != "tinyvit" && idx.encoder != "vit")
    return where + ": serving.txt names no encoder (tinyvit or vit)" + write;
  if (idx.encoder == "vit" &&
      (idx.num_heads <= 0 || idx.window_size <= 0 || idx.patch_size <= 0))
    return where + ": serving.txt lacks the ViT's num_heads, window_size or "
                   "patch_size" + write;
  for (int n : idx.batch)
    if (n < 1)
      return where + ": serving.txt has a batch size below 1" + write;
  if (idx.amg_grid > 0 && idx.amg_masks > 3 * idx.amg_grid * idx.amg_grid)
    return where + ": serving.txt's amg row names more winners than the "
                   "grid's 3 * grid^2 candidates" + write;
  for (const BirefProgram& b : idx.birefnet)
    if ((b.kind != "general" && b.kind != "high_res") || b.resolution % 64)
      return where + ": serving.txt's birefnet row names a kind other than "
                     "general or high_res, or a resolution that is no "
                     "multiple of 64" + write;
  if (!idx.birefnet.empty() &&
      (idx.birefnet_embed_dim <= 0 || idx.birefnet_depths.size() != 4 ||
       idx.birefnet_num_heads.size() != 4 || idx.birefnet_window <= 0 ||
       idx.birefnet_patch_size <= 0 || idx.birefnet_layer_norm_eps <= 0.0 ||
       idx.birefnet_decoder_channels.size() != 3 ||
       idx.birefnet_aspp_kernel_sizes.empty() ||
       (idx.birefnet_mul_scl_ipt != "cat" &&
        idx.birefnet_mul_scl_ipt != "none") ||
       idx.birefnet_cxt_num < 0 || idx.birefnet_cxt_num > 3))
    return where + ": serving.txt has a birefnet row but lacks the "
                   "BiRefNet's configuration rows (birefnet_embed_dim, "
                   "_depths, _num_heads, _window, _patch_size, "
                   "_layer_norm_eps, _decoder_channels, _aspp_kernel_sizes, "
                   "_mul_scl_ipt, _cxt_num)" + write;
  if (idx.backend == "gpu" && !idx.kernel_route)
    return where + ": a gpu bundle must have the encoder's kernel route on "
                   "(kernel_route 1)" + write;
  std::sort(idx.buckets.begin(), idx.buckets.end());
  std::sort(idx.batch.begin(), idx.batch.end());
  *out = idx;
  return "";
}

}  // namespace dlimg_bundle
