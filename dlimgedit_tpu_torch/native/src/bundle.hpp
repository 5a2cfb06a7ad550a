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
#include <vector>

namespace dlimg_bundle {

// tools/aot_export.py FORMAT.
constexpr char kFormat[] = "dlimgedit_tpu_torch-serving-2";
constexpr char kExporter[] =
    "python -m dlimgedit_tpu_torch.tools.aot_export --program serving";

struct Index {
  std::string variant;
  std::string backend;        // "cpu" | "gpu", as exported
  std::string compute_dtype;  // the encoder's dtype
  int image_size = 1024;
  int decoder_heads = 8;
  std::vector<int> buckets;   // ascending
};

// Reads dir/serving.txt into *out. -> "" for a bundle of the port's
// exporter, else why `dir` is none.
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
  std::string line, format;
  try {
    while (std::getline(f, line)) {
      auto t = line.find('\t');
      if (t == std::string::npos) continue;
      std::string key = line.substr(0, t), val = line.substr(t + 1);
      while (!val.empty() && (val.back() == '\r' || val.back() == ' '))
        val.pop_back();
      if (key == "format") format = val;
      else if (key == "variant") idx.variant = val;
      else if (key == "backend") idx.backend = val;
      else if (key == "compute_dtype") idx.compute_dtype = val;
      else if (key == "image_size") idx.image_size = std::stoi(val);
      else if (key == "decoder_heads") idx.decoder_heads = std::stoi(val);
      else if (key == "buckets") {
        std::stringstream bs(val);
        std::string tok;
        while (std::getline(bs, tok, ','))
          if (!tok.empty()) idx.buckets.push_back(std::stoi(tok));
      }
    }
  } catch (const std::exception&) {
    return where + ": malformed serving.txt line '" + line + "'" + write;
  }
  if (format != kFormat)
    return where + ": serving.txt does not name the port's bundle format " +
           std::string(kFormat) + write;
  if (idx.buckets.empty() || idx.variant.empty() || idx.backend.empty())
    return where + ": serving.txt has no variant, backend or buckets" + write;
  std::sort(idx.buckets.begin(), idx.buckets.end());
  *out = idx;
  return "";
}

}  // namespace dlimg_bundle
