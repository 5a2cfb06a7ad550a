// A serving bundle's on-disk contract, without libtorch: for every
// <program>.spec.txt, each row's .npy file (a weight's weights/<name>.npy,
// a dynamic argument's <program>.in<k>.npy, an output's .out<i>.npy) read
// through the backend's own reader (native/src/npy.hpp) must have the
// row's dtype (bf16 stored as its 16 bits), dims and payload size, and
// every weight row must name its tensor. Each file of weights/ must be
// named by a spec, so that every weight is stored once. serving.txt is
// read through the backend's own parser (native/src/bundle.hpp): its
// format (an older one is refused), encoder, kernel route and geometry,
// the amg grid and winners (and the pre-NMS pool they give), the BiRefNet
// programs and configuration (a birefnet row without the configuration
// rows is refused), the quant row (an unknown mode and a8 without w8 are
// refused; each embed program's weights must be int8 as the row says:
// w_q8 with a8, w_q with w8 alone, neither without it), and every bucket
// must have its embed and decode programs, one serve_decode_batch<N> per
// batch size and with an amg row its serve_amg, and each BiRefNet entry
// its serve_birefnet_<kind>_<bucket>. Counts the int8 weight rows and
// their bytes. The port's copy of the JAX package's
// native/test/test_bundle_parse.cpp.
//
//   test_bundle_parse <bundle_dir>    (exit 77 = skip, no dir given)

#include <cstdint>
#include <cstdio>
#include <filesystem>
#include <fstream>
#include <set>
#include <sstream>
#include <string>
#include <vector>

#include "../src/bundle.hpp"
#include "../src/npy.hpp"

namespace fs = std::filesystem;

// "d0,d1,..." -> dims; false on any non-numeric token ("" -> scalar, ok).
static bool parse_dims(const std::string& s, std::vector<int64_t>* out) {
  out->clear();
  if (s.empty()) return true;
  std::stringstream ds(s);
  std::string tok;
  while (std::getline(ds, tok, ',')) {
    if (tok.empty() ||
        tok.find_first_not_of("0123456789") != std::string::npos)
      return false;
    out->push_back(std::stoll(tok));
  }
  return true;
}

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "SKIP: no bundle dir argument\n");
    return 77;
  }
  fs::path dir(argv[1]);
  dlimg_bundle::Index index;
  const std::string problem = dlimg_bundle::read_index(argv[1], &index);
  if (!problem.empty()) {
    std::fprintf(stderr, "FATAL: %s\n", problem.c_str());
    return 1;
  }
  std::string batch, globals;
  for (int n : index.batch) batch += (batch.empty() ? "" : ",") + std::to_string(n);
  for (int g : index.global_attn_indexes)
    globals += (globals.empty() ? "" : ",") + std::to_string(g);
  std::printf("serving.txt: variant %s, encoder %s, kernel route %s, batch "
              "sizes [%s]", index.variant.c_str(), index.encoder.c_str(),
              index.kernel_route ? "on" : "off",
              batch.c_str());
  if (index.encoder == "vit")
    std::printf(", num_heads %d, window_size %d, global_attn_indexes [%s], "
                "patch_size %d, layer_norm_eps %g", index.num_heads,
                index.window_size, globals.c_str(), index.patch_size,
                index.layer_norm_eps);
  std::printf("\n");
  std::printf("serving.txt: quant %s\n",
              dlimg_bundle::quant_modes(index).c_str());
  if (index.amg_grid > 0)
    std::printf("serving.txt: amg grid %d, max_masks %d, pre-NMS pool %d\n",
                index.amg_grid, index.amg_masks,
                dlimg_bundle::prenms_pool(index.amg_grid * index.amg_grid,
                                          index.amg_masks));
  std::vector<std::string> want_biref;
  if (!index.birefnet.empty()) {
    std::string progs, depths, heads, chans, ks;
    for (const auto& b : index.birefnet) {
      progs += (progs.empty() ? "" : ",") + b.kind + ":" +
               std::to_string(b.bucket) + ":" + std::to_string(b.resolution);
      want_biref.push_back("serve_birefnet_" + b.kind + "_" +
                           std::to_string(b.bucket));
    }
    auto join = [](const std::vector<int>& v) {
      std::string out;
      for (int x : v) out += (out.empty() ? "" : ",") + std::to_string(x);
      return out;
    };
    std::printf("serving.txt: birefnet %s, embed_dim %d, depths [%s], "
                "num_heads [%s], window %d, patch_size %d, layer_norm_eps "
                "%g, decoder channels [%s], aspp kernel sizes [%s], "
                "mul_scl_ipt %s, cxt_num %d\n", progs.c_str(),
                index.birefnet_embed_dim, join(index.birefnet_depths).c_str(),
                join(index.birefnet_num_heads).c_str(), index.birefnet_window,
                index.birefnet_patch_size, index.birefnet_layer_norm_eps,
                join(index.birefnet_decoder_channels).c_str(),
                join(index.birefnet_aspp_kernel_sizes).c_str(),
                index.birefnet_mul_scl_ipt.c_str(), index.birefnet_cxt_num);
  }
  for (const std::string& prog : want_biref)
    if (!fs::exists(dir / (prog + ".spec.txt"))) {
      std::fprintf(stderr, "FATAL: serving.txt names no program %s\n",
                   prog.c_str());
      return 1;
    }
  for (int b : index.buckets) {
    const std::string tail = "_" + index.variant + "_" + std::to_string(b);
    std::vector<std::string> want = {"serve_embed" + tail,
                                     "serve_decode" + tail,
                                     "serve_decode3" + tail};
    for (int n : index.batch)
      want.push_back("serve_decode_batch" + std::to_string(n) + tail);
    if (index.amg_grid > 0) want.push_back("serve_amg" + tail);
    for (const std::string& prog : want)
      if (!fs::exists(dir / (prog + ".spec.txt"))) {
        std::fprintf(stderr, "FATAL: serving.txt names no program %s\n",
                     prog.c_str());
        return 1;
      }
  }
  int programs = 0, rows = 0, weights = 0, bf16_rows = 0, int8_rows = 0;
  int64_t int8_bytes = 0;
  std::set<std::string> named;  // weights/ files the specs name
  for (const auto& ent : fs::directory_iterator(dir)) {
    const std::string fname = ent.path().filename().string();
    const std::string suffix = ".spec.txt";
    if (fname.size() <= suffix.size() ||
        fname.compare(fname.size() - suffix.size(), suffix.size(), suffix))
      continue;
    const std::string prog = fname.substr(0, fname.size() - suffix.size());
    std::ifstream spec(ent.path());
    std::string line;
    int ind_idx = 0, out_idx = 0;
    ++programs;
    std::vector<std::pair<std::string, size_t>> weight_rows;
    // Columns are single-space separated: "kind dtype dims [name]", and
    // dims may be empty (a scalar).
    while (std::getline(spec, line)) {
      if (line.empty()) continue;
      std::vector<std::string> col;
      std::stringstream ls(line);
      std::string tok;
      while (std::getline(ls, tok, ' ')) col.push_back(tok);
      const std::string kind = col.size() > 0 ? col[0] : "";
      const std::string dtype = col.size() > 1 ? col[1] : "";
      const std::string dims = col.size() > 2 ? col[2] : "";
      std::string npy;
      if (kind == "inw") {
        npy = "weights/" + (col.size() > 3 ? col[3] : "") + ".npy";
        named.insert(npy);
      } else if (kind == "ind") {
        npy = prog + ".in" + std::to_string(ind_idx++) + ".npy";
      } else if (kind == "out") {
        npy = prog + ".out" + std::to_string(out_idx++) + ".npy";
      } else {
        std::fprintf(stderr, "FATAL: %s: unknown spec row kind '%s'\n",
                     fname.c_str(), kind.c_str());
        return 1;
      }
      if (kind == "inw" && (col.size() != 4 || col[3].empty())) {
        std::fprintf(stderr, "FATAL: %s: weight row without a name '%s'\n",
                     fname.c_str(), line.c_str());
        return 1;
      }
      std::vector<int64_t> want_dims;
      if (dtype.empty() || !parse_dims(dims, &want_dims) ||
          dlimg_npy::element_size(dtype) == 0) {
        std::fprintf(stderr, "FATAL: %s: malformed spec row '%s'\n",
                     fname.c_str(), line.c_str());
        return 1;
      }
      dlimg_npy::Npy got;
      std::string err;
      if (!dlimg_npy::load_npy((dir / npy).string(), &got, &err)) {
        std::fprintf(stderr, "FATAL: loader cannot parse %s: %s\n",
                     npy.c_str(), err.c_str());
        return 1;
      }
      if (got.dtype != dtype) {
        std::fprintf(stderr, "FATAL: %s: dtype %s != spec %s\n", npy.c_str(),
                     got.dtype.c_str(), dtype.c_str());
        return 1;
      }
      if (got.shape != want_dims) {
        std::fprintf(stderr, "FATAL: %s: dims mismatch vs spec '%s'\n",
                     npy.c_str(), dims.c_str());
        return 1;
      }
      int64_t n = 1;
      for (int64_t d : want_dims) n *= d;
      if (got.data.size() != size_t(n) * dlimg_npy::element_size(dtype)) {
        std::fprintf(stderr, "FATAL: %s: payload %zu bytes != %zu\n",
                     npy.c_str(), got.data.size(),
                     size_t(n) * dlimg_npy::element_size(dtype));
        return 1;
      }
      ++rows;
      weights += kind == "inw";
      bf16_rows += dtype == "bfloat16";
      if (kind == "inw") {
        weight_rows.emplace_back(col[3], want_dims.size());
        if (dtype == "int8") {
          ++int8_rows;
          int8_bytes += n;
        }
      }
    }
    if (prog.compare(0, 12, "serve_embed_") == 0) {
      const std::string mismatch =
          dlimg_bundle::quant_mismatch(index, weight_rows);
      if (!mismatch.empty()) {
        std::fprintf(stderr, "FATAL: %s: %s\n", prog.c_str(),
                     mismatch.c_str());
        return 1;
      }
    }
  }
  if (programs == 0) {
    std::fprintf(stderr, "FATAL: no .spec.txt programs in %s\n", argv[1]);
    return 1;
  }
  size_t stored = 0;
  if (fs::is_directory(dir / "weights"))
    for (const auto& ent : fs::directory_iterator(dir / "weights")) {
      ++stored;
      const std::string f = "weights/" + ent.path().filename().string();
      if (!named.count(f)) {
        std::fprintf(stderr, "FATAL: %s is named by no spec\n", f.c_str());
        return 1;
      }
    }
  std::printf("bundle parse OK: %d programs, %d rows (%d weights, %d bf16), "
              "%d int8 weight rows of %lld bytes, %zu weight files\n",
              programs, rows, weights, bf16_rows, int8_rows,
              (long long)int8_bytes, stored);
  return 0;
}
