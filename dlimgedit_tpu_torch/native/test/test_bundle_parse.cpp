// A serving bundle's on-disk contract, without libtorch: for every
// <program>.spec.txt, each row's .npy file (a weight's weights/<name>.npy,
// a dynamic argument's <program>.in<k>.npy, an output's .out<i>.npy) read
// through the backend's own reader (native/src/npy.hpp) must have the
// row's dtype (bf16 stored as its 16 bits), dims and payload size, and
// every weight row must name its tensor. Each file of weights/ must be
// named by a spec, so that every weight is stored once. The port's copy
// of the JAX package's native/test/test_bundle_parse.cpp.
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
  int programs = 0, rows = 0, weights = 0, bf16_rows = 0;
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
              "%zu weight files\n", programs, rows, weights, bf16_rows,
              stored);
  return 0;
}
