// Minimal .npy (v1.x, little-endian, C-contiguous) reader: a copy of the
// JAX package's native/src/npy.hpp with the port's int64 rows added.
//
// Shared by the port's serving backend (torch_backend.cpp) and the bundle
// contract test (test/test_bundle_parse.cpp), so both read the exporter's
// files (tools/aot_export.py) through the same dialect. Header-only and
// free of libtorch.
//
// The bf16 rule: numpy has no bfloat16, so the exporter stores a bf16
// tensor as its 16 bits ('<u2') and names the dtype "bfloat16" in the
// program's spec. This reader reports such a payload as "bfloat16"; the
// bundle holds no uint16 tensor.
#pragma once

#include <cstdint>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

namespace dlimg_npy {

struct Npy {
  std::string dtype;
  std::vector<int64_t> shape;
  std::string data;
};

// Bytes of one element of a dtype the reader knows (0: unknown).
inline int element_size(const std::string& dtype) {
  if (dtype == "int64") return 8;
  if (dtype == "float32" || dtype == "int32") return 4;
  if (dtype == "bfloat16") return 2;
  if (dtype == "uint8" || dtype == "int8") return 1;
  return 0;
}

inline bool load_npy(const std::string& path, Npy* out, std::string* err) {
  std::ifstream f(path, std::ios::binary);
  if (!f) {
    if (err) *err = "cannot open " + path;
    return false;
  }
  std::string raw((std::istreambuf_iterator<char>(f)),
                  std::istreambuf_iterator<char>());
  if (raw.size() < 10 || std::memcmp(raw.data(), "\x93NUMPY", 6) != 0) {
    if (err) *err = "bad npy magic: " + path;
    return false;
  }
  unsigned hlen = static_cast<unsigned char>(raw[8]) |
                  (static_cast<unsigned char>(raw[9]) << 8);
  if (raw.size() < 10 + hlen) {
    if (err) *err = "truncated npy header: " + path;
    return false;
  }
  std::string hdr = raw.substr(10, hlen);
  if (hdr.find("'fortran_order': True") != std::string::npos) {
    // The payload is streamed as C order: a Fortran-ordered array would
    // come out transposed. The exporter writes C-contiguous arrays.
    if (err)
      *err = "Fortran-ordered npy " + path +
             " (stale bundle; re-run the port's tools/aot_export.py)";
    return false;
  }
  auto dpos = hdr.find("'descr':");
  auto q1 = hdr.find('\'', dpos + 8);
  auto q2 = hdr.find('\'', q1 + 1);
  if (dpos == std::string::npos || q1 == std::string::npos ||
      q2 == std::string::npos) {
    if (err) *err = "npy header without descr: " + path;
    return false;
  }
  std::string descr = hdr.substr(q1 + 1, q2 - q1 - 1);
  if (descr == "<f4") out->dtype = "float32";
  else if (descr == "<i4") out->dtype = "int32";
  else if (descr == "<i8") out->dtype = "int64";
  else if (descr == "|u1") out->dtype = "uint8";
  else if (descr == "|i1") out->dtype = "int8";
  else if (descr == "<V2" || descr == "<u2") out->dtype = "bfloat16";
  else {
    if (err) *err = "unsupported npy descr " + descr + " in " + path;
    return false;
  }
  auto spos = hdr.find("'shape':");
  auto p1 = hdr.find('(', spos);
  auto p2 = hdr.find(')', p1);
  if (spos == std::string::npos || p1 == std::string::npos ||
      p2 == std::string::npos) {
    if (err) *err = "npy header without shape: " + path;
    return false;
  }
  std::stringstream ds(hdr.substr(p1 + 1, p2 - p1 - 1));
  std::string tok;
  out->shape.clear();
  while (std::getline(ds, tok, ',')) {
    if (tok.find_first_of("0123456789") == std::string::npos) continue;
    out->shape.push_back(std::stoll(tok));
  }
  out->data = raw.substr(10 + hlen);
  int64_t n = 1;
  for (int64_t d : out->shape) n *= d;
  if (out->data.size() != size_t(n) * element_size(out->dtype)) {
    if (err)
      *err = "npy payload of " + path + " is " +
             std::to_string(out->data.size()) + " bytes, its header says " +
             std::to_string(size_t(n) * element_size(out->dtype));
    return false;
  }
  return true;
}

}  // namespace dlimg_npy
