// The serving programs of the port's Python-free route (torch_backend.hpp):
// C++ on ATen that mirrors the port's Python modules op for op, so that a
// program gives the bytes the Python path gives on the same device.
//
//   embed   runtime/segmentation.py::_build_embed_fn: ops/preprocess.py
//           sam_preprocess, then models/tinyvit.py (MobileSAM's encoder)
//   decode  runtime/segmentation.py::_build_decode_fn with
//           largest_component off: models/sam.py decode_masks
//           (prompt_encoder.py, mask_decoder.py), ops/postprocess.py
//           upsample_mask_logits and pack_mask_bits
//
// Weights are looked up by their state_dict name (the bundle's spec).
#pragma once

#include <ATen/ATen.h>

#include <atomic>
#include <map>
#include <string>
#include <vector>

namespace dlimg_torch {

using Weights = std::map<std::string, at::Tensor>;

// The C entry points of the port's kernel library (ops/cuda_build.py's
// _SIGNATURES): each returns the launch's cudaError_t.
struct Kernels {
  // x, scale, bias, out, rows, cols, dtype, eps, stream
  using LayerNorm = int (*)(const void*, const void*, const void*, void*, int,
                            int, int, float, void*);
  // qkv, bias, out, g, n, nh, kd, dtype, scale, stream
  using LevitAttention = int (*)(const void*, const void*, void*, int, int,
                                 int, int, int, float, void*);
  LayerNorm layer_norm = nullptr;
  LevitAttention levit_attention = nullptr;
};

// Launch counters of K1 and K2 (each launch on a CUDA tensor adds one).
extern std::atomic<int64_t> g_layer_norm_launches;
extern std::atomic<int64_t> g_levit_attention_launches;

struct ProgramConfig {
  int image_size = 1024;   // SamConfig.image_size
  int bucket = 1024;       // the canvas bucket of the program
  at::ScalarType compute_dtype = at::kBFloat16;  // the encoder's dtype
  int decoder_heads = 8;   // MaskDecoderConfig.num_heads
  bool multimask = false;  // decode3: tokens 1..3 and their IoUs
  const Kernels* kernels = nullptr;  // required on CUDA tensors
  at::Tensor pixel_mean;   // SAM's pixel statistics on the device, made
  at::Tensor pixel_std;    // once, outside any capture
};

// (canvas u8 (S, S, 3), sizes i32 (4,)) -> {embedding f32 (1, E, E, C)}
std::vector<at::Tensor> embed_program(const Weights& w, const ProgramConfig& c,
                                      const std::vector<at::Tensor>& in);
// (embedding, points f32 (1, 2, 2), labels f32 (1, 2), sizes i32 (4,))
//   -> {packed masks u8 (T * bucket * bucket / 8,), IoUs f32 (T,)}
std::vector<at::Tensor> decode_program(const Weights& w,
                                       const ProgramConfig& c,
                                       const std::vector<at::Tensor>& in);

}  // namespace dlimg_torch
