// The serving programs of the port's Python-free route (torch_backend.hpp):
// C++ on ATen that mirrors the port's Python modules op for op, so that a
// program gives the bytes the Python path gives on the same device.
//
//   embed   runtime/segmentation.py::_build_embed_fn: ops/preprocess.py
//           sam_preprocess, then the variant's encoder: models/tinyvit.py
//           (MobileSAM) or models/vit_sam.py (SAM ViT-B / L / H, its
//           windows partitioned; fused_window_blocks, K6, is not served)
//   decode  runtime/segmentation.py::_build_decode_fn with
//           largest_component off: models/sam.py decode_masks
//           (prompt_encoder.py, mask_decoder.py), ops/postprocess.py
//           upsample_mask_logits and pack_mask_bits
//   decode_batch  runtime/segmentation.py::_build_batch_decode_fn with
//           largest_component off: the decoder's context once, then each
//           prompt decoded and packed at batch 1, on the card each on a
//           fork stream of the calling thread (_each_prompt)
//   amg     runtime/amg.py::_build_amg_fn's run (no region refinement):
//           pass A's batched multimask decodes chunk by chunk
//           (parallel/batch.py decode_prompt_batch), the filter and the
//           pre-NMS pool (a stable sort), P1 greedy_nms (ops/amg.py: the
//           kernel on a CUDA tensor, its plain loop on a CPU tensor), the
//           top K, pass B's re-decode of the winners, upsample and pack
//   birefnet  runtime/birefnet.py::_build_birefnet_fn's run with no mesh:
//           birefnet_input (resample, ImageNet normalisation),
//           models/birefnet.py birefnet_apply (models/swin.py Swin v1,
//           ops/deform.py deform_conv2d, the decoder), sigmoid_to_u8;
//           plain ATen, no kernel of the port
//
// The encoder's kernel route is the bundle's (serving.txt): on, the
// kernels' wrappers run (K1 / K2 for TinyViT; K1 / K3 / K4 / K5 for a
// ViT), each launching its kernel on a CUDA tensor and computing its plain
// version on a CPU tensor; off, the plain versions run.
//
// An int8 bundle (serving.txt's quant row; ops/quant.py) holds the
// encoder's attention and MLP linears as int8: `linear` dispatches on the
// weights, as models/common.py's does. A w_q weight is dequantised per call
// into the float product; a w_q8 weight runs ops/quant.py int8_linear: P2
// quantize_rows_int8, the s8 x s8 product (at::_int_mm) and P3
// int8_epilogue, each kernel on a CUDA tensor and its plain version on a
// CPU tensor. With deform8 BiRefNet's deformable convs gather from an int8
// corner stack (ops/deform.py _corner_stack(int8=True)).
//
// Weights are looked up by their state_dict name (the bundle's spec); a
// BiRefNet program's without its kind's prefix, and its index tables
// (Swin's relative-position index and shift masks, the align-corners
// matrices) are weights too.
#pragma once

#include <ATen/ATen.h>

#include <atomic>
#include <functional>
#include <map>
#include <memory>
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
  // x, d, scale, bias, s_out, out, rows, cols, dtype, eps, stream
  using AddLayerNorm = int (*)(const void*, const void*, const void*,
                               const void*, void*, void*, int, int, int,
                               float, void*);
  // qkv, bias, out, g, n, nh, kd, dtype, scale, stream
  using LevitAttention = int (*)(const void*, const void*, void*, int, int,
                                 int, int, int, float, void*);
  // q, k, v, bhw, out, g, n, hd, gh, gw, dtype, scale, stream
  using RelposGlobal = int (*)(const void*, const void*, const void*,
                               const void*, void*, int, int, int, int, int,
                               int, float, void*);
  // q, k, v, bhw, out, g, n, hd, gh, gw, folded, g_skip, n_valid, dtype,
  // scale, stream
  using RelposWindowed = int (*)(const void*, const void*, const void*,
                                 const void*, void*, int, int, int, int, int,
                                 int, int, int, int, float, void*);
  // boxes, scores, thresh, keep, scratch, scratch words, m, stream
  using GreedyNms = int (*)(const void*, const void*, const void*, void*,
                            void*, long long, int, void*);
  // x, q, scale, rows, cols, dtype, stream
  using QuantizeRows = int (*)(const void*, void*, void*, int, int, int,
                               void*);
  // acc, x_scale, w_scale, b, y, rows, cols, dtype, stream
  using Int8Epilogue = int (*)(const void*, const void*, const void*,
                               const void*, void*, int, int, int, void*);
  LayerNorm layer_norm = nullptr;                    // K1
  AddLayerNorm add_layer_norm = nullptr;             // K3
  LevitAttention levit_attention = nullptr;          // K2
  RelposGlobal relpos_attention_global = nullptr;    // K4
  RelposWindowed relpos_attention_windowed = nullptr;  // K5
  GreedyNms greedy_nms = nullptr;                    // P1
  QuantizeRows quantize_rows_int8 = nullptr;         // P2
  Int8Epilogue int8_epilogue = nullptr;              // P3
};

// Launch counters of K1, K2, K3, K4, K5, P1, P2 and P3 (each launch on a
// CUDA tensor adds one).
extern std::atomic<int64_t> g_layer_norm_launches;
extern std::atomic<int64_t> g_levit_attention_launches;
extern std::atomic<int64_t> g_add_layer_norm_launches;
extern std::atomic<int64_t> g_relpos_global_launches;
extern std::atomic<int64_t> g_relpos_windowed_launches;
extern std::atomic<int64_t> g_greedy_nms_launches;
extern std::atomic<int64_t> g_quantize_rows_launches;
extern std::atomic<int64_t> g_int8_epilogue_launches;
// The int8 linears the dispatch of `linear` took, on any device: s8 x s8
// products (a w_q8 weight) and per-call dequantised weights (w_q).
extern std::atomic<int64_t> g_int8_products;
extern std::atomic<int64_t> g_dequantised_products;

// A BiRefNet's configuration (serving.txt's birefnet_* rows:
// models/birefnet.py BiRefNetConfig, models/swin.py SwinConfig).
struct BirefConfig {
  int resolution = 1024;  // the model's input side S (img_size)
  std::vector<int> depths;     // Swin blocks per stage
  std::vector<int> num_heads;  // per Swin stage
  int window = 7;
  int patch_size = 4;
  double layer_norm_eps = 1e-5;
  std::vector<int> aspp_kernel_sizes;
  bool mul_scl_ipt = true;  // 'cat': the half-resolution pass
  int cxt_num = 3;
  // The deformable convs gather from an int8 corner stack
  // (deform_int8_gather; serving.txt's quant row, deform8).
  bool deform8 = false;
};

struct ProgramConfig {
  int image_size = 1024;   // SamConfig.image_size
  int bucket = 1024;       // the canvas bucket of the program
  at::ScalarType compute_dtype = at::kBFloat16;  // the encoder's dtype
  int decoder_heads = 8;   // MaskDecoderConfig.num_heads
  bool multimask = false;  // decode3: tokens 1..3 and their IoUs
  // The encoder (serving.txt): a ViT, else TinyViT, and its kernel route.
  bool vit = false;
  bool kernel_route = false;
  // A ViT's geometry (SamViTConfig).
  int num_heads = 0;
  int window_size = 14;
  std::vector<int> global_attn_indexes;
  int patch_size = 16;
  double layer_norm_eps = 1e-6;
  const Kernels* kernels = nullptr;  // required on CUDA tensors
  at::Tensor pixel_mean;   // SAM's pixel statistics on the device, made
  at::Tensor pixel_std;    // once, outside any capture
  // decode_batch on the card: n streams (cudaStream_t) of the calling
  // thread, to fork each prompt's work onto.
  std::function<std::vector<void*>(int64_t n)> fork_streams;
  // amg: the point grid's side, the winners K and the pre-NMS pool, and
  // P1's scratch on the card (made by the eager warm-up, at its first
  // launch; a capture reuses it).
  int amg_grid = 0;
  int amg_masks = 0;
  int amg_prenms = 0;
  std::shared_ptr<at::Tensor> nms_scratch = std::make_shared<at::Tensor>();
  // birefnet: its configuration and ImageNet's statistics on the device.
  BirefConfig biref;
  at::Tensor imagenet_mean;
  at::Tensor imagenet_std;
};

// (canvas u8 (S, S, 3), sizes i32 (4,)) -> {embedding f32 (1, E, E, C)}
std::vector<at::Tensor> embed_program(const Weights& w, const ProgramConfig& c,
                                      const std::vector<at::Tensor>& in);
// (embedding, points f32 (1, 2, 2), labels f32 (1, 2), sizes i32 (4,))
//   -> {packed masks u8 (T * bucket * bucket / 8,), IoUs f32 (T,)}
std::vector<at::Tensor> decode_program(const Weights& w,
                                       const ProgramConfig& c,
                                       const std::vector<at::Tensor>& in);
// (embedding, points f32 (N, 2, 2), labels f32 (N, 2), sizes i32 (4,))
//   -> {packed masks u8 (N * bucket * bucket / 8,), IoUs f32 (N,)}
std::vector<at::Tensor> decode_batch_program(
    const Weights& w, const ProgramConfig& c,
    const std::vector<at::Tensor>& in);

// (embedding, sizes i32 (4,), thresholds f32 (6,)) -> {packed masks u8
//   (K * bucket * bucket / 8,), scores f32 (K,), stabilities f32 (K,),
//   areas f32 (K,)}, best first
std::vector<at::Tensor> amg_program(const Weights& w, const ProgramConfig& c,
                                    const std::vector<at::Tensor>& in);
// (canvas u8 (bucket, bucket, 3), sizes i32 (2,) = (h, w)) -> {mask u8
//   (S, S)}
std::vector<at::Tensor> birefnet_program(const Weights& w,
                                         const ProgramConfig& c,
                                         const std::vector<at::Tensor>& in);

}  // namespace dlimg_torch
