// K6: windowed attention with the MViTv2 decomposed relative-position bias
// of the SAM ViT encoders, read in place from the padded NHWC q, k and v
// (the three channel slices of the qkv linear's output), bias halves
// computed in the kernel, exact softmax. This file holds the C entry
// point, which picks the body by geometry and dtype. The tuned instances
// take windows of up to 208 tokens (SAM's 14 x 14) at head widths that are
// multiples of 8 up to 128: bf16 (the ViT's dtype) runs on the tensor
// cores in relpos_attention_tc.cu (`window_strip_kernel_tc`, mma.sync
// bf16), float16 on the same body in relpos_attention_tc_f16.cu, float32
// in relpos_attention_f32tc.cu (`window_strip_kernel_f32tc`, mma.sync TF32
// in three passes). Any other window and head width runs the general body
// (attention_general.cuh, `attention_tuned`), which computes the bias
// halves in a prologue too.
//
// Replaces the TPU kernel dlimgedit_tpu/ops/flash_attention.py:646
// `windowed_attention_fused` (Pallas body `_window_strip_kernel`, :575): the
// ViT's windowed blocks on the `fused_window_blocks` path. For a window
// (wy, wx) of ws x ws tokens, a head h of width HD, token i at window
// position (y_i, x_i) = divmod(i, ws) and the gathered tables rh, rw
// (ws, ws, HD) in the activation dtype:
//   bh[i, y] = sum_d q_i[d] rh[y_i, y, d]    rounded to the dtype
//   bw[i, x] = sum_d q_i[d] rw[x_i, x, d]    rounded to the dtype
//   s[i, j]  = ((q_i . k_j) * scale + bh[i, y_j]) + bw[i, x_j]   (float32)
//   p = softmax_j(s) in float32, rounded to the dtype
//   out[i] = p . v in float32, rounded to the dtype
// for every token of the padded grid (pad rows and columns included; the
// caller crops). The bias is added by index; the TPU kernel's one-hot
// selector matmuls were a Mosaic workaround and are not ported.
//
// What bounds it on an H100. ViT-B at 1024 (q, k, v slices of a (1, 70,
// 70, 2304) qkv, 25 windows x 12 heads of 196 tokens) reads q, k, v once
// and writes the output (bf16: ~22.6 MB read and 7.5 MB written, ~9 us at
// 3.35 TB/s) against ~3.0 GFLOP of q.k and p.v products: operations in
// float32 (three TF32 passes, ~18 us at a third of the TF32 peak), near
// the ridge in bf16.
#include "attention_general.cuh"
#include "relpos_attention.cuh"

// q, k, v: (b, hp, wp, *) of one dtype with token stride ts (>= c, unit
// channel stride, rows dense: the channel slices of a (b, hp, wp, 3c) qkv
// have ts = 3c); rh, rw: (ws, ws, hd) contiguous; out: (b, hp, wp, c)
// contiguous; c == nh * hd, hp and wp multiples of ws; any ws >= 1 and hd
// >= 1. The tuned instances want q, k, v, rh, rw and out on 16 bytes and ts
// a multiple of 16 bytes (the wrapper sees to it); the general body any
// element alignment.
extern "C" int dlimg_window_strip_attention(const void* q, const void* k, const void* v,
                                            const void* rh, const void* rw, void* out,
                                            int b, int hp, int wp, int c, int ts, int ws,
                                            int nh, int hd, int dtype, float scale,
                                            void* stream) {
  if (b <= 0 || hp <= 0 || wp <= 0) return 0;
  if (ws <= 0 || hp % ws || wp % ws || nh <= 0 || hd <= 0 ||
      static_cast<long long>(nh) * hd != c || ts < c ||
      static_cast<long long>(ws) * ws > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dlimg::attention_tuned(dlimg::kAttnStrip, dtype, hd, ws * ws, ws, ws, nh)) {
    dlimg::GeneralArgs a{};
    a.q = q;
    a.k = k;
    a.v = v;
    a.bias = rh;
    a.bias2 = rw;
    a.out = out;
    a.groups = static_cast<long long>(b) * (hp / ws) * (wp / ws) * nh;
    a.n = ws * ws;
    a.hd = hd;
    a.gh = a.gw = ws;
    a.nh = nh;
    a.hp = hp;
    a.wp = wp;
    a.ts = ts;
    a.c = c;
    a.scale = scale;
    a.vec = dlimg::general_vec(dtype == dlimg::kDtypeF32 ? 4 : 2, hd, ts, q, k, v);
    return dlimg::attention_general(a, dlimg::kGenStrip, dtype, s);
  }
  const dlimg::StripArgs a{q, k, v, rh, rw, out, hp, wp, c, ts, ws, nh, scale};
  if (dtype == dlimg::kDtypeF32) return dlimg::window_strip_f32tc(a, b, hd, s);
  if (dtype == dlimg::kDtypeBF16) return dlimg::window_strip_tc(a, b, hd, s);
  if (dtype == dlimg::kDtypeF16) return dlimg::window_strip_tc_f16(a, b, hd, s);
  return cudaErrorInvalidValue;
}
