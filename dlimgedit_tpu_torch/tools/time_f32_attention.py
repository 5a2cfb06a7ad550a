"""Float32 attention kernels (K2, K4, K5, K6, K7) of this checkout and of another, on one GPU.

    python3 -m dlimgedit_tpu_torch.tools.time_f32_attention [--parent DIR]
        [--variants NAME,...] [--kernels K4,K5,K6,K7,K2] [--samples N]

Builds the attention sources of csrc/ (relpos_attention*.cu,
window_strip_attention.cu, levit_attention*.cu, attention_general*.cu and
the headers) once per variant, one nvcc each, all started together, into a
library with the C entry points dlimg_relpos_attention_global (K4),
dlimg_relpos_attention_windowed (K5), dlimg_window_strip_attention (K6),
dlimg_relpos_attention_qkv (K7) and dlimg_levit_attention (K2):

  design       the sources as they are (float32 K4, K5, K6 and K7 in three
               TF32 passes, relpos_attention_f32tc.cu; K2 likewise,
               levit_attention_f32tc.cu);
  p_shuffle    relpos_attention_f32tc.cu with p moved into the mma A
               fragment's standard key order by 8 quad shuffles a k-step
               (and V read in that order, its split rows 2 HD + 8 floats
               apart) instead of taking the score registers as they are;
  k4_2blk      K4 as two blocks of 4 warps an SM (their phases drift
               apart) in 16-key chunks, so that both fit shared memory;
  k6_no_bias   K6 without its bias prologue (the staged halves left as
               they are): what the prologue costs;
  k2_no_bias   K2 with a zero bias instead of the table's (no bias loads):
               what reading the bias from L2 costs;
  parent       with --parent DIR, DIR/dlimgedit_tpu_torch/csrc/ (another
               checkout, e.g. an unpacked parent commit) as it is.

The ablations (`UNCHECKED`) compute something else: their values are
not held, only timed. At each float32 shape of these kernels on
chip_smoke.py's main paths
(K4_SHAPES, K5_SHAPES, K6_SHAPES, K2_SHAPES, with their launches in phase
4's float32 `process` calls; K7_SHAPES, chip_smoke.py's VIT_QKV_SHAPES,
which no path launches), every variant is held against the plain
version (ops.flash_attention.attention_relpos_plain,
windowed_attention_fused_plain, windowed_attention_qkv_plain,
levit_window_attention_plain; TF32 off,
atol 2e-5, skipped pad-query rows zero) and timed: CUDA events around 10
launches behind a spin kernel, the median of N samples, the variants in
turn and then in reverse order (each variant's time the mean of its two).
Beside them: F.scaled_dot_product_attention in float32 with the
materialised float bias (the library yardstick of chip_smoke.py; for K6 on
windows partitioned beforehand) and the
float32 bound (chip_smoke.py's rule: products at a third of the 495
TFLOP/s TF32 peak, the softmax's other operations at 67 TFLOP/s, bytes at
3.35 TB/s). Prints per shape the times in ms, then the launch-weighted sums
of the kernels that a path launches.
With --mma-rate it first times the one product instruction of the design
alone (mma.sync m16n8k8 TF32, independent accumulators back to back, 8 to
32 warps an SM; one chain for its latency). Needs CUDA and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

from ..ops import cuda_build
from ..ops.flash_attention import (
    _bias_halves,
    attention_relpos_plain,
    levit_window_attention_plain,
    windowed_attention_fused_plain,
    windowed_attention_qkv_plain,
)
from .sweep_layer_norm import time_us

F32_SOURCE = "relpos_attention_f32tc.cuh"  # the float32 bodies
# K4: (heads, grid, head width, launches); K5: (windows, heads, window,
# head width, n_w, valid_rows, launches): chip_smoke.py's VIT_GLOBAL_SHAPES
# and VIT_WINDOW_SHAPES with their launches over phase 4's two float32
# `process` calls a variant (ViT-B twice: windows partitioned and fused).
K4_SHAPES = ((12, 64, 64, 16), (16, 64, 64, 8), (16, 64, 80, 8))
K5_SHAPES = ((25, 12, 14, 64, 5, 8, 16), (25, 16, 14, 64, 5, 8, 40),
             (25, 16, 14, 80, 5, 8, 56))
# K6: (batch, padded grid, heads, head width, window, launches): the strips
# of the fused-window ViT-B's (1, 70, 70, 2304) qkv (8 a `process`); ViT-H's
# shape, which no path launches. K2: (windows, N, heads, launches):
# MobileSAM's three stages (chip_smoke.py ATTN_SHAPES).
K6_SHAPES = ((1, 70, 12, 64, 14, 16), (1, 70, 16, 80, 14, 0))
K2_SHAPES = ((361, 49, 4, 4), (25, 196, 5, 12), (100, 49, 10, 4))
# K7: (windows, heads, window, head width, launches): ViT-B's and ViT-H's
# windows as one (W, 3, nh, N, hd) qkv; no path launches K7.
K7_SHAPES = ((25, 12, 14, 64, 0), (25, 16, 14, 80, 0))
KERNELS = ("K4", "K5", "K6", "K7", "K2")
ATOL = 2e-5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
PEAK_F32_FLOPS = 67e12         # float32 outside the tensor cores
PEAK_F32_TC_FLOPS = 495e12 / 3  # three TF32 passes

# p_shuffle's p fragment in the standard key order: slot gq of step j is
# key 8j + gq, slot gq + 4 key 8j + gq + 4, from the lanes that hold them.
P_SHUFFLE = (
    "const int sa = (lane & ~3) | (gq >> 1), sb = sa + 2;",
    "const bool odd = gq & 1;",
    "const float x0 = __shfl_sync(kFullMask, s[j][0], sa);",
    "const float x1 = __shfl_sync(kFullMask, s[j][1], sa);",
    "const float y0 = __shfl_sync(kFullMask, s[j][2], sa);",
    "const float y1 = __shfl_sync(kFullMask, s[j][3], sa);",
    "const float z0 = __shfl_sync(kFullMask, s[j][0], sb);",
    "const float z1 = __shfl_sync(kFullMask, s[j][1], sb);",
    "const float w0 = __shfl_sync(kFullMask, s[j][2], sb);",
    "const float w1 = __shfl_sync(kFullMask, s[j][3], sb);",
    "split(odd ? x1 : x0, ph[0], pl[0]);",
    "split(odd ? y1 : y0, ph[1], pl[1]);",
    "split(odd ? z1 : z0, ph[2], pl[2]);",
    "split(odd ? w1 : w0, ph[3], pl[3]);",
)
# Variant -> [(text in relpos_attention_f32tc.cuh, its replacement)] or
# [(source, text, replacement)]; the tool stops if a text is not in its
# source exactly once.
VARIANTS = {
    "design": [],
    "p_shuffle": [
        ("  static constexpr int SV = 2 * HD + 4;  // and V\n",
         "  static constexpr int SV = 2 * HD + 8;  // and V\n"),
        *[("\n" + pad + "const float* v0 = sv + (8 * j + 2 * gq) * SV + 2 * gr;\n",
           "\n" + "".join(pad + line + "\n" for line in P_SHUFFLE)
           + pad + "const float* v0 = sv + (8 * j + gq) * SV + 2 * gr;\n")
          for pad in (" " * 8, " " * 10)],
        ("v0 + SV + 16 * dt);", "v0 + 4 * SV + 16 * dt);"),
        ("v0 + SV + 16 * (d0 + dd));", "v0 + 4 * SV + 16 * (d0 + dd));"),
    ],
    "k4_2blk": [
        ("""__global__ void __launch_bounds__(32 * WARPS, 1)
    relpos_global_kernel_f32tc""", """__global__ void __launch_bounds__(32 * WARPS, 2)
    relpos_global_kernel_f32tc"""),
        ("launch_f32tc<HD, 4, 8>(&relpos_global_kernel_f32tc<HD, 4, 8, OG, true, PAD>",
         "launch_f32tc<HD, 2, 4>(&relpos_global_kernel_f32tc<HD, 2, 4, OG, true, PAD>"),
        ("launch_f32tc<HD, 4, 8>(&relpos_global_kernel_f32tc<HD, 4, 8, OG, false, PAD>",
         "launch_f32tc<HD, 2, 4>(&relpos_global_kernel_f32tc<HD, 2, 4, OG, false, PAD>"),
    ],
    "k6_no_bias": [
        ("    g.compute_bias(bs, bstr, q0, rows, tid, THREADS);\n", ""),
    ],
    "k2_no_bias": [
        ("levit_attention_f32tc.cu",
         "    const float2 w0 = bias_pair(b0, 8 * j + 2 * gq, n, pairs);\n"
         "    const float2 w1 = bias_pair(b1, 8 * j + 2 * gq, n, pairs);\n",
         "    const float2 w0 = make_float2(0.f, 0.f), w1 = w0;\n"),
    ],
}
# Variants whose values differ from the plain version's by design.
UNCHECKED = ("k6_no_bias", "k2_no_bias")
ENTRIES = ("dlimg_relpos_attention_global", "dlimg_relpos_attention_windowed",
           "dlimg_window_strip_attention", "dlimg_relpos_attention_qkv",
           "dlimg_levit_attention")
SOURCES = ("relpos_attention*.cu", "window_strip_attention.cu",
           "levit_attention*.cu", "attention_general*.cu")

# --mma-rate: the rate of the one product instruction the design runs
# (mma.sync m16n8k8, TF32 in, float32 accumulate: 2048 operations), each
# warp running CHAINS independent accumulators back to back.
MMA_RATE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int CHAINS>
__global__ void mma_tf32_rate(float* out, int iters) {
  const uint32_t a0 = __float_as_uint(1.f + threadIdx.x * 1e-3f);
  const uint32_t b0 = __float_as_uint(1e-6f), b1 = __float_as_uint(2e-6f);
  float c[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int t = 0; t < CHAINS; ++t)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
          "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(c[t][0]), "+f"(c[t][1]), "+f"(c[t][2]), "+f"(c[t][3])
          : "r"(a0), "r"(a0 + 8192), "r"(a0 + 16384), "r"(a0 + 24576), "r"(b0), "r"(b1));
  }
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < CHAINS; ++t) s += c[t][0] + c[t][1] + c[t][2] + c[t][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_tf32_rate_launch(float* out, int chains, int blocks, int threads,
                                    int iters, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chains == 1) mma_tf32_rate<1><<<blocks, threads, 0, st>>>(out, iters);
  else mma_tf32_rate<8><<<blocks, threads, 0, st>>>(out, iters);
  return cudaGetLastError();
}
"""
# (chains, warps an SM, each block 8 warps)
MMA_RATE_CASES = ((8, 8), (8, 16), (8, 32), (1, 8))


def build(work: Path, names, parent) -> dict:
    """One library per variant, all compiled at once; name -> ctypes CDLL."""
    procs = {}
    nvcc = cuda_build._nvcc()
    for name in names:
        src = work / name
        origin = (parent / "dlimgedit_tpu_torch" / "csrc" if name == "parent"
                  else cuda_build.CSRC_DIR)
        shutil.copytree(origin, src, ignore=shutil.ignore_patterns("*.cpp"))
        if name != "parent":
            for edit in VARIANTS[name]:
                source, old, new = edit if len(edit) == 3 else (F32_SOURCE, *edit)
                text = (src / source).read_text()
                if text.count(old) != 1:
                    raise SystemExit(f"time_f32_attention: {old.strip()!r} is "
                                     f"not in {source} once")
                (src / source).write_text(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_build.COMPILE_FLAGS, "-shared", "-o",
             str(work / f"{name}.so"),
             *map(str, sorted(f for pat in SOURCES for f in src.glob(pat)))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"time_f32_attention: nvcc failed for {name}:\n{out}")
        print(f"{name}: built; {'; '.join(ptxas_report(out))}", flush=True)
        lib = ctypes.CDLL(str(work / f"{name}.so"))
        for entry in ENTRIES:
            getattr(lib, entry).argtypes = cuda_build._SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def ptxas_report(log: str) -> list:
    """'kernel<template arguments>: registers, spill bytes' for each
    instance of a float32 attention kernel in an nvcc -Xptxas -v log."""
    rows, kernel, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?((?:relpos_(?:global|window|qkv)|"
                      r"window_strip|levit_window|levit_attention|"
                      r"window_strip_attention)_kernel\w*?)I(\w*?)EEv", line)
        if m:
            kernel, spill = m.group(1) + "<" + ",".join(
                re.findall(r"L[ib](\d+)E", m.group(2))) + ">", 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and kernel:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            if not re.match(r"\w+_kernel_tc<", kernel):
                rows.append(f"{kernel}: {m.group(1)} registers, {spill} bytes "
                            f"spilled")
            kernel = None
    return rows


def mma_rate(work: Path, gpu: str) -> None:
    """Prints the TF32 mma.sync rate of MMA_RATE_CASES on this card."""
    src = work / "mma_rate.cu"
    src.write_text(MMA_RATE_SOURCE)
    lib_path = work / "mma_rate.so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.COMPILE_FLAGS, "-shared",
                    "-o", str(lib_path), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_tf32_rate_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.mma_tf32_rate_launch.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    for chains, warps in MMA_RATE_CASES:
        blocks = sms * warps // 8
        out = torch.empty(blocks * 256, device="cuda")

        def call():
            rc = lib.mma_tf32_rate_launch(out.data_ptr(), chains, blocks, 256,
                                          iters, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"time_f32_attention: the mma probe failed: {rc}")
        us = time_us(call, 5, per_sample=2)
        mmas = blocks * 8 * iters * chains
        print(f"mma.sync m16n8k8 tf32 on {gpu}: {chains} chain(s) a warp, "
              f"{warps} warps an SM: {mmas * 2048 / us / 1e6:.1f} TFLOP/s "
              f"({mmas / (sms * 4) / (us * 1e3):.4f} mma a ns a sub-partition; "
              f"three passes: {mmas * 2048 / us / 3e6:.1f} TFLOP/s of float32 "
              f"products)", flush=True)


def relpos_mask(bhw, grid, folded, scale):
    """The materialised float bias of K4 / K5 for the SDPA yardstick."""
    tok = torch.arange(grid * grid, device=bhw.device)
    bias = bhw[:, :, :grid][:, :, tok // grid] + bhw[:, :, grid:][:, :, tok % grid]
    return bias * scale if folded else bias


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def cases(dev, gen, kernels):
    """(label, kernel, launches, the launch's arguments before the dtype
    code and the scale, scale, plain output, SDPA call, bytes, products,
    other operations, the tensors the pointers point into) at each shape
    of `kernels`. The arguments' output pointer is None, for the caller's
    output tensor."""
    if "K4" in kernels:
        for nh, g, hd, launches in K4_SHAPES:
            N = g * g
            q, k, v = (torch.randn((nh, N, hd), generator=gen, device=dev)
                       for _ in range(3))
            rh, rw = (0.3 * torch.randn((g, g, hd), generator=gen, device=dev)
                      for _ in range(2))
            bhw = _bias_halves(q, rh, rw, g, g)
            mask = relpos_mask(bhw, g, False, 1.0)
            want = attention_relpos_plain(q, k, v, bhw, g, g)
            args = (*_ptrs(q, k, v, bhw), None, nh, N, hd, g, g)
            yield (f"K4 ({nh},{N},{hd})", "global", launches, args, hd ** -0.5,
                   want, lambda q=q, k=k, v=v, mask=mask:
                   F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                  attn_mask=mask[None]),
                   (4 * nh * N * hd + nh * N * 2 * g) * 4, 4 * nh * N * N * hd,
                   7 * nh * N * N, (q, k, v, bhw))
            del mask
    if "K5" in kernels:
        for W, nh, ws, hd, n_w, valid_rows, launches in K5_SHAPES:
            N, G = ws * ws, W * nh
            scale = hd ** -0.5
            q, k, v = (torch.randn((G, N, hd), generator=gen, device=dev)
                       for _ in range(3))
            rh, rw = (0.3 * torch.randn((ws, ws, hd), generator=gen, device=dev)
                      for _ in range(2))
            bhw = _bias_halves(q, rh, rw, ws, ws, out_scale=1.0 / scale)
            mask = relpos_mask(bhw, ws, True, scale)
            want = attention_relpos_plain(q, k, v, bhw, ws, ws, folded=True,
                                          heads=nh, n_w=n_w,
                                          valid_rows=valid_rows)
            rows = (W - n_w) * nh * N + n_w * nh * valid_rows * ws
            args = (*_ptrs(q, k, v, bhw), None, G, N, hd, ws, ws, 1,
                    (W - n_w) * nh, valid_rows * ws)
            yield (f"K5 ({G},{N},{hd}) n_w={n_w} valid_rows={valid_rows}",
                   "windowed", launches, args, scale, want,
                   lambda q=q, k=k, v=v, mask=mask: F.scaled_dot_product_attention(
                       q[None], k[None], v[None], attn_mask=mask[None]),
                   (2 * G * N * hd + rows * (hd + 2 * ws) + G * N * hd) * 4,
                   4 * rows * N * hd, 7 * rows * N, (q, k, v, bhw))
            del mask
    if "K6" in kernels:
        for B, grid, nh, hd, ws, launches in K6_SHAPES:
            C, n, nw = nh * hd, ws * ws, grid // ws
            G = B * nw * nw * nh
            qkv = torch.randn((B, grid, grid, 3 * C), generator=gen, device=dev)
            q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
            rh, rw = (0.3 * torch.randn((ws, ws, hd), generator=gen, device=dev)
                      for _ in range(2))
            want = windowed_attention_fused_plain(q, k, v, rh, rw, ws=ws,
                                                  num_heads=nh)
            qw, kw, vw = (qkv.view(B, nw, ws, nw, ws, 3, nh, hd)
                          .permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, G, n, hd))
            mask = relpos_mask(_bias_halves(qw, rh, rw, ws, ws), ws, False, 1.0)
            args = (*_ptrs(q, k, v, rh, rw), None, B, grid, grid, C, 3 * C, ws,
                    nh, hd)
            yield (f"K6 ({B},{grid},{grid},{C})", "strip", launches, args,
                   hd ** -0.5, want,
                   lambda qw=qw, kw=kw, vw=vw, mask=mask:
                   F.scaled_dot_product_attention(qw[None], kw[None], vw[None],
                                                  attn_mask=mask[None]),
                   (4 * B * grid * grid * C + 2 * ws * ws * hd) * 4,
                   4 * G * n * n * hd + 4 * G * n * ws * hd, 7 * G * n * n,
                   (qkv, rh, rw))
            del mask
    if "K7" in kernels:
        for W, nh, ws, hd, launches in K7_SHAPES:
            N, G = ws * ws, W * nh
            qkv = torch.randn((W, 3, nh, N, hd), generator=gen, device=dev)
            rh, rw = (0.3 * torch.randn((ws, ws, hd), generator=gen, device=dev)
                      for _ in range(2))
            bhw = _bias_halves(qkv[:, 0].reshape(G, N, hd), rh, rw, ws, ws)
            mask = relpos_mask(bhw, ws, False, 1.0).view(W, nh, N, N)
            want = windowed_attention_qkv_plain(qkv, bhw, ws, ws)
            args = (*_ptrs(qkv, bhw), None, W, nh, N, hd, ws, ws)
            yield (f"K7 ({W},3,{nh},{N},{hd})", "qkv", launches, args,
                   hd ** -0.5, want,
                   lambda qkv=qkv, mask=mask: F.scaled_dot_product_attention(
                       qkv[:, 0], qkv[:, 1], qkv[:, 2], attn_mask=mask),
                   (4 * G * N * hd + G * N * 2 * ws) * 4, 4 * G * N * N * hd,
                   7 * G * N * N, (qkv, bhw))
            del mask
    if "K2" in kernels:
        for G, N, nh, launches in K2_SHAPES:
            kd = 32
            qkv = torch.randn((G, N, nh * 3 * kd), generator=gen, device=dev)
            bias = 0.5 * torch.randn((nh, N, N), generator=gen, device=dev)
            want = levit_window_attention_plain(qkv, bias, nh)
            q5 = qkv.view(G, N, nh, 3, kd)
            q, k, v = (q5[:, :, :, i].transpose(1, 2) for i in range(3))
            mask = bias[None].expand(G, nh, N, N)
            args = (*_ptrs(qkv, bias), None, G, N, nh, kd)
            yield (f"K2 ({G},{N},{nh * 3 * kd}) nh={nh}", "levit", launches,
                   args, kd ** -0.5, want,
                   lambda q=q, k=k, v=v, mask=mask:
                   F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                   (G * N * nh * 4 * kd + nh * N * N) * 4,
                   4 * G * nh * N * N * kd, 7 * G * nh * N * N, (qkv, bias))


ENTRY = {"global": "dlimg_relpos_attention_global",
         "windowed": "dlimg_relpos_attention_windowed",
         "strip": "dlimg_window_strip_attention",
         "qkv": "dlimg_relpos_attention_qkv",
         "levit": "dlimg_levit_attention"}
KIND_LABEL = {"global": "K4", "windowed": "K5", "strip": "K6", "qkv": "K7",
              "levit": "K2"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout's root, built as variant 'parent'")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all)")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated kernels to time (default: all)")
    ap.add_argument("--samples", type=int, default=10)
    ap.add_argument("--mma-rate", action="store_true",
                    help="also time the TF32 mma.sync instruction alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_f32_attention: needs a CUDA device", file=sys.stderr)
        return 2
    names = [n for n in args.variants.split(",") if n]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"time_f32_attention: unknown variants {sorted(unknown)}")
    kernels = [k for k in args.kernels.split(",") if k]
    if set(kernels) - set(KERNELS):
        raise SystemExit(f"time_f32_attention: unknown kernels "
                         f"{sorted(set(kernels) - set(KERNELS))}")
    if args.parent is not None:
        names.insert(0, "parent")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's products
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="time-f32-", dir=cuda_build.BUILD_DIR))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    try:
        libs = build(work, names, args.parent)
        if args.mma_rate:
            mma_rate(work, gpu)
        print(f"{gpu}; float32; ms a launch (median of {args.samples} x 10, "
              f"each variant the mean of two turns)", flush=True)
        sums = {}
        for (label, kind, launches, a, scale, want, sdpa, nbytes, mm, other,
             keep) in cases(dev, gen, kernels):
            out = torch.empty_like(want)
            stream = torch.cuda.current_stream().cuda_stream
            cargs = [out.data_ptr() if x is None else x for x in a]
            calls = {}
            for name, lib in libs.items():
                entry = getattr(lib, ENTRY[kind])

                def call(entry=entry, name=name):
                    rc = entry(*cargs, 0, scale, stream)
                    if rc:
                        raise SystemExit(f"time_f32_attention: {name} {label} "
                                         f"failed to launch: {rc}")
                out.fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                err = (out - want).abs().max().item()
                if name not in UNCHECKED and not err <= ATOL:
                    raise SystemExit(f"time_f32_attention: {name} {label}: "
                                     f"max|diff| {err} > {ATOL}")
                calls[name] = (call, err)
            times = dict.fromkeys(calls, 0.0)
            for name in [*calls, *reversed(calls)]:
                times[name] += time_us(calls[name][0], args.samples) / 2e3
            lib_ms = time_us(sdpa, args.samples) / 1e3
            bound = max(nbytes / HBM_BYTES_PER_S,
                        mm / PEAK_F32_TC_FLOPS + other / PEAK_F32_FLOPS) * 1e3
            total = sums.setdefault(
                kind, dict.fromkeys([*names, "sdpa", "bound", "launches"], 0.0))
            for name, t in [*times.items(), ("sdpa", lib_ms), ("bound", bound)]:
                total[name] += t * launches
            total["launches"] += launches
            print(f"{label} x{launches}: " + "; ".join(
                f"{n} {t:.5f} (max|diff| {calls[n][1]:.2e})"
                for n, t in times.items())
                + f"; SDPA {lib_ms:.5f}; bound {bound:.5f}", flush=True)
            del a, want, out, calls, keep
            torch.cuda.empty_cache()
        for kind, total in sums.items():
            n = int(total.pop("launches"))
            if not n:  # on no path (K7)
                continue
            print(f"{KIND_LABEL[kind]} float32 over {n} launches "
                  f"(ms): " + ", ".join(f"{k} {t:.5f}" for k, t in total.items()),
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
