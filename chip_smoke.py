#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (dlimgedit_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU,
nvcc and PyTorch built for CUDA. It imports nothing of JAX or of the JAX
package. Phases, each of which fails the run (non-zero exit) on any error:

  1. builds the port's CUDA kernels from dlimgedit_tpu_torch/csrc/ (nvcc,
     sm_90a) and prints nvcc's register / shared-memory report;
  2. holds each kernel against its plain PyTorch version on the card, at
     every shape the main path gives it, in bfloat16 and float32, and times
     kernel, plain version, the library yardstick (F.layer_norm,
     F.scaled_dot_product_attention; timed only, never used by the port)
     and the least time the card could take (bound);
  3. checks the port on the card against the port on the CPU at a small
     size (float32, image size 64): embedding within 1e-4, masks equal;
  4. drives the main path at full width: MobileSAM at 1024 in bfloat16 with
     seeded random weights, `process` on a 1024x768 and a 1500x1000 image
     (canvas buckets 1024 and 2048), and per image `compute_mask(Point)`,
     `compute_mask(Region)` with largest_region_object, `compute_masks` and
     `compute_mask_batch` of 4 prompts. Launch counters are zeroed before
     and read after: 22 LayerNorm (K1) and 10 attention (K2) launches per
     `process`. Masks must be {0, 255} at the original extent. The embedding
     is held against the plain path (kernels off): in float32 within
     relative L2 1e-5; in bf16 its relative L2 distance to the float32
     result may be at most 1.1x the bf16 plain path's (the two bf16 paths
     round independently, which puts them ~1e-2 apart on random weights);
  5. times `process` and one mask query (medians, host clock around work
     that ends in a device synchronise).

The line before the last is one JSON object with per-kernel numbers; the
last line is {"ok": true, "device": {...}}. Times are medians of 20 runs
timed with CUDA events; a kernel's `ms`, `plain_ms`, `library_ms` and
`bound_ms` in the JSON are sums over the launches it made on the main path
(its `launches`: both images' `process` calls).
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
PEAK_F32_FLOPS = 67e12           # float32 outside the tensor cores
PEAK_BF16_TC_FLOPS = 989e12      # bf16 tensor cores, dense

# Main-path shapes of one `process` call at image size 1024:
# (rows, C, eps, launches per process) for K1 ...
LN_SHAPES = [
    (17689, 128, 1e-5, 2), (16384, 128, 1e-5, 2),   # stage 1 attn / mlp
    (4900, 160, 1e-5, 6), (4096, 160, 1e-5, 6),     # stage 2
    (4900, 320, 1e-5, 2), (4096, 320, 1e-5, 2),     # stage 3
    (4096, 256, 1e-6, 2),                           # neck
]
# ... and (G, N, num_heads, launches per process) for K2 (head width 32).
ATTN_SHAPES = [(361, 49, 4, 2), (25, 196, 5, 6), (100, 49, 10, 2)]
LN_PER_PROCESS = sum(s[3] for s in LN_SHAPES)        # 22
ATTN_PER_PROCESS = sum(s[3] for s in ATTN_SHAPES)    # 10
# The main path's images, (width, height, seed): canvas buckets 1024 and 2048.
IMAGES = ((1024, 768, 1), (1500, 1000, 2))

# The spin kernel run ahead of timed launches (about 20 ms at the H100's
# clocks; its device time is measured once, in `spin_ms`), and how many
# times a sample may be taken again when the host took longer than 3/4 of
# the spin to queue its calls (the host is shared and stalls at times).
SPIN_CYCLES = 40_000_000
SAMPLE_RETRIES = 10

TOL = {("ln", "float32"): 1e-5, ("attn", "float32"): 2e-5,
       ("ln", "bfloat16"): 2e-2, ("attn", "bfloat16"): 2e-2}


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


_SPIN_MS = []


def spin_ms(torch) -> float:
    """Device time of one `torch.cuda._sleep(SPIN_CYCLES)`, measured once."""
    if not _SPIN_MS:
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda._sleep(SPIN_CYCLES)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        _SPIN_MS.append(min(times))
    return _SPIN_MS[0]


def time_ms(torch, fn, samples: int = 20, per_sample: int = 10) -> float:
    """Device time of one call: median over `samples` of the mean of
    `per_sample` back-to-back calls between two CUDA events. A spin kernel
    runs first, so the host has queued every call before the first one
    starts and the events time the device, not the host's launch rate; a
    sample whose calls the host queued too slowly for that is taken again."""
    host_limit_ms = 0.75 * spin_ms(torch)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times, retries = [], 0
    while len(times) < samples:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(per_sample):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if host_ms > host_limit_ms:
            retries += 1
            if retries > SAMPLE_RETRIES:
                fail(f"host took {host_ms:.2f} ms to queue the timed calls, "
                     f"longer than the spin ahead of them "
                     f"({host_limit_ms:.2f} ms usable), {retries} times: the "
                     f"time would be the host's")
            continue
        times.append(start.elapsed_time(end) / per_sample)
    return statistics.median(times)


def check_kernels(torch, dl_ops):
    """Phase 2: each kernel against its plain version at the main-path
    shapes. Returns the JSON entries: bf16 times summed over the launches
    of the main path's run (every image's `process`)."""
    import torch.nn.functional as F

    fln = dl_ops["fused_layer_norm"]
    ln_plain = dl_ops["layer_norm_plain"]
    attn = dl_ops["levit_window_attention"]
    attn_plain = dl_ops["levit_window_attention_plain"]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    entries = {}

    def record(name, dtype, err, ms, plain_ms, lib_ms, bound_bytes_ms,
               bound_ops_ms, launches):
        if dtype != "bfloat16":
            return
        launches *= len(IMAGES)
        e = entries.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                          library_ms=0.0, bytes_ms=0.0,
                                          ops_ms=0.0))
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["ms"] += ms * launches
        e["plain_ms"] += plain_ms * launches
        e["library_ms"] += lib_ms * launches
        e["bytes_ms"] += bound_bytes_ms * launches
        e["ops_ms"] += bound_ops_ms * launches

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        es = torch.empty((), dtype=dtype).element_size()
        for rows, C, eps, per in LN_SHAPES:
            x = torch.randn((rows, C), generator=gen, device=dev).to(dtype)
            scale = (0.25 + 0.5 * torch.rand((C,), generator=gen, device=dev)).to(dtype)
            bias = (0.5 * torch.rand((C,), generator=gen, device=dev) - 0.25).to(dtype)
            out = fln(x, scale, bias, eps)
            ref = ln_plain(x, scale, bias, eps)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL[("ln", dname)]
            ms = time_ms(torch, lambda: fln(x, scale, bias, eps))
            plain_ms = time_ms(torch, lambda: ln_plain(x, scale, bias, eps))
            lib_ms = time_ms(torch, lambda: F.layer_norm(x, (C,), scale, bias, eps))
            nbytes = (2 * rows * C + 2 * C) * es
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = 7 * rows * C / PEAK_F32_FLOPS * 1e3
            print(f"K1 fused_layer_norm {dname} ({rows},{C}) x{per}: "
                  f"max|diff|={err:.3e} (atol {tol:g}) kernel_ms={ms:.5f} "
                  f"plain_ms={plain_ms:.5f} library_ms={lib_ms:.5f} "
                  f"bound_ms={max(bytes_ms, ops_ms):.5f}", flush=True)
            if not err <= tol:
                fail(f"fused_layer_norm {dname} ({rows},{C}): {err} > {tol}")
            record("fused_layer_norm", dname, err, ms, plain_ms, lib_ms,
                   bytes_ms, ops_ms, per)
        for G, N, nh, per in ATTN_SHAPES:
            kd = 32
            qkv = torch.randn((G, N, nh * 3 * kd), generator=gen, device=dev).to(dtype)
            bias = (0.5 * torch.randn((nh, N, N), generator=gen, device=dev)).to(dtype)
            out = attn(qkv, bias, nh)
            ref = attn_plain(qkv, bias, nh)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL[("attn", dname)]
            q5 = qkv.view(G, N, nh, 3, kd)
            q, k, v = (q5[:, :, :, i].transpose(1, 2) for i in range(3))
            mask = bias[None].expand(G, nh, N, N)
            ms = time_ms(torch, lambda: attn(qkv, bias, nh))
            plain_ms = time_ms(torch, lambda: attn_plain(qkv, bias, nh))
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask))
            nbytes = (G * N * nh * 4 * kd + nh * N * N) * es
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            mm_peak = PEAK_BF16_TC_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
            ops_ms = (4 * G * nh * N * N * kd / mm_peak
                      + 7 * G * nh * N * N / PEAK_F32_FLOPS) * 1e3
            print(f"K2 levit_window_attention {dname} ({G},{N},{nh * 3 * kd}) "
                  f"nh={nh} x{per}: max|diff|={err:.3e} (atol {tol:g}) "
                  f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
                  f"library_ms={lib_ms:.5f} "
                  f"bound_ms={max(bytes_ms, ops_ms):.5f}", flush=True)
            if not err <= tol:
                fail(f"levit_window_attention {dname} ({G},{N}): {err} > {tol}")
            record("levit_window_attention", dname, err, ms, plain_ms, lib_ms,
                   bytes_ms, ops_ms, per)
    return entries


def rgba(np, h: int, w: int, seed: int):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)


def check_small_against_cpu(torch, np, dl):
    """Phase 3: the port on the card against the port on the CPU (the plain
    path, which the CPU tests hold against the JAX package), float32."""
    opts = dict(allow_random_weights=True, compute_dtype="float32",
                sam_image_size=64, largest_region_object=True)
    envs = [dl.Environment(dl.Options(backend=b, **opts))
            for b in (dl.Backend.cpu, dl.Backend.gpu)]
    img = dl.Image(dl.Extent(96, 64), dl.Channels.rgba, rgba(np, 64, 96, 42))
    segs = [dl.Segmentation.process(img, e) for e in envs]
    e_cpu, e_gpu = (s.embedding.float().cpu() for s in segs)
    err = (e_cpu - e_gpu).abs().max().item()
    print(f"small f32 embedding, card vs CPU: max|diff|={err:.3e} (atol 1e-4)")
    if not err <= 1e-4:
        fail(f"card embedding differs from the CPU port: {err}")
    prompts = [dl.Point(30, 20), dl.Region(dl.Point(8, 8), dl.Point(80, 56))]
    for p in prompts:
        a, b = (s.compute_mask(p).pixels for s in segs)
        flips = int((a != b).sum())
        print(f"small f32 mask {p}: {flips} pixels differ")
        if flips:
            fail(f"card mask differs from the CPU port for {p}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "dlimgedit_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no dlimgedit_tpu_torch package beside "
              f"{Path(__file__).name}: run it from a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import numpy as np

    import dlimgedit_tpu_torch as dl
    from dlimgedit_tpu_torch.ops.cuda_build import LIBRARY
    from dlimgedit_tpu_torch.ops.flash_attention import (
        levit_window_attention,
        levit_window_attention_plain,
    )
    from dlimgedit_tpu_torch.ops.fused_norm import (
        fused_layer_norm,
        layer_norm_plain,
    )

    # Full-precision float32 references everywhere (the cuDNN default lets
    # float32 convolutions run in TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    gpu_line = smi.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}; "
          f"device count {torch.cuda.device_count()}", flush=True)

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    LIBRARY.get()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s -> {LIBRARY.path}")
    for line in LIBRARY.build_log.splitlines():
        if line.startswith("==") or "Used" in line or "spill" in line:
            print("  nvcc:", line.strip())
    sys.stdout.flush()

    # -- 2. kernels against their plain versions -------------------------
    entries = check_kernels(torch, dict(
        fused_layer_norm=fused_layer_norm, layer_norm_plain=layer_norm_plain,
        levit_window_attention=levit_window_attention,
        levit_window_attention_plain=levit_window_attention_plain))

    # -- 3. small size: the card against the CPU -------------------------
    check_small_against_cpu(torch, np, dl)

    # -- 4. main path at full width --------------------------------------
    t0 = time.perf_counter()
    env = dl.Environment(dl.Options(allow_random_weights=True,
                                    largest_region_object=True))
    bundle = env.sam_model()
    enc_cfg = bundle.cfg.encoder_tiny
    if env.device.type != "cuda" or not (enc_cfg.use_fused_norm
                                         and enc_cfg.use_flash_attention):
        fail(f"the default Environment is not on the card with both kernels "
             f"({env.device}, {enc_cfg})")
    print(f"model load (random weights, seed 0): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    images = [dl.Image(dl.Extent(w, h), dl.Channels.rgba, rgba(np, h, w, s))
              for (w, h, s) in IMAGES]

    def queries(seg):
        ext = seg.extent
        cx, cy = ext.width // 2, ext.height // 2
        region = dl.Region(dl.Point(ext.width // 8, ext.height // 8),
                           dl.Point(ext.width * 7 // 8, ext.height * 7 // 8))
        out = [seg.compute_mask(dl.Point(cx, cy)), seg.compute_mask(region)]
        out += [m.image for m in seg.compute_masks(dl.Point(cx // 2, cy))]
        out += [m.image for m in seg.compute_mask_batch(
            [dl.Point(cx, cy), region, dl.Point(ext.width // 4, ext.height // 4),
             dl.Point(ext.width * 3 // 4, ext.height * 3 // 4)])]
        return out

    fused_layer_norm.launches = 0
    levit_window_attention.launches = 0
    segs = []
    for img in images:
        seg = dl.Segmentation.process(img, env)
        masks = queries(seg)
        torch.cuda.synchronize()
        segs.append(seg)
        emb = seg.embedding
        if tuple(emb.shape) != (1, 64, 64, 256) or not bool(torch.isfinite(emb).all()):
            fail(f"bad embedding {tuple(emb.shape)}")
        for m in masks:
            px = m.pixels
            if px.shape != (img.extent.height, img.extent.width, 1):
                fail(f"mask shape {px.shape} != extent {img.extent}")
            if not set(np.unique(px).tolist()) <= {0, 255}:
                fail("mask is not binary {0, 255}")
        print(f"image {img.extent.width}x{img.extent.height}: embedding "
              f"{tuple(emb.shape)}, {len(masks)} masks, foreground shares "
              f"{[round(float((m.pixels > 0).mean()), 3) for m in masks]}",
              flush=True)
    launches = {"fused_layer_norm": fused_layer_norm.launches,
                "levit_window_attention": levit_window_attention.launches}
    print(f"main-path launches over {len(images)} process calls: {launches}")
    want = {"fused_layer_norm": LN_PER_PROCESS * len(images),
            "levit_window_attention": ATTN_PER_PROCESS * len(images)}
    if launches != want:
        fail(f"kernel launches {launches} != {want}")

    # The same model with the kernels switched off (the plain PyTorch path on
    # the card), and both paths in float32. In bf16 the kernel and plain
    # paths round independently, so they are compared through their
    # distance to the float32 result; in float32 they are compared directly.
    def make_env(dtype, kernels):
        e = dl.Environment(dl.Options(allow_random_weights=True,
                                      compute_dtype=dtype))
        b = e.sam_model()
        b.cfg = dataclasses.replace(b.cfg, encoder_tiny=dataclasses.replace(
            b.cfg.encoder_tiny, use_fused_norm=kernels,
            use_flash_attention=kernels))
        for (k, v), (k2, v2) in zip(bundle.model.state_dict().items(),
                                    b.model.state_dict().items()):
            if k != k2 or not torch.equal(v, v2.to(v.dtype)):
                fail(f"the {dtype} model differs from the main one at {k}")
        return e

    def rel_l2(a, b):
        return (torch.linalg.vector_norm(a - b)
                / torch.linalg.vector_norm(b)).item()

    plain_env = make_env("bfloat16", False)
    f32_plain_env = make_env("float32", False)
    f32_kernel_env = make_env("float32", True)
    for img, seg in zip(images, segs):
        counts = (fused_layer_norm.launches, levit_window_attention.launches)
        plain = dl.Segmentation.process(img, plain_env).embedding
        ref = dl.Segmentation.process(img, f32_plain_env).embedding
        if (fused_layer_norm.launches, levit_window_attention.launches) != counts:
            fail("the plain path launched a kernel")
        f32_k = dl.Segmentation.process(img, f32_kernel_env).embedding
        f32_err = rel_l2(f32_k, ref)
        k_err, p_err = rel_l2(seg.embedding, ref), rel_l2(plain, ref)
        print(f"embedding {img.extent.width}x{img.extent.height}, relative L2: "
              f"float32 kernels vs float32 plain {f32_err:.3e} (limit 1e-5); "
              f"bf16 kernels vs float32 {k_err:.4e}, bf16 plain vs float32 "
              f"{p_err:.4e} (limit 1.1x); bf16 kernels vs bf16 plain "
              f"{rel_l2(seg.embedding, plain):.4e}", flush=True)
        if not f32_err <= 1e-5:
            fail(f"float32 kernel path differs from the plain path: {f32_err}")
        if not k_err <= 1.1 * p_err:
            fail(f"bf16 kernel path is further from float32 ({k_err}) than "
                 f"the bf16 plain path ({p_err})")

    # -- 5. end-to-end times ---------------------------------------------
    def host_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    for img, seg in zip(images, segs):
        p_ms = host_ms(lambda: dl.Segmentation.process(img, env))
        c = dl.Point(img.extent.width // 2, img.extent.height // 2)
        m_ms = host_ms(lambda: seg.compute_mask(c))
        print(f"e2e {img.extent.width}x{img.extent.height} on {gpu_line}: "
              f"process_ms={p_ms:.3f} mask_ms={m_ms:.3f} (medians of 20)",
              flush=True)

    kernels = []
    for name, source, replaces in (
            ("fused_layer_norm", "dlimgedit_tpu_torch/csrc/fused_layer_norm.cu",
             "dlimgedit_tpu/ops/fused_norm.py:64"),
            ("levit_window_attention",
             "dlimgedit_tpu_torch/csrc/levit_attention.cu",
             "dlimgedit_tpu/ops/flash_attention.py:531")):
        e = entries[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": e["max_abs_err"], "ms": e["ms"],
            "plain_ms": e["plain_ms"],
            "bound_ms": max(e["bytes_ms"], e["ops_ms"]),
            "bound_by": "bytes" if e["bytes_ms"] >= e["ops_ms"] else "operations",
            "library_ms": e["library_ms"]})
    print(gpu_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
