"""Where the time of the port's main path goes on one GPU.

    python3 -m dlimgedit_tpu_torch.tools.profile_main_path --out DIR \
        [--variant mobile_sam|vit_b|vit_l|vit_h] [--fused-window-blocks] \
        [--amg [--grid N] [--nms T] [--refine]]

Drives the main path as a user calls it — the SAM variant (default
MobileSAM) at 1024 in bfloat16 with seeded random weights (with
``--fused-window-blocks`` a ViT bundle's config has ``fused_window_blocks``
set, so its windowed blocks run K6 on the padded qkv output instead of the
window partition and K5),
`Segmentation.process` on a 1024x768 RGBA image, then
`compute_mask(Point)` — and traces a steady window (after warm-up) of each
with torch.profiler (CPU and CUDA activities). With ``--amg`` it traces
`generate_masks` instead (automatic mask generation: grid N, 64 slots,
thresholds 0 but ``--nms``; ``--refine`` adds min_mask_region_area 1000,
the eager small-region filter between two graphs), with the greedy NMS
kernel as a layer of its own. For each it prints:
  * wall_ms: host clock per call, ending in a device synchronise;
  * busy_ms: the union of the device's kernel and copy intervals per call;
  * idle share: 1 - busy / wall (time the device waits for the host);
  * the device operations (kernels, copies) per call;
  * device time by layer (the port's kernels K1-K7, convolutions,
    matrix products, elementwise, reductions, copies, other) and the top
    kernels by device time;
  * the host-to-device copies per call (count and device ms): a pageable
    copy waits for the work queued before it.
Every executable is a CUDA graph (``Environment.executable``), captured
in the warm-up calls; torch.profiler records each kernel of a graph
replay (torch 2.11, CUDA 12.8), so busy_ms is read as for eager calls.
The Chrome traces go to DIR. Needs CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import dlimgedit_tpu_torch as dl

LAYERS = (  # first match wins; matched against the lower-cased kernel name
    ("greedy_nms (AMG)", ("greedy_nms_kernel",)),
    ("K3 fused_add_layer_norm", ("add_layer_norm_kernel<",)),
    ("K1 fused_layer_norm", ("layer_norm_kernel<",)),
    ("K2 levit_window_attention", ("levit_attention_kernel",
                                   "levit_window_kernel_tc")),
    ("K4 relpos_attention_global", ("relpos_global_kernel",)),
    ("K5 relpos_attention_windowed", ("relpos_window_kernel",)),
    ("K6 windowed_attention_fused", ("window_strip_attention_kernel",
                                     "window_strip_kernel_tc")),
    ("K7 relpos_attention_qkv", ("relpos_qkv_kernel",)),
    ("convolution", ("conv", "cudnn", "implicit_gemm", "winograd", "dgrad")),
    ("matrix product", ("gemm", "cublas", "cutlass", "matmul", "xmma", "sgemm")),
    ("copy", ("memcpy", "memset", "copy")),
    ("reduction", ("reduce", "softmax", "scan")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index", "where")),
)


def _layer(name: str) -> str:
    low = name.lower()
    for layer, keys in LAYERS:
        if any(k in low for k in keys):
            return layer
    return "other"


def _union_ms(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3  # us -> ms


def profile_calls(label: str, fn, calls: int, out_dir: Path) -> None:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
    prof.export_chrome_trace(str(out_dir / f"{label}.json"))
    intervals, by_layer, by_kernel = [], defaultdict(float), defaultdict(list)
    h2d = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        intervals.append((start, end))
        us = end - start
        by_layer[_layer(ev.name)] += us
        by_kernel[ev.name].append(us)
        if "htod" in ev.name.lower():
            h2d.append(us)
    if not intervals:
        sys.exit(f"{label}: the profiler recorded no device activity")
    busy = _union_ms(intervals) / calls
    wall = statistics.median(walls)
    print(f"\n== {label}: {calls} calls; wall_ms median {wall:.3f}, "
          f"busy_ms {busy:.3f} per call, device idle share "
          f"{1 - busy / (sum(walls) / calls):.3f}; "
          f"{len(intervals) / calls:.1f} device operations per call")
    for layer, us in sorted(by_layer.items(), key=lambda kv: -kv[1]):
        print(f"  {layer:<28} {us / 1e3 / calls:8.4f} ms per call")
    print(f"  host-to-device copies: {len(h2d) / calls:.1f} per call, "
          f"{sum(h2d) / 1e3 / calls:.4f} ms per call")
    print("  top kernels (ms per call, launches per call):")
    top = sorted(by_kernel.items(), key=lambda kv: -sum(kv[1]))[:12]
    for name, us in top:
        print(f"    {sum(us) / 1e3 / calls:8.4f}  x{len(us) / calls:5.1f}  "
              f"{name[:110]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="directory for the Chrome traces")
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--variant", default="mobile_sam",
                    choices=("mobile_sam", "vit_b", "vit_l", "vit_h"))
    ap.add_argument("--fused-window-blocks", action="store_true",
                    help="a ViT's windowed blocks through K6 (its bundle's "
                         "SamViTConfig.fused_window_blocks)")
    ap.add_argument("--amg", action="store_true",
                    help="trace generate_masks instead of the mask click")
    ap.add_argument("--grid", type=int, default=32,
                    help="--amg: points per side of the prompt grid")
    ap.add_argument("--nms", type=float, default=0.7,
                    help="--amg: nms_thresh")
    ap.add_argument("--refine", action="store_true",
                    help="--amg: min_mask_region_area 1000")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_main_path: needs a CUDA device", file=sys.stderr)
        return 2
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"{gpu}; torch {torch.__version__}")
    env = dl.Environment(dl.Options(allow_random_weights=True,
                                    sam_variant=args.variant))
    label = args.variant
    if args.fused_window_blocks:
        bundle = env.sam_model(args.variant)
        if bundle.cfg.encoder_vit is None:
            print("profile_main_path: --fused-window-blocks needs a ViT "
                  "variant", file=sys.stderr)
            return 2
        bundle.cfg = dataclasses.replace(bundle.cfg, encoder_vit=dataclasses.replace(
            bundle.cfg.encoder_vit, fused_window_blocks=True))
        label += "_fused_window"
    px = np.random.default_rng(1).integers(0, 256, (768, 1024, 4), dtype=np.uint8)
    img = dl.Image(dl.Extent(1024, 768), dl.Channels.rgba, px)
    seg = dl.Segmentation.process(img, env)
    if args.amg:
        refine = 1000 if args.refine else 0
        profile_calls(
            f"{label}_amg_grid{args.grid}_nms{args.nms}"
            f"{'_refine' if refine else ''}",
            lambda: seg.generate_masks(grid=args.grid, max_masks=64,
                                       iou_thresh=0.0, stability_thresh=0.0,
                                       nms_thresh=args.nms,
                                       min_mask_region_area=refine),
            args.calls, out_dir)
        return 0
    profile_calls(f"{label}_process",
                  lambda: dl.Segmentation.process(img, env), args.calls, out_dir)
    profile_calls(f"{label}_compute_mask",
                  lambda: seg.compute_mask(dl.Point(512, 384)), args.calls,
                  out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
