"""Where the time of the port's main path goes on one GPU.

    python3 -m dlimgedit_tpu_torch.tools.profile_main_path --out DIR \
        [--variant mobile_sam|vit_b|vit_l|vit_h] [--fused-window-blocks] \
        [--quantize none|w8|w8a8] \
        [--amg [--grid N] [--nms T] [--refine]] \
        [--birefnet [--kind general|high_res]] \
        [--train [--batch B] [--encoder-dtype float32|bfloat16]]

Drives the main path as a user calls it — the SAM variant (default
MobileSAM) at 1024 in bfloat16 with seeded random weights (with
``--fused-window-blocks`` a ViT bundle's config has ``fused_window_blocks``
set, so its windowed blocks run K6 on the padded qkv output instead of the
window partition and K5; with ``--quantize w8`` or ``w8a8`` the encoder's
linears are int8, ``Options.quantize_encoder`` / ``quantize_activations``,
and a w8a8 encoder launches P2 and P3 around each s8 x s8 product),
`Segmentation.process` on a 1024x768 RGBA image, then
`compute_mask(Point)` — and traces a steady window (after warm-up) of each
with torch.profiler (CPU and CUDA activities). With ``--amg`` it traces
`generate_masks` instead (automatic mask generation: grid N, 64 slots,
thresholds 0 but ``--nms``; ``--refine`` adds min_mask_region_area 1000,
the eager small-region filter between two graphs), with the greedy NMS
kernel as a layer of its own. With ``--birefnet`` it traces
`segment_objects` instead (BiRefNet_lite at full width in bfloat16, seeded
random weights with nonzero offset and modulator convs and biases,
``models/birefnet.py::seed_nonzero_init``): ``general`` on a 1024x768
image (resolution 1024), ``high_res`` on a 2000x1500 one (resolution
2048), and the host's resize of the mask back to the extent alone, and
the device ms of the Swin backbone and of the deformable convolutions,
each captured alone (``birefnet_stages``). With ``--train`` it traces the
SAM fine-tuning step instead (train/step.py: MobileSAM at 1024, float32
masters, batch ``--batch`` of synthetic prompts and masks, the encoder in
``--encoder-dtype``; forward, backward and AdamW, the plain paths, eager).
For each it prints:
  * wall_ms: host clock per call, ending in a device synchronise;
  * busy_ms: the union of the device's kernel and copy intervals per call;
  * idle share: 1 - busy / wall (time the device waits for the host);
  * the device operations (kernels, copies) per call;
  * device time by layer (the port's kernels K1-K7, P2 and P3, row gathers (the
    deform taps' index_select), convolutions, matrix products,
    elementwise, reductions, copies, other) and the top
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

import dlimgedit_tpu_torch as dl
from dlimgedit_tpu_torch.image.resize import resize_mask
from dlimgedit_tpu_torch.models.birefnet import seed_nonzero_init
from dlimgedit_tpu_torch.utils.profiling import chrome_trace

LAYERS = (  # first match wins; matched against the lower-cased kernel name
    ("greedy_nms bitmask (AMG)", ("greedy_nms_mask_kernel",)),
    ("greedy_nms scan (AMG)", ("greedy_nms_scan_kernel",)),
    ("K3 fused_add_layer_norm", ("add_layer_norm_kernel<",)),
    ("K1 fused_layer_norm", ("layer_norm_kernel<",)),
    ("K2 levit_window_attention", ("levit_window_kernel",)),
    ("K4 relpos_attention_global", ("relpos_global_kernel",)),
    ("K5 relpos_attention_windowed", ("relpos_window_kernel",)),
    ("K6 windowed_attention_fused", ("window_strip_kernel",)),
    ("K7 relpos_attention_qkv", ("relpos_qkv_kernel",)),
    ("P2 quantize_rows_int8", ("quantize_rows_kernel",)),
    ("P3 int8_epilogue", ("int8_epilogue_kernel",)),
    ("gather (index_select)", ("indexselect", "vectorized_gather_kernel")),
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
    with chrome_trace(out_dir, label) as prof:
        for _ in range(calls):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
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


def _graph_ms(fn, reps: int = 10) -> float:
    """Device ms of `fn` captured as one CUDA graph: the median of `reps`
    replays, each between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn()
    times = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def birefnet_stages(env, kind: str) -> None:
    """Device ms of BiRefNet's two leading stages, each captured alone as a
    CUDA graph on the input of the key's last call, beside the whole
    forward's: the Swin backbone (both passes) and the deformable
    convolutions (every call of one forward, replayed on its own stored
    inputs, so they lose the L2 reuse they have inside the forward: the
    stages do not add up to the whole)."""
    from dlimgedit_tpu_torch.models import birefnet as bn
    from dlimgedit_tpu_torch.models.common import full_precision
    from dlimgedit_tpu_torch.models.swin import swin_apply
    from dlimgedit_tpu_torch.runtime.birefnet import birefnet_input

    bundle = env.birefnet_model(kind)
    key = next(k for k in env.executables if k[:2] == ("birefnet", kind))
    cfg, model = bundle.cfg, bundle.model
    calls, deform = [], bn.deform_conv2d

    def record(*a, **k):
        calls.append((a, k))
        return deform(*a, **k)

    with torch.inference_mode(), full_precision():
        x = birefnet_input(bundle, key[2], *env.executables[key].static_inputs)
        S = x.shape[1]
        bn.deform_conv2d = record
        try:
            bn.birefnet_apply(model, x, cfg)
        finally:
            bn.deform_conv2d = deform

        def swin():
            swin_apply(model.backbone, x, cfg.swin)
            swin_apply(model.backbone,
                       bn.resize_align_corners(x, (S // 2, S // 2)), cfg.swin)

        whole = _graph_ms(lambda: bn.birefnet_apply(model, x, cfg))
        backbone = _graph_ms(swin)
        taps = _graph_ms(lambda: [deform(*a, **k) for a, k in calls])
    n_taps = sum(a[3].shape[2] * a[3].shape[3] for a, _ in calls)
    print(f"  device ms by stage (each alone as a CUDA graph, median of 10 "
          f"replays): whole forward {whole:.3f}; Swin backbone, both passes "
          f"{backbone:.3f}; deformable convolutions ({len(calls)} calls, "
          f"{n_taps} taps) {taps:.3f}")


def profile_train_step(args, out_dir: Path) -> None:
    """The MobileSAM fine-tuning step (train/step.py) at 1024, traced as a
    call: one step on a fixed device batch, ending in a synchronise."""
    from dlimgedit_tpu_torch.models import sam
    from dlimgedit_tpu_torch.train import step as tstep
    from dlimgedit_tpu_torch.train.data import sam_batch_iterator

    dev = torch.device("cuda", 0)
    cfg = sam.make_config("mobile_sam", 1024)
    model = sam.init_sam(torch.Generator().manual_seed(0), cfg).to(dev)
    tcfg = tstep.TrainConfig(encoder_dtype=args.encoder_dtype)
    state = tstep.init_train_state(model, tcfg)
    step = tstep.make_train_step(cfg, tcfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(sam_batch_iterator(
        np.random.default_rng(0), batch_size=args.batch, image_size=1024,
        mask_size=cfg.mask_input_size)).items()}
    profile_calls(f"train_step_mobile_sam_b{args.batch}_{args.encoder_dtype}",
                  lambda: step(model, state, batch), args.calls, out_dir)


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
    ap.add_argument("--quantize", default="none", choices=("none", "w8", "w8a8"),
                    help="int8 encoder linears: weights only, or weights "
                         "and activations")
    ap.add_argument("--amg", action="store_true",
                    help="trace generate_masks instead of the mask click")
    ap.add_argument("--grid", type=int, default=32,
                    help="--amg: points per side of the prompt grid")
    ap.add_argument("--nms", type=float, default=0.7,
                    help="--amg: nms_thresh")
    ap.add_argument("--refine", action="store_true",
                    help="--amg: min_mask_region_area 1000")
    ap.add_argument("--birefnet", action="store_true",
                    help="trace segment_objects (BiRefNet) instead")
    ap.add_argument("--kind", default="general", choices=("general", "high_res"),
                    help="--birefnet: the model kind (resolution 1024 / 2048)")
    ap.add_argument("--train", action="store_true",
                    help="trace the MobileSAM fine-tuning step instead")
    ap.add_argument("--batch", type=int, default=4,
                    help="--train: images per step")
    ap.add_argument("--encoder-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="--train: TrainConfig.encoder_dtype")
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
    if args.train:
        profile_train_step(args, out_dir)
        return 0
    if args.birefnet:
        env = dl.Environment(dl.Options(allow_random_weights=True))
        seed_nonzero_init(env.birefnet_model(args.kind).model)
        w, h = (1024, 768) if args.kind == "general" else (2000, 1500)
        px = np.random.default_rng(1).integers(0, 256, (h, w, 4), dtype=np.uint8)
        img = dl.Image(dl.Extent(w, h), dl.Channels.rgba, px)
        profile_calls(f"birefnet_{args.kind}_{w}x{h}",
                      lambda: dl.segment_objects(img, env), args.calls, out_dir)
        S = env.birefnet_model(args.kind).resolution
        mask = dl.ImageView.from_array(
            np.random.default_rng(2).integers(0, 256, (S, S), dtype=np.uint8),
            dl.Channels.mask)
        times = []
        for _ in range(6):
            t = time.perf_counter()
            resize_mask(mask, img.extent)
            times.append((time.perf_counter() - t) * 1e3)
        print(f"  host resize_mask {S}x{S} -> {w}x{h} alone: "
              f"{statistics.median(times[1:]):.3f} ms (median of 5, after "
              f"one call that makes the taps)")
        birefnet_stages(env, args.kind)
        return 0
    env = dl.Environment(dl.Options(
        allow_random_weights=True, sam_variant=args.variant,
        quantize_encoder=args.quantize != "none",
        quantize_activations=args.quantize == "w8a8"))
    label = args.variant + ("" if args.quantize == "none" else f"_{args.quantize}")
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
