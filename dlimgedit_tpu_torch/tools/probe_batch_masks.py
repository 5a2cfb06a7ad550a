"""Does a batched prompt's mask depend on the batch it rides in?

    python3 dlimgedit_tpu_torch/tools/probe_batch_masks.py \
        [--contract] [--cause] [--time] [--root DIR]

The JAX package's contract (tests/test_segmentation.py::
test_compute_mask_batch_matches_individual): every mask of
`compute_mask_batch` is byte-equal to `compute_mask` of its prompt. On the
card each row count of a product can get another cuBLAS kernel (tile,
split-K, a gemv for few rows), and so another order of each row's sum.
This probe drives MobileSAM at 1024 in bfloat16 (the decoder float32),
seeded random weights, on a 1024x768 image (bucket 1024):

  --contract  16 seeded prompts (points and boxes), with
              largest_region_object on and off: every batch size 1-8 with
              each prompt at every position, each mask against
              `compute_mask`; prints the masks that differ, their flipped
              pixels and the largest |logit| under a flip.
  --cause     prompt 0's intermediates through the batched decoder
              (`decode_masks` over N prompts and the upsample of the N
              masks, as AMG decodes and as `compute_mask_batch` did up to
              its repair) at N = 1 against N = 2, 4 and 8: every operation
              is recorded (a TorchFunctionMode) and prompt 0's slice of
              its output compared; prints the first operation whose slice
              differs and the first of each source line that differs.
  --time      graphed `compute_mask_batch` at N = 1, 2, 4 and 8 (medians
              of 20), `mask_ms` (one `compute_mask(Point)`, median of 20)
              and `amg_ms` (grid 32, 64 slots, IoU and stability filters
              off, NMS 0.7, median of 5): host clock around calls whose
              results reach the host.

With ``--root DIR`` the package is imported from DIR (an unpacked checkout
of another commit), so one chip call can time parent and change in turns.
Run it as a script (not with -m) for that. Needs CUDA. The functions
`batch_prompts`, `hold_batches` and `describe` are what
tests/test_torch_cuda.py and chip_smoke.py hold the contract with.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

WIDTH, HEIGHT, IMAGE_SEED = 1024, 768, 1
PROMPTS = 16
BATCH_SIZES = tuple(range(1, 9))
CAUSE_SIZES = (2, 4, 8)
TIME_SIZES = (1, 2, 4, 8)


def batch_prompts(dl, extent, n: int = PROMPTS, seed: int = 0) -> list:
    """`n` seeded prompts on an image of `extent`, points and boxes in
    turn (a box at least an eighth of each side)."""
    rng = np.random.default_rng(seed)
    w, h = extent.width, extent.height
    out = []
    for i in range(n):
        if i % 2 == 0:
            out.append(dl.Point(int(rng.integers(0, w)), int(rng.integers(0, h))))
            continue
        bw, bh = int(rng.integers(w // 8, w // 2)), int(rng.integers(h // 8, h // 2))
        x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        out.append(dl.Region(dl.Point(x0, y0), dl.Point(x0 + bw, y0 + bh)))
    return out


def single_logits(dl, seg, prompt) -> np.ndarray:
    """The upsampled logits of `compute_mask(prompt)` at the image's extent
    (before the threshold and any largest-component filter), from the eager
    decoder at one prompt: where a flipped pixel's logit lies."""
    from dlimgedit_tpu_torch.models import sam as sam_lib
    from dlimgedit_tpu_torch.models.common import full_precision
    from dlimgedit_tpu_torch.ops.postprocess import upsample_mask_logits
    from dlimgedit_tpu_torch.ops.preprocess import pick_bucket

    bundle = seg._env.sam_model(seg._variant)
    region = isinstance(prompt, dl.Region)
    points, labels = seg._prompt_arrays(None if region else prompt,
                                        prompt if region else None)
    dev = seg.embedding.device
    sizes = seg._sizes()
    with torch.inference_mode(), full_precision():
        masks, _ = sam_lib.decode_masks(
            bundle.model, bundle.cfg, seg.embedding,
            torch.from_numpy(points).to(dev), torch.from_numpy(labels).to(dev),
            multimask=False)
        logits = upsample_mask_logits(masks, pick_bucket(seg.extent),
                                      bundle.cfg.image_size, sizes[0],
                                      sizes[1], sizes[2], sizes[3])
    h, w = seg.extent.height, seg.extent.width
    return logits[0, 0, :h, :w].float().cpu().numpy()


def hold_batches(dl, seg, prompts, sizes: Sequence[int] = BATCH_SIZES) -> dict:
    """Every batch size in `sizes`, each prompt at every position (batch b
    from start s is prompts[(s + j) % n], j < b, for every s < n), each
    mask against `seg.compute_mask` of its prompt byte for byte. Returns
    {"calls", "masks", "differ": [{batch, start, position, prompt, flips,
    max_logit}, ...]}."""
    n = len(prompts)
    want = [np.asarray(seg.compute_mask(p).pixels) for p in prompts]
    logits: Dict[int, np.ndarray] = {}
    differ, calls, masks = [], 0, 0
    for b in sizes:
        for s in range(n):
            got = seg.compute_mask_batch([prompts[(s + j) % n] for j in range(b)])
            calls += 1
            for j, m in enumerate(got):
                k, masks = (s + j) % n, masks + 1
                px = np.asarray(m.image.pixels)
                if np.array_equal(px, want[k]):
                    continue
                flip = (px != want[k]).reshape(want[k].shape[:2])
                if k not in logits:
                    logits[k] = single_logits(dl, seg, prompts[k])
                differ.append(dict(batch=b, start=s, position=j, prompt=k,
                                   flips=int(flip.sum()),
                                   max_logit=float(np.abs(logits[k][flip]).max())))
    return dict(calls=calls, masks=masks, differ=differ)


def describe(report: dict) -> str:
    """One line: how many masks differ, their flipped pixels and the
    largest |logit| under a flip, by batch size."""
    d = report["differ"]
    if not d:
        return (f"all {report['masks']} masks of {report['calls']} batches "
                f"byte-equal to compute_mask")
    by = {}
    for e in d:
        by[e["batch"]] = by.get(e["batch"], 0) + 1
    prompts = sorted({e["prompt"] for e in d})
    return (f"{len(d)} of {report['masks']} masks of {report['calls']} "
            f"batches differ from compute_mask (prompts {prompts}; by batch "
            f"size {dict(sorted(by.items()))}): {sum(e['flips'] for e in d)} "
            f"flipped pixels in all, at most {max(e['flips'] for e in d)} in "
            f"one mask; largest |logit| under a flip "
            f"{max(e['max_logit'] for e in d):.6g}")


def main_path_segmentation(dl, largest_region_object: bool = True):
    """MobileSAM at 1024, bf16 encoder, seeded random weights, on the
    seeded 1024x768 RGBA image: (env, seg)."""
    env = dl.Environment(dl.Options(allow_random_weights=True,
                                    largest_region_object=largest_region_object))
    px = np.random.default_rng(IMAGE_SEED).integers(
        0, 256, (HEIGHT, WIDTH, 4), dtype=np.uint8)
    img = dl.Image(dl.Extent(WIDTH, HEIGHT), dl.Channels.rgba, px)
    return env, dl.Segmentation.process(img, env)


# -- the cause: prompt 0's intermediates at N = 1 against N -------------------

def _recorder():
    from torch.overrides import TorchFunctionMode

    package = str(Path(__file__).resolve().parents[1])
    here = str(Path(__file__).resolve())

    class Record(TorchFunctionMode):
        """Every floating-point tensor an operation returns, with the
        operation's name and its two innermost call sites in the port."""

        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor) and out.is_floating_point():
                frames, f = [], sys._getframe(1)
                while f is not None and len(frames) < 2:
                    name = f.f_code.co_filename
                    if name.startswith(package) and name != here:
                        frames.append(f"{Path(name).relative_to(package)}:"
                                      f"{f.f_lineno} {f.f_code.co_name}")
                    f = f.f_back
                site = " < ".join(frames) or "?"
                name = getattr(func, "__name__", str(func))
                self.ops.append((name, site, out.detach()))
            return out

    return Record()


def _batched_logits(seg, points, labels):
    """The batched decoder over N prompts and the upsample of its N masks
    (the program `compute_mask_batch` ran up to its repair)."""
    from dlimgedit_tpu_torch.models import sam as sam_lib
    from dlimgedit_tpu_torch.ops.postprocess import upsample_mask_logits
    from dlimgedit_tpu_torch.ops.preprocess import pick_bucket

    bundle = seg._env.sam_model(seg._variant)
    emb = seg.embedding
    n = points.shape[0]
    sizes = seg._sizes()
    masks, _ = sam_lib.decode_masks(bundle.model, bundle.cfg,
                                    emb.expand(n, *emb.shape[1:]), points,
                                    labels, multimask=False)
    return upsample_mask_logits(masks[:, 0][None], pick_bucket(seg.extent),
                                bundle.cfg.image_size, sizes[0], sizes[1],
                                sizes[2], sizes[3])


def _prompt_zero(one: torch.Tensor, many: torch.Tensor, n: int):
    """Prompt 0's part of `many` (an output at N prompts) in the shape of
    `one` (the same output at one prompt): the first block along the first
    axis that grew N-fold; `many` itself when the shapes agree."""
    if one.shape == many.shape:
        return many
    if one.dim() != many.dim():
        return None
    for d, (a, b) in enumerate(zip(one.shape, many.shape)):
        if b == n * a and all(x == y for i, (x, y) in
                              enumerate(zip(one.shape, many.shape)) if i != d):
            return many.narrow(d, 0, a)
    return None


def find_cause(dl, seg, prompts, sizes: Sequence[int] = CAUSE_SIZES) -> List[str]:
    """Lines naming, for each N, the first operation whose prompt-0 slice
    differs from N = 1's, and the first differing operation of each source
    line after it."""
    from dlimgedit_tpu_torch.models.common import full_precision

    dev = seg.embedding.device
    arrays = [seg._prompt_arrays(None, p) if isinstance(p, dl.Region)
              else seg._prompt_arrays(p, None) for p in prompts]

    def run(n):
        pts = torch.from_numpy(np.concatenate([a[0] for a in arrays[:n]])).to(dev)
        lab = torch.from_numpy(np.concatenate([a[1] for a in arrays[:n]])).to(dev)
        rec = _recorder()
        with torch.inference_mode(), full_precision(), rec:
            _batched_logits(seg, pts, lab)
        torch.cuda.synchronize()
        return rec.ops

    base = run(1)
    lines = []
    for n in sizes:
        ops = run(n)
        if len(ops) != len(base):
            lines.append(f"N={n}: {len(ops)} operations against {len(base)} at "
                         f"N=1; not comparable")
            continue
        first, sites = None, {}
        for i, ((name, site, a), (_, _, b)) in enumerate(zip(base, ops)):
            part = _prompt_zero(a, b, n)
            if part is None or torch.equal(a, part):
                continue
            err = (a.float() - part.float()).abs().max().item()
            if first is None:
                first = (i, name, site, err)
            sites.setdefault(site, (i, name, err))
        if first is None:
            lines.append(f"N={n}: prompt 0's intermediates all equal N=1's "
                         f"({len(ops)} operations)")
            continue
        i, name, site, err = first
        lines.append(f"N={n}: first operation whose prompt-0 slice differs "
                     f"from N=1's: #{i} of {len(ops)} {name} at {site} "
                     f"(max|diff| {err:.3g}); first differing operation of "
                     f"each source line: " + "; ".join(
                         f"#{j} {nm} at {s} ({e:.3g})"
                         for s, (j, nm, e) in sorted(sites.items(),
                                                     key=lambda kv: kv[1][0])))
    return lines


# -- the time -----------------------------------------------------------------

def _median_ms(fn, n: int) -> float:
    fn()
    out = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def time_paths(dl, seg) -> str:
    w, h = seg.extent.width, seg.extent.height
    points = [dl.Point(w * (i + 1) // 9, h * (8 - i) // 9) for i in range(8)]
    parts = [f"mask_ms={_median_ms(lambda: seg.compute_mask(points[0]), 20):.3f}"]
    for n in TIME_SIZES:
        ms = _median_ms(lambda: seg.compute_mask_batch(points[:n]), 20)
        parts.append(f"batch{n}_ms={ms:.3f}")
    amg = dict(grid=32, max_masks=64, iou_thresh=0.0, stability_thresh=0.0,
               nms_thresh=0.7)
    parts.append(f"amg_ms={_median_ms(lambda: seg.generate_masks(**amg), 5):.3f}")
    return " ".join(parts)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--contract", action="store_true")
    ap.add_argument("--cause", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose dlimgedit_tpu_torch is imported")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import dlimgedit_tpu_torch as dl

    if not str(Path(dl.__file__).resolve()).startswith(root):
        raise SystemExit(f"dlimgedit_tpu_torch came from {dl.__file__}, not "
                         f"{root}: run this file as a script")
    if not torch.cuda.is_available():
        raise SystemExit("probe_batch_masks: needs a CUDA device")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"root {root}; device {torch.cuda.get_device_name(0)} ({gpu})",
          flush=True)
    env, seg = main_path_segmentation(dl)
    prompts = batch_prompts(dl, seg.extent)
    if args.cause:
        for line in find_cause(dl, seg, prompts):
            print(f"cause: {line}", flush=True)
    if args.contract:
        for lcc in (True, False):
            e, s = (env, seg) if lcc else main_path_segmentation(dl, False)
            t = time.perf_counter()
            report = hold_batches(dl, s, prompts)
            print(f"contract, largest_region_object={lcc}: {describe(report)} "
                  f"[{time.perf_counter() - t:.1f} s]", flush=True)
            for d in report["differ"][:12]:
                print(f"  differs: {d}", flush=True)
    if args.time:
        print(f"time MobileSAM {WIDTH}x{HEIGHT} bf16 graphed on {gpu}: "
              f"{time_paths(dl, seg)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
