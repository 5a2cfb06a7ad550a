"""End-to-end check of the port's Python-free serving route: the port's
counterpart of the JAX package's ``tools/serving_check.py``.

    python -m dlimgedit_tpu_torch.tools.serving_check --dir DIR
        [--size 1024] [--sam-image-size N] [--backend gpu|cpu]
        [--compute-dtype bfloat16] [--models DIR] [--time N]

1. Exports a serving bundle (tools/aot_export.py) into DIR/bundle, for the
   buckets of a ``size`` x ``3/4 size`` image and of a smaller non-square
   one (``size * 500/1024`` x ``size * 375/1024``).
2. Writes the port's Python API's results into DIR/check, with the
   exporter's environment (the same weights): ``compute_mask`` of 8
   points and 4 boxes, ``compute_masks`` of the first
   point, ``compute_mask_batch`` of them all, a point on the small
   image, and the first point on a second image of the main size (the
   files test_serving.cpp reads).
3. Builds the serving library (``native_build.build_serving()``) and runs
   ``test_serving`` in a fresh process: the public C++ API with
   DLIMG_PJRT_BUNDLE set, no PYTHONPATH but a ``sitecustomize`` that
   leaves a marker file if an interpreter starts. It must hold every mask
   byte-equal and every accuracy bit-equal, and leave no marker.
4. Runs ``test_serving_programs`` over every program (each against the
   exporter's Python outputs) and ``test_bundle_parse``.

Exit 0 when all of it holds. On the CPU, byte equality needs the same
thread count on both sides: the C++ process gets OMP_NUM_THREADS =
``torch.get_num_threads()`` of this process.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native_build
from ..ops.preprocess import pick_bucket
from ..runtime.segmentation import Segmentation
from ..types import Channels, Extent, Image, Point, Region
from . import aot_export

MARKER = "python-started"


def image_sizes(size: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((w, h) of the main image, (w, h) of the small one)."""
    return (size, (3 * size) // 4), ((size * 500) // 1024,
                                     (size * 375) // 1024)


def bundle_args(out: Path, size: int, backend: str, sam_image_size: int = 0,
                compute_dtype: str = "bfloat16",
                models: str = "") -> argparse.Namespace:
    """The exporter's arguments for `size`'s two images."""
    main, small = image_sizes(size)
    buckets = sorted({pick_bucket(Extent(*main)), pick_bucket(Extent(*small))})
    argv = ["--out", str(out), "--backend", backend,
            "--buckets", ",".join(map(str, buckets)),
            "--compute-dtype", compute_dtype]
    if sam_image_size:
        argv += ["--sam-image-size", str(sam_image_size)]
    if models:
        argv += ["--models", models]
    return aot_export.parse_args(argv)


def prompts_for(w: int, h: int, n_points: int, n_boxes: int,
                seed: int = 0) -> List:
    """Points, then boxes, inside a w x h image."""
    rng = np.random.default_rng(seed)
    out: List = []
    for _ in range(n_points):
        out.append(Point(int(rng.integers(0, w)), int(rng.integers(0, h))))
    for _ in range(n_boxes):
        x0, y0 = int(rng.integers(0, w // 2)), int(rng.integers(0, h // 2))
        out.append(Region(Point(x0, y0),
                          Point(int(rng.integers(x0 + 1, w)),
                                int(rng.integers(y0 + 1, h)))))
    return out


def write_goldens(env, check: Path, size: int, n_points: int, n_boxes: int,
                  seed: int = 0) -> dict:
    """The Python API's results on the check images (test_serving.cpp's
    files). -> {"prompts", "masks", "batch", "three", "small",
    "small_point", "second"} for the caller's own comparisons."""
    check.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    (w, h), (sw, sh) = image_sizes(size)
    px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    seg = Segmentation.process(Image(Extent(w, h), Channels.rgba, px), env)
    prompts = prompts_for(w, h, n_points, n_boxes, seed)
    masks = [seg.compute_mask(p).pixels.reshape(h, w) for p in prompts]
    batch = seg.compute_mask_batch(prompts)
    first = next(p for p in prompts if isinstance(p, Point))
    three = seg.compute_masks(first)
    spx = rng.integers(0, 256, (sh, sw, 3), dtype=np.uint8)
    sseg = Segmentation.process(Image(Extent(sw, sh), Channels.rgb, spx), env)
    spoint = Point(sw // 2, sh // 2)
    small = sseg.compute_mask(spoint).pixels.reshape(sh, sw)
    px2 = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    seg2 = Segmentation.process(Image(Extent(w, h), Channels.rgba, px2), env)
    second = seg2.compute_mask(first).pixels.reshape(h, w)

    (check / "image.raw").write_bytes(px.tobytes())
    (check / "meta.txt").write_text(f"{w} {h} 4\n")
    rows = [f"{len(prompts)}"]
    for p in prompts:
        if isinstance(p, Region):
            rows.append(f"1 {p.top_left.x} {p.top_left.y} "
                        f"{p.bottom_right.x} {p.bottom_right.y}")
        else:
            rows.append(f"0 {p.x} {p.y} 0 0")
    (check / "prompts.txt").write_text("\n".join(rows) + "\n")
    (check / "golden_masks.raw").write_bytes(
        b"".join(m.tobytes() for m in masks))
    np.array([m.accuracy for m in batch], np.float32).tofile(
        check / "golden_batch_iou.raw")
    (check / "golden3.raw").write_bytes(
        b"".join(m.image.pixels.tobytes() for m in three))
    np.array([m.accuracy for m in three], np.float32).tofile(
        check / "golden3_iou.raw")
    (check / "image_small.raw").write_bytes(spx.tobytes())
    (check / "golden_small.raw").write_bytes(small.tobytes())
    (check / "meta_small.txt").write_text(
        f"{sw} {sh} 3 {spoint.x} {spoint.y}\n")
    (check / "image2.raw").write_bytes(px2.tobytes())
    (check / "golden2.raw").write_bytes(second.tobytes())
    return {"prompts": prompts, "masks": masks, "batch": batch,
            "three": three, "small": small, "small_point": spoint,
            "second": second}


def fresh_env(work: Path, **extra) -> dict:
    """The environment of a fresh C++ process: no PYTHONPATH of the repo,
    but a sitecustomize that leaves ``work/python-started`` if an
    interpreter starts; CPU threads as this process's."""
    site = work / "site"
    site.mkdir(parents=True, exist_ok=True)
    (site / "sitecustomize.py").write_text(
        f"open({str(work / MARKER)!r}, 'w').close()\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLIMG_") and k not in ("PYTHONPATH",
                                                       "PYTHONHOME")}
    env.update({"PYTHONPATH": str(site),
                "OMP_NUM_THREADS": str(torch.get_num_threads())})
    env.update(extra)
    return env


def run_test_serving(build, bundle: Path, check: Path, work: Path,
                     backend: str, time_n: int = 0,
                     timeout: int = 900) -> subprocess.CompletedProcess:
    """test_serving in a fresh process; raises if it fails or an
    interpreter started."""
    (work / MARKER).unlink(missing_ok=True)
    cmd = [str(build.executable("test_serving")), backend]
    if time_n:
        cmd += ["--time", str(time_n)]
    r = subprocess.run(cmd, env=fresh_env(
        work, DLIMG_PJRT_BUNDLE=str(bundle),
        DLIMG_SERVING_CHECK_DIR=str(check)), cwd=work,
        capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0 or "PASS: Python-free serving" not in r.stdout:
        raise RuntimeError(f"test_serving failed (exit {r.returncode}):\n"
                           f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    if (work / MARKER).exists():
        raise RuntimeError("test_serving started a Python interpreter")
    return r


def programs(bundle: Path) -> List[str]:
    return sorted(p.name[:-len(".spec.txt")]
                  for p in bundle.glob("serve_*.spec.txt"))


def run_test_programs(build, bundle: Path, work: Path, backend: str,
                      timeout: int = 900) -> subprocess.CompletedProcess:
    """test_serving_programs over every program, then test_bundle_parse;
    raises on a failure."""
    r = subprocess.run(
        [str(build.executable("test_serving_programs")), backend, str(bundle),
         *programs(bundle)], env=fresh_env(work), capture_output=True,
        text=True, timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"test_serving_programs failed (exit "
                           f"{r.returncode}):\n{r.stdout[-4000:]}\n"
                           f"{r.stderr[-4000:]}")
    p = subprocess.run([str(build.executable("test_bundle_parse")),
                        str(bundle)], capture_output=True, text=True,
                       timeout=timeout)
    if p.returncode != 0:
        raise RuntimeError(f"test_bundle_parse failed: {p.stderr[-2000:]}")
    return subprocess.CompletedProcess(r.args, 0, r.stdout + p.stdout, "")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="dlimgedit_tpu_torch.tools.serving_check")
    ap.add_argument("--dir", required=True)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--sam-image-size", type=int, default=0)
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"])
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--models", default="")
    ap.add_argument("--time", type=int, default=0,
                    help="also time N process and compute_mask calls")
    args = ap.parse_args(argv)
    work = Path(args.dir).resolve()
    bundle, check = work / "bundle", work / "check"
    env = aot_export.export_serving(bundle_args(
        bundle, args.size, args.backend, args.sam_image_size,
        args.compute_dtype, args.models))
    write_goldens(env, check, args.size, 8, 4)
    build = native_build.build_serving()
    print(run_test_serving(build, bundle, check, work, args.backend,
                           args.time).stdout, end="")
    print(run_test_programs(build, bundle, work, args.backend).stdout, end="")
    print("serving_check: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
