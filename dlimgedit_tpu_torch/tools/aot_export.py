"""Write a serving bundle for the port's Python-free route: the port's
counterpart of the JAX package's ``tools/aot_export.py --program serving``.

    python -m dlimgedit_tpu_torch.tools.aot_export --out DIR --program serving
        [--variant mobile_sam] [--buckets 512,1024] [--sam-image-size N]
        [--backend gpu|cpu] [--compute-dtype bfloat16|float32] [--models DIR]

A C or C++ host that sets ``DLIMG_PJRT_BUNDLE=DIR`` then serves
``create_environment``, ``process``, ``compute_mask(s)`` and
``compute_mask_batch`` through the port's C library with no Python in its
process: the library dlopens ``libdlimgedit_tpu_torch_serving.so``
(``python -m dlimgedit_tpu_torch.native_build --serving``), whose C++
programs mirror the Python modules op for op (native/src/torch_programs.cpp).

The bundle holds, per canvas bucket (``ops/preprocess.py`` CANVAS_BUCKETS),
three programs, ``serve_embed_<variant>_<bucket>`` (preprocess + encoder),
``serve_decode_<variant>_<bucket>`` (one mask) and
``serve_decode3_<variant>_<bucket>`` (three masks and their accuracies),
each as
  <name>.spec.txt   one row per argument, then per output:
                      inw <dtype> <d0,d1,..> <state_dict name>   a weight
                      ind <dtype> <d0,d1,..>                     dynamic
                      out <dtype> <d0,d1,..>
  <name>.in<k>.npy  a sample value of the k-th dynamic argument
  <name>.out<i>.npy the port's Python path's outputs on those samples (the
                    environment's executables, as ``Segmentation`` runs them)
and, once for every program that names it, ``weights/<state_dict
name>.npy``: the loaded module's tensor after every load-time transform
(the compute-dtype cast, TinyViT's attention-bias index tables), bf16 as
its 16 bits (the spec names the dtype). Then ``serving.txt`` (format,
variant, backend, image_size, buckets,
compute_dtype, decoder_heads). A ``gpu`` bundle also names the port's
kernel library in ``kernels_path.txt`` (built first, ops/cuda_build.py), as
the JAX bundle names its PJRT plugin in ``plugin_path.txt``.

Weights are random (seed 0) unless ``--models`` names a model directory
(``<dir>/segmentation/mobile_sam.npz``, e.g. from the converters). The
options of later slices of this route (ROADMAP A8) raise ``DlimgError``:
the SAM ViTs, ``--batch-sizes``, ``--amg``, ``--birefnet``, ``--quantize``,
``--quantize-activations``, ``--int8-deform``.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..errors import DlimgError
from ..ops.preprocess import CANVAS_BUCKETS
from ..runtime.environment import Environment
from ..runtime.segmentation import _build_decode_fn, _build_embed_fn, _to_host
from ..types import Backend, Options

FORMAT = "dlimgedit_tpu_torch-serving-2"  # native/src/bundle.hpp kFormat

# The JAX exporter's options that later slices of this route will serve.
LATER_SLICES = {
    "batch_sizes": ("--batch-sizes", "serve_decode_batch"),
    "amg": ("--amg", "automatic mask generation"),
    "birefnet": ("--birefnet", "BiRefNet segment_objects"),
    "quantize": ("--quantize", "the int8 encoders"),
    "quantize_activations": ("--quantize-activations", "the int8 encoders"),
    "int8_deform": ("--int8-deform", "BiRefNet segment_objects"),
}

_NP_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
              torch.int64: "int64", torch.int32: "int32",
              torch.uint8: "uint8"}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="dlimgedit_tpu_torch.tools.aot_export")
    ap.add_argument("--out", required=True)
    ap.add_argument("--program", default="serving", choices=["serving"])
    ap.add_argument("--variant", default="mobile_sam")
    ap.add_argument("--buckets", default="1024",
                    help="comma list of canvas buckets (of CANVAS_BUCKETS)")
    ap.add_argument("--sam-image-size", type=int, default=0,
                    help="model input resolution (default 1024)")
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"],
                    help="gpu: cuda:0 (raises without CUDA); cpu: the CPU")
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--models", default="",
                    help="model directory (default: seeded random weights)")
    ap.add_argument("--batch-sizes", default="")
    ap.add_argument("--amg", default="")
    ap.add_argument("--birefnet", default="")
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--quantize-activations", action="store_true")
    ap.add_argument("--int8-deform", action="store_true")
    return ap.parse_args(argv)


def _refuse_later_slices(args: argparse.Namespace) -> None:
    if args.variant not in ("mobile_sam", "vit_t"):
        raise DlimgError(
            f"--variant {args.variant}: the Python-free route serves "
            f"MobileSAM in this slice; the SAM ViTs are a later slice "
            f"(ROADMAP A8)")
    for attr, (flag, what) in LATER_SLICES.items():
        if getattr(args, attr):
            raise DlimgError(
                f"{flag}: {what} through the Python-free route is a later "
                f"slice (ROADMAP A8); this bundle serves process, "
                f"compute_mask(s) and compute_mask_batch")


def _buckets(text: str) -> List[int]:
    buckets = sorted({int(b) for b in text.split(",") if b.strip()})
    bad = [b for b in buckets if b not in CANVAS_BUCKETS]
    if not buckets or bad:
        raise DlimgError(f"--buckets {text!r}: each bucket must be one of "
                         f"CANVAS_BUCKETS {CANVAS_BUCKETS} (ops/preprocess.py "
                         f"pick_bucket)")
    return buckets


def _row(kind: str, x, key: str = ""):
    """(the spec row, the array to save) of a tensor or numpy array: bf16
    as its 16 bits (the bf16 rule), C-contiguous."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype not in _NP_DTYPES:
            raise DlimgError(f"no bundle dtype for {t.dtype}")
        dtype = _NP_DTYPES[t.dtype]
        arr = (t.view(torch.int16).numpy().view(np.uint16)
               if t.dtype == torch.bfloat16 else t.numpy())
    else:
        arr = np.ascontiguousarray(x)
        dtype = str(arr.dtype)
    row = f"{kind} {dtype} {','.join(map(str, arr.shape))}"
    return (f"{row} {key}" if key else row), arr


def _tensors(model: torch.nn.Module, prefixes) -> Dict[str, torch.Tensor]:
    """The parameters and buffers (also non-persistent ones: TinyViT's
    index tables) whose name starts with a prefix, in module order."""
    named = dict(model.named_parameters())
    named.update(model.named_buffers())
    return {k: v for k, v in named.items() if k.startswith(prefixes)}


def write_program(out: Path, name: str, weights: Dict[str, torch.Tensor],
                  dynamic: Sequence, outputs: Sequence,
                  stored: Dict[str, str]) -> None:
    """<name>.spec.txt and its .npy files (see the module docstring); a
    weight goes to weights/ unless ``stored`` (name -> spec row, of this
    export) holds it already."""
    rows, new = [], 0
    for key, t in weights.items():
        row, arr = _row("inw", t, key)
        if key not in stored:
            np.save(out / "weights" / f"{key}.npy", arr)
            stored[key] = row
            new += 1
        elif stored[key] != row:
            raise DlimgError(f"{name}: weight {key} is {row!r}, an earlier "
                             f"program stored {stored[key]!r}")
        rows.append(row)
    for k, x in enumerate(dynamic):
        row, arr = _row("ind", x)
        rows.append(row)
        np.save(out / f"{name}.in{k}.npy", arr)
    for i, o in enumerate(outputs):
        row, arr = _row("out", o)
        rows.append(row)
        np.save(out / f"{name}.out{i}.npy", arr)
    (out / f"{name}.spec.txt").write_text("\n".join(rows) + "\n")
    mib = sum(t.numel() * t.element_size() for t in weights.values()) / 2**20
    print(f"exported {name}: {len(weights)} weights ({mib:.2f} MiB, {new} "
          f"stored new), {len(dynamic)} dynamic, {len(outputs)} out",
          flush=True)


def make_environment(args: argparse.Namespace) -> Environment:
    extra = ({"sam_image_size": args.sam_image_size}
             if args.sam_image_size else {})
    return Environment(Options(
        backend=Backend.cpu if args.backend == "cpu" else Backend.gpu,
        model_directory=args.models or "models",
        allow_random_weights=not args.models,
        compute_dtype=args.compute_dtype, sam_variant="mobile_sam", **extra))


def export_serving(args: argparse.Namespace,
                   env: Optional[Environment] = None) -> Environment:
    """Write the bundle into ``args.out``; -> the environment whose
    executables computed the sample outputs (``env`` when given: its
    options must be the arguments')."""
    _refuse_later_slices(args)
    buckets = _buckets(args.buckets)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for stale in [*out.glob("serve_*"), out / "serving.txt",
                  out / "kernels_path.txt"]:
        stale.unlink(missing_ok=True)
    shutil.rmtree(out / "weights", ignore_errors=True)
    (out / "weights").mkdir()
    env = env if env is not None else make_environment(args)
    variant = "mobile_sam"
    bundle = env.sam_model(variant)
    if env.device.type == "cuda":
        from ..ops.cuda_build import LIBRARY

        LIBRARY.get()
        (out / "kernels_path.txt").write_text(f"{LIBRARY.path}\n")
    encoder = _tensors(bundle.model, ("encoder.",))
    decoder = _tensors(bundle.model, ("prompt_encoder.", "decoder."))
    stored: Dict[str, str] = {}
    rng = np.random.default_rng(0)
    image_size = bundle.cfg.image_size
    for b in buckets:
        canvas = rng.integers(0, 256, (b, b, 3), dtype=np.uint8)
        side = min(b, image_size)
        sizes = np.array([b, b, side, side], np.int32)
        embed = env.executable(("embed", variant, b, bundle.quant),
                               lambda: _build_embed_fn(bundle),
                               torch.Tensor.clone)
        emb = embed(torch.from_numpy(canvas), env.sizes_on_device(tuple(sizes)))
        write_program(out, f"serve_embed_{variant}_{b}", encoder,
                      [canvas, sizes], [emb], stored)
        pts = np.array([[[b / 2, b / 2], [0.0, 0.0]]], np.float32)
        lbl = np.array([[1.0, -1.0]], np.float32)
        for name, multimask in (("serve_decode", False),
                                ("serve_decode3", True)):
            decode = env.executable(
                ("decode", variant, b, multimask, False),
                lambda m=multimask: _build_decode_fn(bundle, b, m, False),
                _to_host)
            packed, iou = decode(emb, torch.from_numpy(pts),
                                 torch.from_numpy(lbl),
                                 env.sizes_on_device(tuple(sizes)))
            write_program(out, f"{name}_{variant}_{b}", decoder,
                          [emb, pts, lbl, sizes], [packed, iou], stored)
    (out / "serving.txt").write_text(
        f"format\t{FORMAT}\n"
        f"variant\t{variant}\n"
        f"backend\t{args.backend}\n"
        f"image_size\t{image_size}\n"
        f"buckets\t{','.join(map(str, buckets))}\n"
        f"compute_dtype\t{args.compute_dtype}\n"
        f"decoder_heads\t{bundle.cfg.decoder.num_heads}\n")
    return env


def main(argv: Optional[Sequence[str]] = None) -> int:
    export_serving(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
