"""Write a serving bundle for the port's Python-free route: the port's
counterpart of the JAX package's ``tools/aot_export.py --program serving``.

    python -m dlimgedit_tpu_torch.tools.aot_export --out DIR --program serving
        [--variant mobile_sam|vit_b|vit_l|vit_h] [--buckets 512,1024]
        [--batch-sizes 4,8] [--amg GRID:MAX_MASKS]
        [--birefnet general:1024,high_res:2048] [--sam-image-size N]
        [--backend gpu|cpu] [--compute-dtype bfloat16|float32]
        [--quantize] [--quantize-activations] [--int8-deform]
        [--models DIR]

A C or C++ host that sets ``DLIMG_PJRT_BUNDLE=DIR`` then serves
``create_environment``, ``process``, ``compute_mask(s)``,
``compute_mask_batch``, ``generate_masks`` (with ``--amg``) and
``segment_objects`` (with ``--birefnet``), also of int8 encoders
(``--quantize``, ``--quantize-activations``) and of BiRefNet's int8
deformable gathers (``--int8-deform``), through the port's C library
with no Python in its process: the library dlopens
``libdlimgedit_tpu_torch_serving.so``
(``python -m dlimgedit_tpu_torch.native_build --serving``), whose C++
programs mirror the Python modules op for op (native/src/torch_programs.cpp).

The bundle holds, per canvas bucket (``ops/preprocess.py`` CANVAS_BUCKETS),
the programs ``serve_embed_<variant>_<bucket>`` (preprocess + encoder:
TinyViT for MobileSAM, a SAM ViT for vit_b / vit_l / vit_h),
``serve_decode_<variant>_<bucket>`` (one mask),
``serve_decode3_<variant>_<bucket>`` (three masks and their accuracies)
and, per ``--batch-sizes`` entry N, ``serve_decode_batch<N>_<variant>_
<bucket>`` (N prompts against one embedding, each mask ``compute_mask``'s
for its prompt: runtime/segmentation.py ``_build_batch_decode_fn``), with
``--amg grid:K`` ``serve_amg_<variant>_<bucket>`` (runtime/amg.py
``_build_amg_fn`` with K clamped to the grid's 3 * grid^2 candidates and
the pre-NMS pool of ``_prenms_pool``, as ``generate_masks`` keys it; no
region refinement), and per ``--birefnet kind:bucket`` entry
``serve_birefnet_<kind>_<bucket>`` (runtime/birefnet.py
``_build_birefnet_fn``: the canvas and its (h, w) to the (S, S) uint8
mask at the model's resolution S), each as
  <name>.spec.txt   one row per argument, then per output:
                      inw <dtype> <d0,d1,..> <state_dict name>   a weight
                      ind <dtype> <d0,d1,..>                     dynamic
                      out <dtype> <d0,d1,..>
  <name>.in<k>.npy  a sample value of the k-th dynamic argument
  <name>.out<i>.npy the port's Python path's outputs on those samples (the
                    environment's executables, as ``Segmentation`` runs them)
and, once for every program that names it, ``weights/<state_dict
name>.npy``: the loaded module's tensor after every load-time transform
(the compute-dtype cast, TinyViT's attention-bias index tables, a ViT
block's rel-pos gather index ``rel_pos_idx``; an int8 encoder's
``*.w_q`` or ``*.w_q8`` int8 (in, out), row-major, and ``*.w_scale``
float32 (out,), float32 also in a bf16 bundle), bf16 as its 16 bits (the
spec names the dtype); a BiRefNet's under ``birefnet.<kind>.``, with the
index tables its forward reads (``tables.rel_pos_index``, Swin's shift
masks ``tables.shift_mask.<pH>x<pW>``, the align-corners matrices
``tables.ac.<n_out>x<n_in>``), so that no program makes an index. Then
``serving.txt`` (format, variant, backend, image_size, buckets, batch
sizes, compute_dtype, decoder_heads, the encoder kind and its kernel
route, a ViT's geometry: num_heads, window_size, global_attn_indexes,
patch_size, layer_norm_eps; ``amg`` grid:K; ``birefnet``
kind:bucket:resolution and the BiRefNet's configuration rows; ``quant``
with the int8 options, as the JAX exporter spells it: ``w8`` (int8
weights, ``--quantize``), ``a8`` (int8 activations too,
``--quantize-activations``, which implies ``--quantize``), ``deform8``
(``--int8-deform``), comma-separated; parsed by native/src/bundle.hpp).
A ``gpu`` bundle also names the port's kernel
library in ``kernels_path.txt`` (built first, ops/cuda_build.py), as the
JAX bundle names its PJRT plugin in ``plugin_path.txt``, and has the
encoder's kernel route on.

Weights are random (seed 0) unless ``--models`` names a model directory
(``<dir>/segmentation/mobile_sam.npz`` or ``sam_vit_<b|l|h>.npz``, e.g.
from the converters; BiRefNet's
``<dir>/segmentation/birefnet_*.npz``). The int8 options set the
environment's ``Options`` (``quantize_encoder``, ``quantize_activations``,
``birefnet_int8_deform``): the weights are what the loaded module holds
after ``ops/quant.py::quantize_encoder``, and every recorded output is the
Python path's under those options.
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import DlimgError
from ..ops.preprocess import CANVAS_BUCKETS
from ..runtime import amg as amg_lib
from ..runtime import birefnet as birefnet_lib
from ..runtime.environment import Environment
from ..runtime.segmentation import (
    _build_batch_decode_fn,
    _build_decode_fn,
    _build_embed_fn,
    _to_host,
)
from ..types import Backend, Options

FORMAT = "dlimgedit_tpu_torch-serving-5"  # native/src/bundle.hpp kFormat

# The variants the route serves (models/sam.py make_config).
VARIANTS = ("mobile_sam", "vit_t", "vit_b", "vit_l", "vit_h")

# serve_amg's sample thresholds, in the C ABI's layout (iou, stability,
# nms, then no area filter and no region refinement), permissive so that
# the samples keep candidates.
AMG_SAMPLE_THRESHOLDS = (0.0, 0.0, 0.7, 0.0, 1.0, 0.0)

BIREFNET_KINDS = ("general", "high_res")

_NP_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
              torch.int64: "int64", torch.int32: "int32",
              torch.uint8: "uint8", torch.int8: "int8"}


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
    ap.add_argument("--batch-sizes", default="",
                    help="comma list of serve_decode_batch<N> sizes")
    ap.add_argument("--amg", default="",
                    help="grid:max_masks: serve_amg programs (generate_masks)")
    ap.add_argument("--birefnet", default="",
                    help="comma list of kind:bucket (general | high_res): "
                         "serve_birefnet programs (segment_objects)")
    ap.add_argument("--quantize", action="store_true",
                    help="int8 encoder weights (Options.quantize_encoder)")
    ap.add_argument("--quantize-activations", action="store_true",
                    help="s8 x s8 encoder linears "
                         "(Options.quantize_activations; implies --quantize)")
    ap.add_argument("--int8-deform", action="store_true",
                    help="BiRefNet's deformable convs gather from an int8 "
                         "stack (Options.birefnet_int8_deform)")
    return ap.parse_args(argv)


def _check_variant(args: argparse.Namespace) -> None:
    if args.variant not in VARIANTS:
        raise DlimgError(f"--variant {args.variant}: the Python-free route "
                         f"serves {', '.join(VARIANTS)}")


def quant_mode(args: argparse.Namespace) -> str:
    """The encoder's quantisation the arguments ask for, as
    ``SamModelBundle.quant`` names it."""
    return ("w8a8" if args.quantize_activations
            else "w8" if args.quantize else "none")


def quant_row(args: argparse.Namespace) -> str:
    """serving.txt's quant row, as the JAX exporter writes it ("" when no
    int8 option is on)."""
    modes = [m for m, on in (
        ("w8", args.quantize or args.quantize_activations),
        ("a8", args.quantize_activations),
        ("deform8", args.int8_deform)) if on]
    return f"quant\t{','.join(modes)}\n" if modes else ""


def parse_amg(text: str) -> Optional[Tuple[int, int]]:
    """--amg grid:max_masks -> (grid, max_masks clamped to the grid's
    3 * grid^2 candidates, as ``generate_masks`` clamps it), or None."""
    if not text:
        return None
    parts = text.split(":")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise DlimgError(f"--amg {text!r}: grid:max_masks, two positive "
                         f"integers")
    grid = int(parts[0])
    return grid, min(int(parts[1]), 3 * grid * grid)


def parse_birefnet(text: str) -> List[Tuple[str, int]]:
    """--birefnet kind:bucket,... -> [(kind, bucket)], in order, once each."""
    specs: List[Tuple[str, int]] = []
    for tok in (t.strip() for t in text.split(",")):
        if not tok:
            continue
        kind, _, bucket = tok.partition(":")
        if kind not in BIREFNET_KINDS or not bucket.isdigit() \
                or int(bucket) not in CANVAS_BUCKETS:
            raise DlimgError(f"--birefnet {text!r}: each entry is kind:bucket "
                             f"with kind one of {BIREFNET_KINDS} and bucket "
                             f"one of CANVAS_BUCKETS {CANVAS_BUCKETS}")
        if (kind, int(bucket)) not in specs:
            specs.append((kind, int(bucket)))
    return specs


def _buckets(text: str) -> List[int]:
    buckets = sorted({int(b) for b in text.split(",") if b.strip()})
    bad = [b for b in buckets if b not in CANVAS_BUCKETS]
    if not buckets or bad:
        raise DlimgError(f"--buckets {text!r}: each bucket must be one of "
                         f"CANVAS_BUCKETS {CANVAS_BUCKETS} (ops/preprocess.py "
                         f"pick_bucket)")
    return buckets


def _batch_sizes(text: str) -> List[int]:
    sizes = []
    for tok in (t.strip() for t in text.split(",")):
        if not tok:
            continue
        if not tok.isdigit() or int(tok) < 1:
            raise DlimgError(f"--batch-sizes {text!r}: each batch size must "
                             f"be a positive integer")
        sizes.append(int(tok))
    return sorted(set(sizes))


def _batch_prompts(nb: int, bucket: int):
    """The sample prompts of serve_decode_batch<nb>: JAX's mix, points at
    even slots and regions at odd ones (the JAX package's
    tools/aot_export.py)."""
    pts = np.zeros((nb, 2, 2), np.float32)
    lbl = np.full((nb, 2), -1.0, np.float32)
    for i in range(nb):
        if i % 2 == 0:
            pts[i, 0] = (bucket / 2 + i, bucket / 2)
            lbl[i] = (1.0, -1.0)
        else:
            pts[i] = ((bucket / 4, bucket / 4),
                      (3 * bucket / 4, 3 * bucket / 4))
            lbl[i] = (2.0, 3.0)
    return pts, lbl


def _encoder_rows(cfg) -> Tuple[str, bool]:
    """(serving.txt's encoder rows, whether the kernel route is on): the
    kind, its kernel route (``models/sam.py::with_kernels`` turns TinyViT's
    two flags on together, a ViT's one; its LayerNorms follow) and a
    ViT's geometry."""
    if cfg.encoder_tiny is not None:
        t = cfg.encoder_tiny
        if t.use_flash_attention != t.use_fused_norm:
            raise DlimgError("the Python-free route runs TinyViT's K1 and K2 "
                             "together (models/sam.py with_kernels): "
                             "use_flash_attention and use_fused_norm differ")
        return (f"encoder\ttinyvit\nkernel_route\t{int(t.use_fused_norm)}\n",
                t.use_fused_norm)
    v = cfg.encoder_vit
    if v.fused_window_blocks:
        raise DlimgError("fused_window_blocks: the Python-free route runs a "
                         "ViT's windows partitioned (K5); turn it off before "
                         "the export")
    return (f"encoder\tvit\n"
            f"kernel_route\t{int(v.use_flash_attention)}\n"
            f"num_heads\t{v.num_heads}\n"
            f"window_size\t{v.window_size}\n"
            f"global_attn_indexes\t"
            f"{','.join(map(str, v.global_attn_indexes))}\n"
            f"patch_size\t{v.patch_size}\n"
            f"layer_norm_eps\t{v.layer_norm_eps!r}\n",
            v.use_flash_attention)


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


def _birefnet_tables(cfg, device) -> Dict[str, torch.Tensor]:
    """The index tables a BiRefNet forward at ``cfg.img_size`` reads, from
    the model's own functions (the tensors the Python forward uses):
    Swin's relative-position index and shift masks at each stage's padded
    size, both passes, and the align-corners matrices of every resize of
    ``birefnet_apply``, named as the C++ looks them up."""
    from ..models import birefnet as birefnet_model
    from ..models import swin

    sw, S, w = cfg.swin, cfg.img_size, cfg.swin.window
    tables = {"tables.rel_pos_index": swin._rel_pos_index(w, device)}

    def pyramid(n: int) -> List[int]:
        h, sizes = n // sw.patch_size, []
        for i in range(4):
            if sw.depths[i] > 1 and w // 2 > 0:
                p = swin._padded(h, w)
                tables[f"tables.shift_mask.{p}x{p}"] = swin._shift_attn_mask(
                    p, p, w, w // 2, device)
            sizes.append(h)
            h = (h + h % 2) // 2
        return sizes

    def ac(n_out: int, n_in: int) -> None:
        if n_out != n_in:
            tables[f"tables.ac.{n_out}x{n_in}"] = birefnet_model._ac_matrix(
                n_out, n_in, device)

    f = pyramid(S)
    if cfg.mul_scl_ipt == "cat":
        ac(S // 2, S)
        for n_out, n_in in zip(f, pyramid(S // 2)):
            ac(n_out, n_in)
    if cfg.cxt_num:
        for n_in in f[:3]:
            ac(f[3], n_in)
    for n_out, n_in in ((f[2], f[3]), (f[1], f[2]), (f[0], f[1]), (S, f[0])):
        ac(n_out, n_in)
    return tables


def _birefnet_rows(cfg, programs: List[str]) -> str:
    """serving.txt's birefnet rows (native/src/bundle.hpp)."""
    sw = cfg.swin
    return (f"birefnet\t{','.join(programs)}\n"
            f"birefnet_embed_dim\t{sw.embed_dim}\n"
            f"birefnet_depths\t{','.join(map(str, sw.depths))}\n"
            f"birefnet_num_heads\t{','.join(map(str, sw.num_heads))}\n"
            f"birefnet_window\t{sw.window}\n"
            f"birefnet_patch_size\t{sw.patch_size}\n"
            f"birefnet_layer_norm_eps\t{sw.layer_norm_eps!r}\n"
            f"birefnet_decoder_channels\t{cfg.dec_inter_channels},"
            f"{cfg.aspp_channelster},{cfg.gdt_channels}\n"
            f"birefnet_aspp_kernel_sizes\t"
            f"{','.join(map(str, cfg.aspp_kernel_sizes))}\n"
            f"birefnet_mul_scl_ipt\t{cfg.mul_scl_ipt or 'none'}\n"
            f"birefnet_cxt_num\t{cfg.cxt_num}\n")


def export_birefnet(env: Environment, out: Path,
                    specs: List[Tuple[str, int]], stored: Dict[str, str],
                    rng: np.random.Generator, int8_deform: bool) -> str:
    """serve_birefnet_<kind>_<bucket> for each spec, on the environment's
    BiRefNet executables (runtime/birefnet.py birefnet_segment's keys);
    -> serving.txt's birefnet rows."""
    if env.mesh is not None:
        raise DlimgError("the Python-free route runs BiRefNet on one device: "
                         "export with scaleout_devices off")
    programs, shared = [], None
    for kind, bucket in specs:
        bb = env.birefnet_model(kind)
        if bb.cfg.deform_int8_gather != int8_deform:
            raise DlimgError(f"the {kind} BiRefNet's deform_int8_gather is "
                             f"{bb.cfg.deform_int8_gather}, --int8-deform "
                             f"{int8_deform}: export with the environment's "
                             f"options")
        cfg = dataclasses.replace(bb.cfg, img_size=0)
        if shared is not None and cfg != shared:
            raise DlimgError("the BiRefNet kinds of one bundle share one "
                             "configuration apart from the resolution")
        shared = cfg
        prefix = f"birefnet.{kind}."
        weights = {prefix + k: v
                   for k, v in (*_tensors(bb.model, ("",)).items(),
                                *_birefnet_tables(bb.cfg, env.device).items())}
        canvas = rng.integers(0, 256, (bucket, bucket, 3), dtype=np.uint8)
        sizes = np.array([(3 * bucket) // 4, bucket], np.int32)
        run = env.executable(
            ("birefnet", kind, bucket),
            lambda bb=bb, bucket=bucket: birefnet_lib._build_birefnet_fn(
                bb, bucket), birefnet_lib._to_host)
        mask = run(torch.from_numpy(canvas),
                   env.sizes_on_device(tuple(sizes)))
        write_program(out, f"serve_birefnet_{kind}_{bucket}", weights,
                      [canvas, sizes], [mask], stored)
        programs.append(f"{kind}:{bucket}:{bb.resolution}")
    return _birefnet_rows(bb.cfg, programs)


def make_environment(args: argparse.Namespace) -> Environment:
    extra = ({"sam_image_size": args.sam_image_size}
             if args.sam_image_size else {})
    return Environment(Options(
        backend=Backend.cpu if args.backend == "cpu" else Backend.gpu,
        model_directory=args.models or "models",
        allow_random_weights=not args.models,
        compute_dtype=args.compute_dtype, sam_variant=args.variant,
        quantize_encoder=args.quantize or args.quantize_activations,
        quantize_activations=args.quantize_activations,
        birefnet_int8_deform=args.int8_deform, **extra))


def export_serving(args: argparse.Namespace,
                   env: Optional[Environment] = None) -> Environment:
    """Write the bundle into ``args.out``; -> the environment whose
    executables computed the sample outputs (``env`` when given: its
    options must be the arguments')."""
    _check_variant(args)
    buckets = _buckets(args.buckets)
    batch_sizes = _batch_sizes(args.batch_sizes)
    amg = parse_amg(args.amg)
    birefnet_specs = parse_birefnet(args.birefnet)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for stale in [*out.glob("serve_*"), out / "serving.txt",
                  out / "kernels_path.txt"]:
        stale.unlink(missing_ok=True)
    shutil.rmtree(out / "weights", ignore_errors=True)
    (out / "weights").mkdir()
    env = env if env is not None else make_environment(args)
    variant = "mobile_sam" if args.variant == "vit_t" else args.variant
    bundle = env.sam_model(variant)
    if bundle.quant != quant_mode(args):
        raise DlimgError(f"the encoder is quantised {bundle.quant!r}, the "
                         f"arguments ask for {quant_mode(args)!r}: export "
                         f"with the environment's options")
    encoder_rows, route_on = _encoder_rows(bundle.cfg)
    if args.backend == "gpu" and not route_on:
        raise DlimgError("a gpu bundle runs the encoder's kernels: its "
                         "config has the kernel route off")
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
        for nb in batch_sizes:
            bpts, blbl = _batch_prompts(nb, b)
            decode = env.executable(
                ("decode_batch", variant, b, nb, False),
                lambda: _build_batch_decode_fn(bundle, b), _to_host)
            packed, iou = decode(emb, torch.from_numpy(bpts),
                                 torch.from_numpy(blbl),
                                 env.sizes_on_device(tuple(sizes)))
            write_program(out, f"serve_decode_batch{nb}_{variant}_{b}",
                          decoder, [emb, bpts, blbl, sizes], [packed, iou],
                          stored)
        if amg:
            write_amg(env, bundle, out, variant, b, amg, emb, sizes, decoder,
                      stored)
    amg_row = f"amg\t{amg[0]}:{amg[1]}\n" if amg else ""
    birefnet_rows = (export_birefnet(env, out, birefnet_specs, stored, rng,
                                     args.int8_deform)
                     if birefnet_specs else "")
    (out / "serving.txt").write_text(
        f"format\t{FORMAT}\n"
        f"variant\t{variant}\n"
        f"backend\t{args.backend}\n"
        f"image_size\t{image_size}\n"
        f"buckets\t{','.join(map(str, buckets))}\n"
        f"batch\t{','.join(map(str, batch_sizes))}\n"
        f"compute_dtype\t{args.compute_dtype}\n"
        f"decoder_heads\t{bundle.cfg.decoder.num_heads}\n"
        f"{encoder_rows}{amg_row}{birefnet_rows}{quant_row(args)}")
    return env


def write_amg(env: Environment, bundle, out: Path, variant: str, b: int,
              amg: Tuple[int, int], emb: torch.Tensor, sizes: np.ndarray,
              decoder: Dict[str, torch.Tensor],
              stored: Dict[str, str]) -> None:
    """serve_amg_<variant>_<b> on the executable ``generate_masks`` keys,
    with the pool of ``_prenms_pool``."""
    grid, k = amg
    prenms = amg_lib._prenms_pool(grid * grid, k)
    fn = env.executable(
        ("amg", variant, b, grid, k, prenms, False),
        lambda: amg_lib._build_amg_fn(bundle, b, grid, k, prenms),
        amg_lib._to_host)
    outs = fn(emb, env.sizes_on_device(tuple(sizes)),
              env.floats_on_device(AMG_SAMPLE_THRESHOLDS))
    write_program(out, f"serve_amg_{variant}_{b}", decoder,
                  [emb, sizes, np.array(AMG_SAMPLE_THRESHOLDS, np.float32)],
                  outs, stored)


def main(argv: Optional[Sequence[str]] = None) -> int:
    export_serving(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
