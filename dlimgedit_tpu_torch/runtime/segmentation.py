"""Interactive segmentation: embed once, query masks cheaply (counterpart of
dlimgedit_tpu/runtime/segmentation.py).

  * `process`      — pack + copy the canvas, `sam_preprocess` (resize,
                     normalise, pad on the device) and the variant's image
                     encoder (TinyViT for MobileSAM, or a SAM ViT).
                     The embedding STAYS ON THE DEVICE.
  * `compute_mask` — prompt encoder + two-way decoder + upsample to the
                     original size + threshold + bit-pack. Only the packed
                     mask and the IoU scores cross back to the host, in one
                     copy each.
  * `generate_masks` — every object's mask (runtime/amg.py).
  * `segment_objects` — BiRefNet's foreground mask (runtime/birefnet.py).

One executable per (program, variant, canvas bucket, ...) key, as in the
JAX package; on CUDA each is a CUDA graph (``Environment.executable``), or
two with the component labelling run eagerly between them.
The canvas is packed straight into the embed graph's static canvas; the
embedding a `process` returns is a clone of the graph's static output, so
a later `process` in the same bucket does not overwrite it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..image.resize import resize_longest_side_extent, transform_point
from ..models import sam as sam_lib
from ..ops.connected import largest_component_mask
from ..ops.postprocess import (
    pack_mask_bits,
    unpack_mask_bits,
    upsample_mask_logits,
    upsample_matrices,
    upsample_with,
)
from ..ops.preprocess import (
    pack_and_put_canvas,
    pick_bucket,
    resolve_h2d_chunks,
    sam_preprocess,
)
from ..types import Channels, Extent, Image, ImageView, Point, Region
from .birefnet import birefnet_segment
from .environment import Environment


@dataclass
class Mask:
    """A binary mask for a single object."""

    image: Image
    accuracy: float = 0.0


def _build_embed_fn(bundle, mesh=None):
    """Preprocess + image encoder. With ``mesh`` (Options.scaleout_devices)
    a ViT encoder runs sequence-parallel over its ('sp',) axis
    (parallel/sp.py), TinyViT on canvas-row bands (parallel/spatial.py),
    and the embedding lands on the mesh's first device, so every decode
    program downstream is unchanged."""
    cfg = bundle.cfg

    def run(canvas, sizes):
        x = sam_preprocess(canvas, sizes[0], sizes[1], sizes[2], sizes[3],
                           image_size=cfg.image_size,
                           compute_dtype=bundle.compute_dtype)
        if mesh is not None and cfg.encoder_vit is not None:
            from ..parallel.sp import sam_vit_apply_sp

            emb = sam_vit_apply_sp(bundle.model.encoder, x, cfg.encoder_vit,
                                   mesh)
        elif mesh is not None:
            from ..parallel.spatial import tinyvit_apply_spatial

            emb = tinyvit_apply_spatial(bundle.model.encoder, x,
                                        cfg.encoder_tiny, mesh)
        else:
            emb = sam_lib.encode_image(bundle.model, cfg, x)
        return emb.float()

    return run


_FORKS = threading.local()


def _each_prompt(n: int, device: torch.device, fn: Callable[[int], Any]) -> list:
    """[fn(i) for i < n]. On the card each call runs on a stream of its
    own, forked from the current stream and joined back to it: the same
    operations as the loop, but as parallel branches of a CUDA graph (or
    concurrent eager work) rather than one chain. The streams are this
    thread's: a stream in a capture may carry no other thread's work."""
    if device.type != "cuda":
        return [fn(i) for i in range(n)]
    pools = getattr(_FORKS, "pools", None)
    if pools is None:
        pools = _FORKS.pools = {}
    streams = pools.setdefault(device, [])
    while len(streams) < n:
        streams.append(torch.cuda.Stream(device))
    main = torch.cuda.current_stream(device)
    out = []
    for i, stream in enumerate(streams[:n]):
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            out.append(fn(i))
    for stream in streams[:n]:
        main.wait_stream(stream)
    return out


def _build_batch_decode_fn(bundle, out_bucket: int,
                           largest_component: bool = False):
    """N prompts against ONE cached embedding, each mask byte-equal to
    `compute_mask`'s for its prompt, whatever else shares the batch (JAX's
    contract, tests/test_segmentation.py::
    test_compute_mask_batch_matches_individual). On the card a product
    over N prompts' rows can take another kernel at each N, and so sum a
    row in another order; so the image's part of the decoder
    (``sam.decode_context``: the keys and block 0's projections of them)
    is made once, and each prompt is decoded and upsampled on its own with
    the operations and shapes `compute_mask` runs, in the one program
    (on the card as parallel branches of its graph, ``_each_prompt``).
    With `largest_component`, region prompts (first label 2.0, the box
    top-left) keep only their largest connected object; point prompts
    (label 1.0) are untouched. The labelling reads the device from the
    host, so that program is (decode, label, finish): the labelling runs
    between two graphs."""
    cfg = bundle.cfg

    def decode(emb, points, labels, sizes):
        ctx = sam_lib.decode_context(bundle.model, cfg, emb)
        one = _each_prompt(points.shape[0], emb.device, lambda i: (
            sam_lib.decode_prompts(bundle.model, cfg, ctx, points[i:i + 1],
                                   labels[i:i + 1], multimask=False)))
        masks = torch.cat([m[:, 0] for m, _ in one])  # (N, L, L)
        iou = torch.cat([q[:, 0] for _, q in one])  # (N,)
        return masks, iou, labels, sizes

    def pack(m, iou, sizes):
        R, C = upsample_matrices(m.shape[-1], out_bucket, cfg.image_size,
                                 sizes[0], sizes[1], sizes[2], sizes[3],
                                 m.device)
        return torch.cat(_each_prompt(m.shape[0], m.device, lambda i: (
            pack_mask_bits(upsample_with(R, C, m[i:i + 1][None])).reshape(-1)
        ))), iou

    def label(m, iou, labels, sizes):
        return m, largest_component_mask(m > 0), iou, labels, sizes

    def finish(m, keep, iou, labels, sizes):
        is_region = (labels[:, 0] == 2.0)[:, None, None]
        return pack(torch.where(is_region & ~keep, -10.0, m), iou, sizes)

    if largest_component:
        return decode, label, finish

    def run(emb, points, labels, sizes):
        m, iou, _, _ = decode(emb, points, labels, sizes)
        return pack(m, iou, sizes)

    return run


def _build_decode_fn(bundle, out_bucket: int, multimask: bool,
                     largest_component: bool):
    """One prompt; with `largest_component` the program is (decode, label,
    finish), as in `_build_batch_decode_fn`."""
    cfg = bundle.cfg

    def decode(emb, points, labels, sizes):
        masks, iou = sam_lib.decode_masks(bundle.model, cfg, emb, points,
                                          labels, multimask=multimask)
        if multimask:
            # The reference consumes decoder tokens 1..3.
            masks = masks[:, 1:4]
            iou = iou[:, 1:4]
        return masks, iou, sizes

    def pack(masks, iou, sizes):
        logits = upsample_mask_logits(masks, out_bucket, cfg.image_size,
                                      sizes[0], sizes[1], sizes[2], sizes[3])
        return pack_mask_bits(logits)[0].reshape(-1), iou[0]

    def label(masks, iou, sizes):
        B, T, L, _ = masks.shape
        keep = largest_component_mask(masks.reshape(B * T, L, L) > 0)
        return masks, keep.reshape(B, T, L, L), iou, sizes

    def finish(masks, keep, iou, sizes):
        return pack(torch.where(keep, masks, -10.0), iou, sizes)

    if largest_component:
        return decode, label, finish

    def run(emb, points, labels, sizes):
        return pack(*decode(emb, points, labels, sizes))

    return run


def _to_host(outputs: Tuple[torch.Tensor, torch.Tensor]
             ) -> Tuple[np.ndarray, np.ndarray]:
    packed, iou = outputs
    return packed.cpu().numpy(), iou.float().cpu().numpy()


class Segmentation:
    """Holds a processed image embedding; queries masks for prompts."""

    def __init__(self, env: Environment, variant: str, embedding,
                 original: Extent, scale: float, crop: Tuple[int, int]):
        self._env = env
        self._variant = variant
        self._embedding = embedding  # (1, He, We, C) float32, on the device
        self._original = original
        self._scale = scale
        self._crop = crop  # (crop_h, crop_w) = resize-longest-side extent

    # -- construction ---------------------------------------------------------

    @staticmethod
    def process(img: Union[Image, ImageView], env: Environment,
                variant: Optional[str] = None) -> "Segmentation":
        """Embed an image (the expensive step). Returns once the work is
        queued on the device."""
        view = img.view() if isinstance(img, Image) else img
        variant = variant or env.options.sam_variant
        bundle = env.sam_model(variant)
        cfg = bundle.cfg
        extent = view.extent
        target, scale = resize_longest_side_extent(extent, cfg.image_size)
        if env.options.preprocess_mode == "host":
            # Reference-exact numerics: stb-semantics resize on the host; the
            # device resample is then an identity over the valid region.
            # Bucket by the RESIZED extent (the canvas only holds that).
            from ..image.resize import resize as host_resize

            if target != extent:
                view = host_resize(view, target).view()
            bucket = pick_bucket(view.extent)
            sizes = (view.extent.height, view.extent.width,
                     target.height, target.width)
        else:
            bucket = pick_bucket(extent)
            sizes = (extent.height, extent.width, target.height, target.width)
        # Over a mesh the program crosses devices: eager, not a graph.
        embed = env.executable(("embed", variant, bucket, bundle.quant),
                               lambda: _build_embed_fn(bundle, env.mesh),
                               torch.Tensor.clone,
                               graphed=env.mesh is None)
        with embed.lock:  # the static canvas is the graph's input
            canvas = pack_and_put_canvas(
                view, bucket, env.device, pool=env.canvas_pool,
                n_chunks=resolve_h2d_chunks(env.options.h2d_overlap_chunks),
                out=embed.input_buffer(0))
            emb = embed(canvas, env.sizes_on_device(sizes))
        return Segmentation(env, variant, emb, extent, scale,
                            (target.height, target.width))

    # -- queries ---------------------------------------------------------------

    @property
    def extent(self) -> Extent:
        return self._original

    @property
    def embedding(self) -> torch.Tensor:
        """The on-device image embedding (1, He, We, C)."""
        return self._embedding

    def _prompt_arrays(self, point: Optional[Point], region: Optional[Region]):
        """The 2-point prompt protocol of the reference."""
        points = np.zeros((1, 2, 2), np.float32)
        labels = np.zeros((1, 2), np.float32)
        if point is not None:
            x, y = transform_point(point.x, point.y, self._scale)
            points[0, 0] = (x, y)
            labels[0, 0] = 1.0
            points[0, 1] = (0.0, 0.0)
            labels[0, 1] = -1.0
        else:
            assert region is not None
            tlx, tly = transform_point(region.top_left.x, region.top_left.y,
                                       self._scale)
            brx, bry = transform_point(region.bottom_right.x,
                                       region.bottom_right.y, self._scale)
            points[0, 0] = (tlx, tly)
            labels[0, 0] = 2.0
            points[0, 1] = (brx, bry)
            labels[0, 1] = 3.0
        return points, labels

    def _sizes(self) -> torch.Tensor:
        return self._env.sizes_on_device((self._original.height,
                                          self._original.width,
                                          self._crop[0], self._crop[1]))

    def _unpack(self, packed: np.ndarray, bucket: int) -> np.ndarray:
        packed = packed.reshape(-1, bucket, bucket // 8)
        return unpack_mask_bits(packed[:, :self._original.height, :], bucket)

    def _decode(self, point: Optional[Point], region: Optional[Region],
                multimask: bool, largest_component: bool = False):
        env = self._env
        bundle = env.sam_model(self._variant)
        bucket = pick_bucket(self._original)
        points, labels = self._prompt_arrays(point, region)
        decode = env.executable(
            ("decode", self._variant, bucket, multimask, largest_component),
            lambda: _build_decode_fn(bundle, bucket, multimask,
                                     largest_component), _to_host)
        packed, iou = decode(self._embedding, torch.from_numpy(points),
                             torch.from_numpy(labels), self._sizes())
        return self._unpack(packed, bucket), iou

    def _to_mask_image(self, mask_canvas: np.ndarray) -> Image:
        h, w = self._original.height, self._original.width
        return Image(self._original, Channels.mask, mask_canvas[:h, :w])

    def compute_mask(self, prompt: Union[Point, Region],
                     largest_component: Optional[bool] = None) -> Image:
        """Single best mask for a point or region prompt. For Region prompts,
        `largest_component` (default: the environment's option) keeps only
        the largest connected object inside the box."""
        is_region = isinstance(prompt, Region)
        if largest_component is None:
            largest_component = (is_region
                                 and self._env.options.largest_region_object)
        masks, _ = self._decode(
            None if is_region else prompt,
            prompt if is_region else None,
            multimask=False, largest_component=largest_component)
        return self._to_mask_image(masks[0])

    def compute_masks(self, point: Point) -> List[Mask]:
        """Three candidate masks with confidences."""
        masks, iou = self._decode(point, None, multimask=True)
        return [Mask(self._to_mask_image(masks[i]), float(iou[i]))
                for i in range(3)]

    def compute_mask_batch(self, prompts: List[Union[Point, Region]]
                           ) -> List[Mask]:
        """Decode MANY prompts against the cached embedding in one program.
        Returns the single best mask per prompt. The prompt count is padded
        to a power of two so executables are reused across batch sizes."""
        env = self._env
        bundle = env.sam_model(self._variant)
        n = len(prompts)
        if n == 0:
            return []
        padded = 1
        while padded < n:
            padded *= 2
        points = np.zeros((padded, 2, 2), np.float32)
        labels = np.full((padded, 2), -1.0, np.float32)
        for i, pr in enumerate(prompts):
            if isinstance(pr, Region):
                p, lab = self._prompt_arrays(None, pr)
            else:
                p, lab = self._prompt_arrays(pr, None)
            points[i] = p[0]
            labels[i] = lab[0]
        bucket = pick_bucket(self._original)
        lcc = (env.options.largest_region_object
               and any(isinstance(pr, Region) for pr in prompts))
        decode = env.executable(
            ("decode_batch", self._variant, bucket, padded, lcc),
            lambda: _build_batch_decode_fn(bundle, bucket,
                                           largest_component=lcc), _to_host)
        packed, iou = decode(self._embedding, torch.from_numpy(points),
                             torch.from_numpy(labels), self._sizes())
        mask_u8 = self._unpack(packed, bucket)
        return [Mask(self._to_mask_image(mask_u8[i]), float(iou[i]))
                for i in range(n)]

    def generate_masks(self, grid: int = 32, max_masks: int = 64,
                       iou_thresh: float = 0.88,
                       stability_thresh: float = 0.95,
                       nms_thresh: float = 0.7,
                       min_area_frac: float = 0.0,
                       max_area_frac: float = 1.0,
                       min_mask_region_area: int = 0) -> List[Mask]:
        """Segment everything: masks for all objects, best-first.

        Upstream SAM's automatic mask generator (point grid -> multimask
        decode -> IoU / stability / area filter -> greedy box NMS) as one
        program against the cached embedding, one CUDA graph on the card
        (runtime/amg.py). The thresholds are a device vector: tuning them
        reuses the graph.

        grid: points per side of the prompt grid (grid^2 prompts, 3
        candidate masks each). max_masks: output slots; fewer may return.
        Masks are sorted by predicted IoU (Mask.accuracy).
        min_mask_region_area (original-image px, upstream's parameter):
        fill holes / drop islands smaller than this. For multi-crop
        generation use the module-level generate_masks_image: it needs the
        pixels, which a Segmentation no longer holds."""
        from .amg import generate_masks as _amg

        return _amg(self, grid=grid, max_masks=max_masks,
                    iou_thresh=iou_thresh,
                    stability_thresh=stability_thresh,
                    nms_thresh=nms_thresh, min_area_frac=min_area_frac,
                    max_area_frac=max_area_frac,
                    min_mask_region_area=min_mask_region_area)


def segment_objects(img: Union[Image, ImageView], env: Environment) -> Image:
    """Dichotomous foreground segmentation (BiRefNet; runtime/birefnet.py):
    a uint8 foreground mask at the image's extent."""
    view = img.view() if isinstance(img, Image) else img
    return birefnet_segment(env, view)
