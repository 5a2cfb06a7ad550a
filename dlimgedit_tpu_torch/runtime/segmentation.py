"""Interactive segmentation: embed once, query masks cheaply (counterpart of
dlimgedit_tpu/runtime/segmentation.py).

  * `process`      — pack + copy the canvas, `sam_preprocess` (resize,
                     normalise, pad on the device) and the TinyViT encoder.
                     The embedding STAYS ON THE DEVICE.
  * `compute_mask` — prompt encoder + two-way decoder + upsample to the
                     original size + threshold + bit-pack. Only the packed
                     mask and the IoU scores cross back to the host, in one
                     copy each.

One executable per (program, variant, canvas bucket, ...) key, as in the
JAX package; here each is an eager PyTorch callable.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..errors import not_in_this_slice
from ..image.resize import resize_longest_side_extent, transform_point
from ..models import sam as sam_lib
from ..ops.connected import largest_component_mask
from ..ops.postprocess import pack_mask_bits, unpack_mask_bits, upsample_mask_logits
from ..ops.preprocess import (
    pack_and_put_canvas,
    pick_bucket,
    resolve_h2d_chunks,
    sam_preprocess,
)
from ..types import Channels, Extent, Image, ImageView, Point, Region
from .environment import Environment


@dataclass
class Mask:
    """A binary mask for a single object."""

    image: Image
    accuracy: float = 0.0


def _build_embed_fn(bundle):
    """Preprocess + image encoder."""
    cfg = bundle.cfg

    def run(canvas, sizes):
        x = sam_preprocess(canvas, sizes[0], sizes[1], sizes[2], sizes[3],
                           image_size=cfg.image_size,
                           compute_dtype=bundle.compute_dtype)
        return sam_lib.encode_image(bundle.model, cfg, x).float()

    return run


def _build_batch_decode_fn(bundle, out_bucket: int,
                           largest_component: bool = False):
    """N prompts against ONE cached embedding. With `largest_component`,
    region prompts (first label 2.0, the box top-left) keep only their
    largest connected object; point prompts (label 1.0) are untouched."""
    cfg = bundle.cfg

    def run(emb, points, labels, sizes):
        n = points.shape[0]
        masks, iou = sam_lib.decode_masks(bundle.model, cfg,
                                          emb.expand(n, *emb.shape[1:]),
                                          points, labels, multimask=False)
        m = masks[:, 0]  # (N, L, L)
        if largest_component:
            keep = largest_component_mask(m > 0)
            is_region = (labels[:, 0] == 2.0)[:, None, None]
            m = torch.where(is_region & ~keep, -10.0, m)
        logits = upsample_mask_logits(m[None], out_bucket, cfg.image_size,
                                      sizes[0], sizes[1], sizes[2], sizes[3])
        return pack_mask_bits(logits)[0].reshape(-1), iou[:, 0]

    return run


def _build_decode_fn(bundle, out_bucket: int, multimask: bool,
                     largest_component: bool):
    cfg = bundle.cfg

    def run(emb, points, labels, sizes):
        masks, iou = sam_lib.decode_masks(bundle.model, cfg, emb, points,
                                          labels, multimask=multimask)
        if multimask:
            # The reference consumes decoder tokens 1..3.
            masks = masks[:, 1:4]
            iou = iou[:, 1:4]
        if largest_component:
            B, T, L, _ = masks.shape
            keep = largest_component_mask(masks.reshape(B * T, L, L) > 0)
            masks = torch.where(keep.reshape(B, T, L, L), masks, -10.0)
        logits = upsample_mask_logits(masks, out_bucket, cfg.image_size,
                                      sizes[0], sizes[1], sizes[2], sizes[3])
        return pack_mask_bits(logits)[0].reshape(-1), iou[0]

    return run


def _to_host(packed: torch.Tensor, iou: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
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
        embed = env.executable(("embed", variant, bucket),
                               lambda: _build_embed_fn(bundle))
        canvas = pack_and_put_canvas(
            view, bucket, env.device, pool=env.canvas_pool,
            n_chunks=resolve_h2d_chunks(env.options.h2d_overlap_chunks))
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
                                     largest_component))
        dev = env.device
        packed, iou = _to_host(*decode(
            self._embedding, torch.from_numpy(points).to(dev),
            torch.from_numpy(labels).to(dev), self._sizes()))
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
                                           largest_component=lcc))
        dev = env.device
        packed, iou = _to_host(*decode(
            self._embedding, torch.from_numpy(points).to(dev),
            torch.from_numpy(labels).to(dev), self._sizes()))
        mask_u8 = self._unpack(packed, bucket)
        return [Mask(self._to_mask_image(mask_u8[i]), float(iou[i]))
                for i in range(n)]

    def generate_masks(self, *args, **kwargs) -> List[Mask]:
        """Automatic mask generation: not in this slice of the port."""
        raise not_in_this_slice("Segmentation.generate_masks", "AMG")


def segment_objects(img: Union[Image, ImageView], env: Environment) -> Image:
    """Dichotomous foreground segmentation (BiRefNet): not in this slice."""
    raise not_in_this_slice("segment_objects", "BiRefNet")


def generate_masks_image(*args, **kwargs):
    """Multi-crop automatic mask generation: not in this slice."""
    raise not_in_this_slice("generate_masks_image", "AMG")
