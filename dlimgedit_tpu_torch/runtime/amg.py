"""Automatic mask generation: every object mask of an image in one program
(counterpart of dlimgedit_tpu/runtime/amg.py).

One executable per (variant, bucket, grid, max_masks, pre-NMS pool,
refine) key; on the card one CUDA graph (``Environment.executable``):

  pass A  - a static loop over point-grid chunks: batched multimask
            decodes against the cached embedding; only per-candidate
            statistics (predicted IoU, stability, area, low-res box)
            leave a chunk (``amg_candidates``).
  filter  - IoU / stability / area thresholds, read from a device vector
            (a static input of the graph: changing a threshold reuses the
            graph); a candidate that fails gets score -1.
  NMS     - exact greedy box NMS over the top-P pool (``ops/amg.py``: one
            CUDA kernel on the card), then the top-K winners.
  pass B  - re-decode only the K winners, upsample to the canvas bucket,
            bit-pack.

Top-k is a stable descending sort and a slice, so ties keep the lower
index first, as ``lax.top_k`` does. With ``min_mask_region_area`` the
program is (head, between, tail): the small-region filter's labelling
reads the device from the host, so it runs eagerly between two graphs.
One copy out: packed masks and scores reach the host together.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ..ops.amg import (
    greedy_nms,
    mask_boxes,
    point_grid,
    refine_mask_logits,
    stability_scores,
)
from ..ops.postprocess import pack_mask_bits, unpack_mask_bits, upsample_mask_logits
from ..parallel.batch import decode_prompt_batch


def _chunk_size(total: int, cap: int = 64) -> int:
    """Largest divisor of `total` that is <= cap (pass-A chunk length)."""
    c = min(cap, total)
    while total % c:
        c -= 1
    return c


def _prenms_pool(G: int, max_masks: int) -> int:
    """Pre-NMS pool size for a grid of G points (3G candidates): at least
    3/4 of the candidates, floored at 256 and at 4x the winner count."""
    return min(3 * G, max(256, 3 * G * 3 // 4, 4 * max_masks))


def _grid_and_valid(cfg, sizes: torch.Tensor, grid: int):
    """The (G, 2) prompt grid in model-input pixels, and the (L, L) low-res
    pixels whose centres fall inside the resize-longest-side crop (which
    keeps the padding out of every statistic)."""
    L = cfg.mask_input_size
    crop_h, crop_w = sizes[2], sizes[3]
    pts = point_grid(grid, crop_w, crop_h)
    centre = ((torch.arange(L, dtype=torch.float32, device=sizes.device) + 0.5)
              * (cfg.image_size / L))
    valid = ((centre[:, None] < crop_h.float())
             & (centre[None, :] < crop_w.float()))
    return pts, valid


def _decode3(bundle, emb: torch.Tensor, pts: torch.Tensor):
    """N positive-point prompts (each with the (0, 0) pad point, label -1)
    -> tokens 1..3: (N, 3, L, L) logits, (N, 3) predicted IoU."""
    n = pts.shape[0]
    coords = torch.stack([pts, torch.zeros_like(pts)], dim=1)  # (N, 2, 2)
    labels = torch.ones((n, 2), dtype=torch.float32, device=pts.device)
    labels[:, 1].fill_(-1.0)  # a fill kernel, not a host copy
    m, iou = decode_prompt_batch(bundle.model, bundle.cfg, emb, coords, labels,
                                 multimask=True)
    # The reference consumes decoder tokens 1..3.
    return m[:, 1:4], iou[:, 1:4]


def _pass_a(bundle, emb, pts, valid):
    """Per-candidate (iou, stability, area, box) of every grid point's three
    masks, candidate index = point * 3 + token, chunk by chunk."""
    G = pts.shape[0]
    chunk = _chunk_size(G)
    stats = []
    for c in range(G // chunk):
        m, iou = _decode3(bundle, emb, pts[c * chunk:(c + 1) * chunk])
        binary = (m > 0) & valid
        stats.append((iou, stability_scores(m, valid),
                      binary.sum(dim=(-1, -2)).float(), mask_boxes(binary)))
    iou, stab, area, boxes = (torch.cat(t) for t in zip(*stats))
    return iou.reshape(-1), stab.reshape(-1), area.reshape(-1), boxes.reshape(-1, 4)


def amg_candidates(bundle, emb: torch.Tensor, sizes: torch.Tensor, grid: int):
    """Pass A's statistics of all 3 * grid^2 candidates: (iou, stability,
    area) (3G,) and boxes (3G, 4) at the low-res mask grid. The AMG program
    runs this; tests and chip_smoke.py call it to mirror the selection."""
    pts, valid = _grid_and_valid(bundle.cfg, sizes, grid)
    return _pass_a(bundle, emb, pts, valid)


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, descending, the lower index first on
    ties (a stable sort; ``torch.topk`` promises no tie order)."""
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


def amg_pool(iou, stab, area, boxes, valid, thr, prenms: int):
    """Filter, then the pre-NMS pool: (boxes, scores, candidate ids) of the
    top-``prenms`` candidates by score, score -1 where a filter failed."""
    valid_area = valid.sum().float()
    ok = ((iou >= thr[0]) & (stab >= thr[1])
          & (area >= torch.clamp(thr[3] * valid_area, min=1.0))
          & (area <= thr[4] * valid_area))
    sc_p, idx_p = _top_k(torch.where(ok, iou, -1.0), prenms)
    return boxes[idx_p], sc_p, idx_p


def _select(iou, stab, area, boxes, valid, thr, prenms: int, max_masks: int):
    """-> (winner scores (K,), winner candidate ids (K,)), best first."""
    boxes_p, sc_p, idx_p = amg_pool(iou, stab, area, boxes, valid, thr, prenms)
    keep = greedy_nms(boxes_p, sc_p, thr[2:3])
    sc_f, j = _top_k(torch.where(keep, sc_p, -1.0), max_masks)
    return sc_f, idx_p[j]


def _build_amg_fn(bundle, out_bucket: int, grid: int, max_masks: int,
                  prenms: int, refine: bool = False):
    """The AMG program on (embedding, sizes, thresholds): one callable, or
    (head, between, tail) with the small-region filter. sizes: (orig_h,
    orig_w, crop_h, crop_w) int32; thresholds: (iou, stability, nms,
    min_area_frac, max_area_frac, min_region_area_lowres) float32."""
    cfg = bundle.cfg

    def head(emb, sizes, thr):
        pts, valid = _grid_and_valid(cfg, sizes, grid)
        iou, stab, area, boxes = _pass_a(bundle, emb, pts, valid)
        sc_f, win = _select(iou, stab, area, boxes, valid, thr, prenms,
                            max_masks)
        # Pass B: re-decode only the winners; select each one's token.
        m3, _ = _decode3(bundle, emb, pts[win // 3])
        m = torch.take_along_dim(m3, (win % 3)[:, None, None, None], dim=1)[:, 0]
        return m, valid, thr, sizes, sc_f, stab[win], area[win]

    def between(m, valid, thr, sizes, sc_f, stab_w, area_w):
        return refine_mask_logits(m, valid, thr[5]), sizes, sc_f, stab_w, area_w

    def tail(m, sizes, sc_f, stab_w, area_w):
        logits = upsample_mask_logits(m[None], out_bucket, cfg.image_size,
                                      sizes[0], sizes[1], sizes[2], sizes[3])
        # Flat packed output, as the decode programs give it.
        return pack_mask_bits(logits)[0].reshape(-1), sc_f, stab_w, area_w

    if refine:
        return head, between, tail

    def run(emb, sizes, thr):
        m, _, _, sizes, sc_f, stab_w, area_w = head(emb, sizes, thr)
        return tail(m, sizes, sc_f, stab_w, area_w)

    return run


def _to_host(outputs) -> Tuple[np.ndarray, ...]:
    """Packed masks, scores, stabilities and areas, to the host."""
    return tuple(t.cpu().numpy() for t in outputs)


def generate_masks(seg, grid: int = 32, max_masks: int = 64,
                   iou_thresh: float = 0.88, stability_thresh: float = 0.95,
                   nms_thresh: float = 0.7, min_area_frac: float = 0.0,
                   max_area_frac: float = 1.0,
                   min_mask_region_area: int = 0) -> List:
    """Segment everything: List[Mask], best-first (see the Segmentation
    method). Only the top ``_prenms_pool`` candidates by score enter NMS.
    Masks whose PREDICTED IoU is <= 0 are always dropped, even with
    iou_thresh <= 0 (the score <= 0 validity gate of the NMS)."""
    from ..ops.preprocess import pick_bucket
    from .segmentation import Mask

    env = seg._env
    bundle = env.sam_model(seg._variant)
    cfg = bundle.cfg
    bucket = pick_bucket(seg._original)
    G = grid * grid
    # K cannot exceed the candidates, and the pool holds at least K.
    max_masks = min(max_masks, 3 * G)
    prenms = _prenms_pool(G, max_masks)
    refine = min_mask_region_area > 0
    # The area threshold in LOW-RES pixels: original px -> model-input px
    # is seg._scale, model input -> low-res grid L / image_size.
    lr_factor = seg._scale * cfg.mask_input_size / cfg.image_size
    min_area_lr = float(min_mask_region_area) * lr_factor * lr_factor
    fn = env.executable(
        ("amg", seg._variant, bucket, grid, max_masks, prenms, refine),
        lambda: _build_amg_fn(bundle, bucket, grid, max_masks, prenms, refine),
        _to_host)
    thr = env.floats_on_device((iou_thresh, stability_thresh, nms_thresh,
                                min_area_frac, max_area_frac, min_area_lr))
    packed, score, _, _ = fn(seg._embedding, seg._sizes(), thr)
    mask_u8 = seg._unpack(packed, bucket)
    out = []
    for i in range(max_masks):
        if score[i] <= 0.0:
            break  # sorted descending: the rest are invalid pads, or masks
            # the decoder itself rated <= 0
        out.append(Mask(seg._to_mask_image(mask_u8[i]), float(score[i])))
    return out


# --------------------------------------------------------------- crop layer


def crop_boxes(extent, n_layers: int, overlap_ratio: float) -> List[Tuple]:
    """Crop windows for multi-crop generation: [(x0, y0, x1, y1, layer)].
    Layer 0 is the full image; layer i tiles it with 2^i crops a side, each
    overlapping its neighbour by int(overlap_ratio * min(W, H) * 2 / 2^i)
    pixels (upstream SAM's generate_crop_boxes)."""
    w, h = extent.width, extent.height
    boxes = [(0, 0, w, h, 0)]
    short = min(w, h)
    for layer in range(1, n_layers + 1):
        n = 2 ** layer
        overlap = int(overlap_ratio * short * (2.0 / n))
        cw = int(math.ceil((overlap * (n - 1) + w) / n))
        ch = int(math.ceil((overlap * (n - 1) + h) / n))
        x0s = [int((cw - overlap) * i) for i in range(n)]
        y0s = [int((ch - overlap) * i) for i in range(n)]
        for y0 in y0s:
            for x0 in x0s:
                boxes.append((x0, y0, min(x0 + cw, w), min(y0 + ch, h),
                              layer))
    return boxes


def _host_box(mask: np.ndarray) -> np.ndarray:
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return np.array([0.0, 0.0, -1.0, -1.0], np.float32)
    return np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.float32)


def _host_nms(boxes: np.ndarray, order: np.ndarray, thresh: float
              ) -> np.ndarray:
    """Greedy box NMS over `order` (preference-descending indices) -> bool
    keep per original index. Inclusive-pixel IoU, as in ops/amg."""
    keep = np.ones(len(boxes), bool)
    area = (np.maximum(boxes[:, 2] - boxes[:, 0] + 1, 0)
            * np.maximum(boxes[:, 3] - boxes[:, 1] + 1, 0))
    for rank, i in enumerate(order):
        if not keep[i]:
            continue
        for j in order[rank + 1:]:
            if not keep[j]:
                continue
            iw = max(min(boxes[i, 2], boxes[j, 2])
                     - max(boxes[i, 0], boxes[j, 0]) + 1, 0)
            ih = max(min(boxes[i, 3], boxes[j, 3])
                     - max(boxes[i, 1], boxes[j, 1]) + 1, 0)
            inter = iw * ih
            union = max(area[i] + area[j] - inter, 1.0)
            if inter / union > thresh:
                keep[j] = False
    return keep


def generate_masks_image(img, env, variant=None, grid: int = 32,
                         max_masks: int = 64, iou_thresh: float = 0.88,
                         stability_thresh: float = 0.95,
                         nms_thresh: float = 0.7, min_area_frac: float = 0.0,
                         max_area_frac: float = 1.0,
                         min_mask_region_area: int = 0,
                         crop_n_layers: int = 0,
                         crop_overlap_ratio: float = 512 / 1500,
                         crop_points_downscale: int = 1,
                         crop_nms_thresh: float = 0.7) -> List:
    """Segment everything, with optional multi-crop refinement.

    ``crop_n_layers=0`` is exactly Segmentation.process + generate_masks.
    With ``crop_n_layers >= 1`` layer i also tiles the image into 2^i x 2^i
    overlapping crops (``crop_boxes``); each crop is embedded and
    mask-generated on its own, its grid downscaled by
    crop_points_downscale^i, and the union is deduplicated by a host greedy
    box NMS (``crop_nms_thresh``) that prefers masks from smaller crops.

    Returns List[Mask] at the full image extent, best-first by predicted
    IoU, at most max_masks."""
    from ..types import Channels, Extent
    from ..types import Image as _Image, ImageView as _ImageView
    from .segmentation import Mask, Segmentation

    view = img.view() if isinstance(img, _Image) else img
    W, H = view.extent.width, view.extent.height
    kw = dict(max_masks=max_masks, iou_thresh=iou_thresh,
              stability_thresh=stability_thresh, nms_thresh=nms_thresh,
              min_area_frac=min_area_frac, max_area_frac=max_area_frac,
              min_mask_region_area=min_mask_region_area)
    entries = []  # (full mask u8, accuracy, crop area)
    for (x0, y0, x1, y1, layer) in crop_boxes(view.extent, crop_n_layers,
                                              crop_overlap_ratio):
        g = max(1, grid // (crop_points_downscale ** layer))
        if (x0, y0, x1, y1) == (0, 0, W, H):
            sub = view
        else:
            sub = _ImageView.from_array(
                np.ascontiguousarray(view.pixels[y0:y1, x0:x1]),
                view.channels)
        seg = Segmentation.process(sub, env, variant)
        for mk in generate_masks(seg, grid=g, **kw):
            full = np.zeros((H, W), np.uint8)
            full[y0:y1, x0:x1] = np.asarray(mk.image.pixels).reshape(
                y1 - y0, x1 - x0)
            entries.append((full, mk.accuracy, (x1 - x0) * (y1 - y0)))
    if not entries:
        return []
    if crop_n_layers >= 1 and len(entries) > 1:
        boxes = np.stack([_host_box(e[0] > 0) for e in entries])
        # Preference: smaller crop first (1/area descending), insertion
        # order breaks ties (upstream's torchvision nms with 1/area scores).
        crop_area = np.array([e[2] for e in entries], np.float64)
        order = np.argsort(crop_area, kind="stable")
        keep = _host_nms(boxes, order, crop_nms_thresh)
        entries = [e for e, k in zip(entries, keep) if k]
    entries.sort(key=lambda e: -e[1])
    return [Mask(_Image(Extent(W, H), Channels.mask, e[0]), float(e[1]))
            for e in entries[:max_masks]]
