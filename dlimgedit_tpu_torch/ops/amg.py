"""Device primitives of automatic mask generation, "segment everything"
(counterpart of dlimgedit_tpu/ops/amg.py).

Everything is static in shape: candidate counts are padded and an invalid
candidate rides along with score -1 until the host drops it. The greedy
box NMS is the exact sequential algorithm, not a parallel approximation.
JAX runs it as a ``lax.fori_loop`` over the rows of an (M, M) IoU matrix;
here ``greedy_nms`` runs it on a CUDA tensor as ONE hand-written kernel
(``csrc/greedy_nms.cu``), and on a CPU tensor as that row loop
(``greedy_nms_plain``), the version the kernel is held against.

``refine_mask_logits`` is batched over a leading axis of masks (JAX vmaps
it). Its labelling reads the device from the host (``ops/connected.py``),
so a graphed program runs it eagerly between two graphs.
"""

from __future__ import annotations

from typing import Union

import torch

from ..errors import DlimgError
from .connected import _label_components
from .cuda_build import LIBRARY, check_launch, kernel_operand


def point_grid(n: int, crop_w: torch.Tensor, crop_h: torch.Tensor) -> torch.Tensor:
    """(n*n, 2) float32 (x, y) prompt grid centred over the valid region.

    ``crop_w`` / ``crop_h`` are 0-d device tensors (the resize-longest-side
    extent in model-input pixels), so one program serves every image
    shape. Points sit at cell centres, (i + 0.5) / n of each side."""
    f = (torch.arange(n, dtype=torch.float32, device=crop_w.device) + 0.5) / n
    xs = f * crop_w
    ys = f * crop_h
    px = xs[None, :].expand(n, n).reshape(-1)
    py = ys[:, None].expand(n, n).reshape(-1)
    return torch.stack([px, py], dim=-1)


def stability_scores(logits: torch.Tensor, valid: torch.Tensor = None,
                     offset: float = 1.0) -> torch.Tensor:
    """(..., L, L) logits -> (...,) stability = |m > +off| / |m > -off|,
    both areas restricted to ``valid`` when it is given."""
    hi = logits > offset
    lo = logits > -offset
    if valid is not None:
        hi = hi & valid
        lo = lo & valid
    hi_a = hi.sum(dim=(-1, -2)).float()
    lo_a = lo.sum(dim=(-1, -2)).float()
    return hi_a / torch.clamp(lo_a, min=1.0)


def mask_boxes(binary: torch.Tensor) -> torch.Tensor:
    """(..., L, L) bool -> (..., 4) float32 [x0, y0, x1, y1] inclusive. An
    empty mask gives x0 = y0 = L and x1 = y1 = -1."""
    L = binary.shape[-1]
    idx = torch.arange(L, device=binary.device)
    rows = binary.any(dim=-1)  # (..., Ly): which y rows are occupied
    cols = binary.any(dim=-2)  # (..., Lx): which x columns are occupied
    y0 = torch.where(rows, idx, L).amin(dim=-1)
    y1 = torch.where(rows, idx, -1).amax(dim=-1)
    x0 = torch.where(cols, idx, L).amin(dim=-1)
    x1 = torch.where(cols, idx, -1).amax(dim=-1)
    return torch.stack([x0, y0, x1, y1], dim=-1).float()


def box_iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(M, 4) inclusive pixel boxes -> (M, M) IoU (diagonal 1)."""
    x0, y0, x1, y1 = boxes.unbind(dim=1)
    area = (torch.clamp(x1 - x0 + 1, min=0.0)
            * torch.clamp(y1 - y0 + 1, min=0.0))
    ix0 = torch.maximum(x0[:, None], x0[None, :])
    iy0 = torch.maximum(y0[:, None], y0[None, :])
    ix1 = torch.minimum(x1[:, None], x1[None, :])
    iy1 = torch.minimum(y1[:, None], y1[None, :])
    inter = (torch.clamp(ix1 - ix0 + 1, min=0.0)
             * torch.clamp(iy1 - iy0 + 1, min=0.0))
    union = area[:, None] + area[None, :] - inter
    return inter / torch.clamp(union, min=1.0)


def _per_pixel_sizes(labels: torch.Tensor, mask: torch.Tensor):
    """(B, H, W) component labels -> per-pixel component area (float32) and
    the label of each item's largest component (0 if its mask is empty)."""
    B, H, W = labels.shape
    flat = labels.reshape(B, H * W)
    sizes = torch.zeros((B, H * W + 1), dtype=torch.int64, device=labels.device)
    sizes.scatter_add_(1, flat, mask.reshape(B, H * W).to(torch.int64))
    sizes[:, 0] = 0  # the background label carries no component
    largest = torch.argmax(sizes, dim=1)
    per_pix = torch.gather(sizes, 1, flat).reshape(B, H, W)
    return per_pix.float(), largest


def refine_mask_logits(logits: torch.Tensor, valid: torch.Tensor,
                       min_area: torch.Tensor, max_iters: int = 64) -> torch.Tensor:
    """(B, L, L) mask logits -> logits with sub-``min_area`` regions removed
    (upstream SAM's ``min_mask_region_area`` post-filter, 8-connected):

      1. holes: components of the complement smaller than ``min_area`` are
         filled (a hole that touches the padding counts as background);
      2. islands: components of the hole-filled mask smaller than
         ``min_area`` are removed, keeping the largest island when every
         one is below it.

    ``min_area`` is in low-res pixels, a device scalar compared on the
    device. The result clamps logits (+8 on filled holes, -8 on removed
    islands) so the upsample renders the filtered mask smoothly."""
    binary = (logits > 0) & valid
    # Holes first (upstream's order): small components of the complement.
    inv = ~binary
    hole_sz, _ = _per_pixel_sizes(_label_components(inv, max_iters, conn8=True),
                                  inv)
    fill = inv & valid & (hole_sz < min_area)
    filled = binary | fill
    # Islands on the hole-filled mask.
    lab_i = _label_components(filled, max_iters, conn8=True)
    isl_sz, largest = _per_pixel_sizes(lab_i, filled)
    big = filled & (isl_sz >= min_area)
    any_big = big.flatten(1).any(dim=1)[:, None, None]
    keep = torch.where(any_big, big, filled & (lab_i == largest[:, None, None]))
    force_on = keep & ~binary
    force_off = binary & ~keep
    out = torch.where(force_on, torch.clamp(logits, min=8.0), logits)
    return torch.where(force_off, torch.clamp(out, max=-8.0), out)


def greedy_nms_plain(boxes_sorted: torch.Tensor, scores_sorted: torch.Tensor,
                     thresh: Union[torch.Tensor, float]) -> torch.Tensor:
    """Exact greedy box NMS over score-descending candidates -> (M,) bool
    keep: JAX's row loop over the IoU matrix, built once. Candidates with
    score <= 0 are never kept; each kept candidate, best first, clears every
    LATER candidate whose box IoU with it exceeds ``thresh``."""
    M = boxes_sorted.shape[0]
    over = box_iou_matrix(boxes_sorted) > thresh
    later = torch.arange(M, device=boxes_sorted.device)
    keep = scores_sorted > 0.0
    for i in range(M):
        keep = keep & ~(keep[i] & over[i] & (later > i))
    return keep


def nms_scratch_words(M: int) -> int:
    """int64 words of the NMS kernel's scratch: ceil(M / 64) words a row
    for 64 * ceil(M / 64) rows at an even stride, then the live flags."""
    nw = -(-M // 64)
    return nw * 64 * (nw + nw % 2) + nw


def greedy_nms(boxes_sorted: torch.Tensor, scores_sorted: torch.Tensor,
               thresh: Union[torch.Tensor, float]) -> torch.Tensor:
    """Exact greedy box NMS (see ``greedy_nms_plain``) -> (M,) bool keep.

    boxes_sorted: (M, 4) float32 inclusive pixel boxes, scores_sorted:
    (M,) float32, both in descending score order. On a CUDA tensor it
    launches the kernels of ``csrc/greedy_nms.cu`` (the IoU bitmask, then
    the one-warp scan: one call, counted once in ``greedy_nms.launches``)
    with a scratch bitmask of ``nms_scratch_words(M)`` int64 words from
    ``torch.empty`` (inside a capture, from the graph's pool); ``thresh``
    must then be a one-element float32 tensor on the same device, which
    the kernel reads through its pointer (a graph replay sees its current
    value). On a CPU tensor it runs ``greedy_nms_plain``. It raises on
    anything else."""
    M = boxes_sorted.shape[0]
    if tuple(boxes_sorted.shape) != (M, 4) or tuple(scores_sorted.shape) != (M,):
        raise DlimgError(f"greedy_nms: boxes {tuple(boxes_sorted.shape)} must "
                         f"be (M, 4) and scores {tuple(scores_sorted.shape)} (M,)")
    if boxes_sorted.device.type == "cpu":
        return greedy_nms_plain(boxes_sorted, scores_sorted, thresh)
    if not boxes_sorted.is_cuda:
        raise DlimgError(f"greedy_nms: unsupported device {boxes_sorted.device}")
    if not (isinstance(thresh, torch.Tensor) and thresh.numel() == 1
            and thresh.dtype == torch.float32
            and thresh.device == boxes_sorted.device):
        raise DlimgError("greedy_nms: on CUDA the threshold must be a "
                         "one-element float32 tensor on the boxes' device")
    tensors = (boxes_sorted, scores_sorted)
    if any(t.dtype != torch.float32 for t in tensors):
        raise DlimgError("greedy_nms: boxes and scores must be float32")
    if scores_sorted.device != boxes_sorted.device:
        raise DlimgError("greedy_nms: boxes and scores must share a device")
    # The boxes are read as 16-byte rows (the threshold as one float).
    boxes_sorted, scores_sorted = (kernel_operand(t) for t in tensors)
    keep = torch.empty((M,), dtype=torch.bool, device=boxes_sorted.device)
    if M == 0:
        return keep
    words = nms_scratch_words(M)
    scratch = torch.empty((words,), dtype=torch.int64, device=boxes_sorted.device)
    rc = LIBRARY.get().dlimg_greedy_nms(
        boxes_sorted.data_ptr(), scores_sorted.data_ptr(), thresh.data_ptr(),
        keep.data_ptr(), scratch.data_ptr(), words, M,
        torch.cuda.current_stream(boxes_sorted.device).cuda_stream)
    check_launch("greedy_nms", rc)
    greedy_nms.launches += 1
    return keep


greedy_nms.launches = 0
