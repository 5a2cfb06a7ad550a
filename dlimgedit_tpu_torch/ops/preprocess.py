"""SAM image preprocessing (counterpart of dlimgedit_tpu/ops/preprocess.py).

The host only packs the raw uint8 RGB pixels into a bucketed canvas and
copies it to the device; the resize (antialiased bilinear, any scale),
normalisation and padding run on the device with shapes fixed by the
bucket.

Host -> device copy on CUDA: the canvas is packed into pinned host memory
and copied with ``non_blocking=True``, optionally in row chunks (chunk i's
copy runs while chunk i+1 is packed). Pinned canvases are reused from a
per-thread pool of two per bucket; a canvas goes back out only after the
CUDA event recorded behind its last copy has completed, and when every
pooled canvas is still in flight a fresh one is used instead. Reused
canvases are not zeroed: the resample matrices give zero weight to every
pixel outside the image's [:h, :w], so stale bytes never reach the result.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..models.sam import SAM_PIXEL_MEAN, SAM_PIXEL_STD
from ..types import Extent, ImageView, RGB_CHANNEL_MAP
from .resample import apply_resample, resample_matrix

# Canvas buckets: shapes are fixed per bucket.
CANVAS_BUCKETS = (256, 512, 1024, 2048, 4096)


def pick_bucket(extent: Extent, buckets=CANVAS_BUCKETS) -> int:
    m = max(extent.width, extent.height)
    for b in buckets:
        if m <= b:
            return b
    return ((m + 1023) // 1024) * 1024  # oversized: round up to 1 KiB grid


_POOL_DEPTH = 2


class CanvasPool:
    """Pinned (bucket, bucket, 3) uint8 staging canvases, per thread."""

    def __init__(self):
        self._local = threading.local()

    def _rings(self):
        rings = getattr(self._local, "rings", None)
        if rings is None:
            rings = self._local.rings = {}
        return rings

    def take(self, bucket: int) -> torch.Tensor:
        ring = self._rings().setdefault(bucket, [])
        if len(ring) < _POOL_DEPTH:
            buf = torch.empty((bucket, bucket, 3), dtype=torch.uint8,
                              pin_memory=True)
            ring.append([buf, None])
            return buf
        # Least recently issued first, skipping canvases whose copy is
        # still in flight.
        for i, entry in enumerate(ring):
            buf, event = entry
            if event is None or event.query():
                entry[1] = None
                ring.append(ring.pop(i))
                return buf
        return torch.empty((bucket, bucket, 3), dtype=torch.uint8,
                           pin_memory=True)

    def note_copy(self, canvas: torch.Tensor, event: "torch.cuda.Event") -> None:
        """Record the event behind the last copy out of a pooled canvas
        (unpooled canvases are ignored)."""
        for ring in self._rings().values():
            for entry in ring:
                if entry[0] is canvas:
                    entry[1] = event


def resolve_h2d_chunks(option_value: int) -> int:
    """Options.h2d_overlap_chunks, 0 = auto = one copy. On a PCIe or NVLink
    host a 1024-bucket canvas (3 MB) copies from pinned memory in a small
    fraction of the time numpy takes to pack it, so chunking has little to
    hide; a caller may still ask for chunks."""
    return max(1, int(option_value)) if option_value else 1


def _pack_rows(arr: np.ndarray, cmap, canvas: np.ndarray,
               r0: int, r1: int, w: int) -> None:
    """Channel-map pack arr[r0:r1, :w] -> canvas[r0:r1, :w]."""
    src, dst = arr[r0:r1], canvas[r0:r1]
    dst[:, :w, 0] = src[:, :, cmap[0]]
    dst[:, :w, 1] = src[:, :, cmap[1]]
    dst[:, :w, 2] = src[:, :, cmap[2]]


def pack_rgb_canvas(view: ImageView, bucket: int) -> np.ndarray:
    """Host-side: RGB-mapped uint8 pixels top-left in a zeroed
    (bucket, bucket, 3) canvas (channel maps: mask->(0,0,0),
    bgra->(2,1,0), argb->(1,2,3), rgb/rgba->(0,1,2))."""
    arr = view.pixels
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w = arr.shape[:2]
    canvas = np.zeros((bucket, bucket, 3), dtype=np.uint8)
    _pack_rows(arr, RGB_CHANNEL_MAP[view.channels], canvas, 0, h, w)
    return canvas


def pack_and_put_canvas(view: ImageView, bucket: int, device: torch.device, *,
                        pool: CanvasPool | None = None,
                        n_chunks: int = 1) -> torch.Tensor:
    """Pack an image into a (bucket, bucket, 3) uint8 canvas on `device`.

    On the CPU the packed numpy canvas is wrapped without a copy. On CUDA
    the pack goes into pinned memory (from `pool` when given) and is copied
    asynchronously, `n_chunks` row chunks at a time."""
    if device.type == "cpu":
        return torch.from_numpy(pack_rgb_canvas(view, bucket))
    arr = view.pixels
    if arr.ndim == 2:
        arr = arr[:, :, None]
    cmap = RGB_CHANNEL_MAP[view.channels]
    h, w = arr.shape[:2]
    host = pool.take(bucket) if pool is not None else torch.empty(
        (bucket, bucket, 3), dtype=torch.uint8, pin_memory=True)
    host_np = host.numpy()
    dev = torch.empty((bucket, bucket, 3), dtype=torch.uint8, device=device)
    rows = -(-bucket // max(1, n_chunks))  # ceil: the last chunk may be short
    for r0 in range(0, bucket, rows):
        r1 = min(r0 + rows, bucket)
        if r0 < h:  # rows beyond the image stay stale (masked anyway)
            _pack_rows(arr, cmap, host_np, r0, min(r1, h), w)
        dev[r0:r1].copy_(host[r0:r1], non_blocking=True)
    if pool is not None:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        pool.note_copy(host, event)
    return dev


@functools.lru_cache(maxsize=None)
def _pixel_stats(device: torch.device):
    """SAM's pixel mean and std on `device`, made once: building them from a
    Python list per call would be a pageable host copy, which waits for all
    work queued on the stream."""
    return (torch.tensor(SAM_PIXEL_MEAN, dtype=torch.float32, device=device),
            torch.tensor(SAM_PIXEL_STD, dtype=torch.float32, device=device))


def sam_preprocess(canvas: torch.Tensor, in_h, in_w, out_h, out_w,
                   image_size: int = 1024,
                   compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """canvas: (S, S, 3) uint8, valid region [:in_h, :in_w]; out_h/out_w:
    the resize-longest-side target (max == image_size). Sizes may be 0-d
    device tensors. Returns (1, image_size, image_size, 3) normalised,
    zero-padded pixels in `compute_dtype`."""
    S = canvas.shape[0]
    dev = canvas.device
    img = canvas.float()
    R = resample_matrix(image_size, S, out_h, in_h, antialias=True, device=dev)
    C = resample_matrix(image_size, S, out_w, in_w, antialias=True, device=dev)
    x = apply_resample(R, C, img)
    mean, std = _pixel_stats(dev)
    x = (x - mean) / std
    # SAM pads the NORMALISED image with zeros.
    i = torch.arange(image_size, device=dev)[:, None, None]
    j = torch.arange(image_size, device=dev)[None, :, None]
    inside = (i < out_h) & (j < out_w)
    x = torch.where(inside, x, torch.zeros((), device=dev))
    return x[None].to(compute_dtype)
