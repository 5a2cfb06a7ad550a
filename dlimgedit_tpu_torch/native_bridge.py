"""Bridge functions for the native C ABI (counterpart of
dlimgedit_tpu/native_bridge.py, with its eleven functions under the same
names and signatures).

The port's C library (dlimgedit_tpu_torch/native/src/capi.cpp, built by
native_build.py) embeds CPython, imports this module by its name, and
calls these functions positionally with raw pointers as Python ints; this
module does the numpy marshalling, so the C side stays free of the numpy
C API. A point arrives as ``(x, y)``, a region as ``(x0, y0, x1, y1)``, a
list of output pointers as a list of ints. Pixel buffers are wrapped zero-copy with
ctypes: the view lives only as long as the call (the port packs it into a
canvas of its own before it returns, so a caller may free its pixels as
soon as ``process`` returns). Masks are copied into the caller-owned
``width * height`` byte buffers, accuracies into its float buffers.

The JAX package's library (native/src/capi.cpp) imports
``dlimgedit_tpu.native_bridge`` and serves the JAX package; the port's
copy of it imports this module, with no stand-in module for a C host to
provide. This module keeps no state of its own (the C library calls it
from several threads, under the GIL).

Configuration beyond dlimg_Options' two fields (backend, model_directory)
comes from environment variables, the JAX bridge's:
  DLIMG_ALLOW_RANDOM_WEIGHTS=1  - permit seeded random weights
  DLIMG_SAM_VARIANT=vit_b       - encoder variant (default mobile_sam)
  DLIMG_SAM_IMAGE_SIZE=512      - model input resolution (default 1024)
  DLIMG_COMPUTE_DTYPE=float32   - encoder compute dtype (default bfloat16)
  DLIMG_COMPILATION_CACHE=/path - raises: the port's executables are CUDA
                                  graphs, which live only as long as their
                                  process (Options.compilation_cache_dir)
  DLIMG_SCALEOUT_DEVICES=0      - Options.scaleout_devices (0 = all, 1 =
                                  off, N = that many)
  DLIMG_AMG_GRID=16             - generate_masks prompt-grid side
                                  (default 32)
  DLIMG_PJRT_BUNDLE=/path       - never reaches this module: the port's C
                                  library then serves the bundle with no
                                  Python (native/src/torch_backend.hpp)

Backend 0 is the CPU; backend 1 is ``cuda:0``, and without a CUDA device
``create_environment(1, ...)`` raises ``DlimgError``: it never serves on
the CPU instead.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .errors import DlimgError
from .runtime.environment import Environment, is_supported
from .runtime.segmentation import Segmentation, segment_objects
from .types import Backend, Channels, Extent, Image, ImageView, Options, Point, Region

_CHANNELS = {1: Channels.mask, 3: Channels.rgb, 4: Channels.rgba,
             5: Channels.bgra, 6: Channels.argb}


def _wrap_pixels(ptr: int, width: int, height: int, channels: int,
                 stride: int) -> np.ndarray:
    """The caller's pixels as an (h, w, c) uint8 view, no copy: with a row
    stride above ``width * c`` its rows are not contiguous."""
    c = _CHANNELS[channels]
    nch = 4 if channels in (5, 6) else channels
    stride = stride or width * nch
    buf = (ctypes.c_uint8 * (stride * height)).from_address(ptr)
    arr = np.frombuffer(buf, dtype=np.uint8).reshape(height, stride)
    return arr[:, : width * nch].reshape(height, width, nch)


def _view(ptr: int, width: int, height: int, channels: int,
          stride: int) -> ImageView:
    return ImageView(_wrap_pixels(ptr, width, height, channels, stride),
                     Extent(width, height), _CHANNELS[channels])


def _write_mask(ptr: int, width: int, height: int, image: Image) -> None:
    """Copy a mask into the caller's ``width * height`` byte buffer. The
    mask must be a host uint8 array of exactly that many bytes."""
    px = image.pixels
    if (not isinstance(px, np.ndarray) or px.dtype != np.uint8
            or px.size != width * height):
        raise DlimgError(f"mask of {getattr(px, 'shape', None)} "
                         f"{getattr(px, 'dtype', type(px).__name__)} does not "
                         f"fill a {width}x{height} byte buffer")
    out = (ctypes.c_uint8 * (width * height)).from_address(ptr)
    np.frombuffer(out, dtype=np.uint8)[:] = px.ravel()


def backend_supported(backend: int) -> bool:
    return is_supported(Backend.cpu if backend == 0 else Backend.gpu)


def create_environment(backend: int, model_directory: str) -> Environment:
    opts = Options(
        backend=Backend.cpu if backend == 0 else Backend.gpu,
        model_directory=model_directory,
        allow_random_weights=os.environ.get(
            "DLIMG_ALLOW_RANDOM_WEIGHTS", "0") == "1",
        sam_variant=os.environ.get("DLIMG_SAM_VARIANT", "mobile_sam"),
        sam_image_size=int(os.environ.get("DLIMG_SAM_IMAGE_SIZE", "1024")),
        compute_dtype=os.environ.get("DLIMG_COMPUTE_DTYPE", "bfloat16"),
        compilation_cache_dir=os.environ.get("DLIMG_COMPILATION_CACHE"),
        scaleout_devices=int(os.environ.get("DLIMG_SCALEOUT_DEVICES", "1")),
    )
    return Environment(opts)


def process(env: Environment, ptr: int, width: int, height: int,
            channels: int, stride: int) -> Segmentation:
    return Segmentation.process(_view(ptr, width, height, channels, stride),
                                env)


def segmentation_extent(seg: Segmentation) -> tuple:
    return seg.extent.width, seg.extent.height


def compute_mask(seg: Segmentation, point, region, out_mask_ptrs,
                 out_acc_ptr: int) -> None:
    """point: (x, y) or None; region: (x0, y0, x1, y1) or None;
    out_mask_ptrs: 3 pointer ints (0: unused). Slot 1 == 0 means one mask
    for the point or the region; else three masks for the point and their
    accuracies into the float[3] at ``out_acc_ptr``."""
    w, h = seg.extent.width, seg.extent.height
    if out_mask_ptrs[1] == 0:
        prompt = (Point(*point) if point is not None
                  else Region(Point(region[0], region[1]),
                              Point(region[2], region[3])))
        _write_mask(out_mask_ptrs[0], w, h, seg.compute_mask(prompt))
        return
    if point is None:
        raise DlimgError("compute_mask: three masks need a point prompt")
    masks = seg.compute_masks(Point(*point))
    acc = (ctypes.c_float * 3).from_address(out_acc_ptr)
    for i, m in enumerate(masks):
        _write_mask(out_mask_ptrs[i], w, h, m.image)
        acc[i] = m.accuracy


def _write_masks(seg: Segmentation, masks, out_mask_ptrs, out_acc_ptr: int,
                 slots: int) -> None:
    w, h = seg.extent.width, seg.extent.height
    acc = (ctypes.c_float * slots).from_address(out_acc_ptr) \
        if out_acc_ptr else None
    for i, m in enumerate(masks):
        _write_mask(out_mask_ptrs[i], w, h, m.image)
        if acc is not None:
            acc[i] = m.accuracy


def compute_mask_batch(seg: Segmentation, prompts, is_region, n: int,
                       out_mask_ptrs, out_acc_ptr: int) -> None:
    """Batched decode: prompts is a flat int tuple [n*4] ({x,y,_,_} for
    points, {x0,y0,x1,y1} for boxes per is_region); masks go into n caller
    buffers, accuracies into a float[n] buffer when non-null. One device
    program (Segmentation.compute_mask_batch)."""
    plist = []
    for i in range(n):
        v = prompts[4 * i:4 * i + 4]
        if is_region[i]:
            plist.append(Region(Point(v[0], v[1]), Point(v[2], v[3])))
        else:
            plist.append(Point(v[0], v[1]))
    _write_masks(seg, seg.compute_mask_batch(plist), out_mask_ptrs,
                 out_acc_ptr, n)


def generate_masks(seg: Segmentation, iou_thresh: float,
                   stability_thresh: float, nms_thresh: float,
                   max_masks: int, out_mask_ptrs, out_acc_ptr: int) -> int:
    """Automatic mask generation: up to max_masks masks and accuracies into
    the caller's buffers, best first; returns the count."""
    grid = int(os.environ.get("DLIMG_AMG_GRID", "32"))
    masks = seg.generate_masks(grid=grid, max_masks=max_masks,
                               iou_thresh=iou_thresh,
                               stability_thresh=stability_thresh,
                               nms_thresh=nms_thresh)
    _write_masks(seg, masks, out_mask_ptrs, out_acc_ptr, max_masks)
    return len(masks)


def run_segment_objects(env: Environment, ptr: int, width: int, height: int,
                        channels: int, stride: int, out_ptr: int) -> None:
    mask = segment_objects(_view(ptr, width, height, channels, stride), env)
    _write_mask(out_ptr, width, height, mask)


def load_image(filepath: str) -> tuple:
    """(width, height, channels, bytes): the C side copies the bytes into a
    buffer it allocates (its allocator frees them)."""
    img = Image.load(filepath)
    return (img.extent.width, img.extent.height,
            img.pixels.shape[2], img.pixels.tobytes())


def save_image(ptr: int, width: int, height: int, channels: int, stride: int,
               filepath: str) -> None:
    Image.save(_view(ptr, width, height, channels, stride), filepath)
