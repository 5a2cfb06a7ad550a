"""Core value types (counterpart of dlimgedit_tpu/types.py).

The same public vocabulary as the JAX package: Extent, Channels, ImageView,
Image, Backend, Options, Point, Region. `Backend.gpu` selects CUDA
(`cuda:0`), and it is the default here.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

__all__ = [
    "Extent",
    "Channels",
    "channel_count",
    "ImageView",
    "Image",
    "Backend",
    "Options",
    "Point",
    "Region",
]


@dataclass(frozen=True)
class Extent:
    """Resolution of an image or size of an image region."""

    width: int = 0
    height: int = 0

    def __iter__(self):
        yield self.width
        yield self.height


class Channels(enum.Enum):
    """Channel order of image pixels; each channel is 1 byte."""

    mask = 1
    rgb = 3
    rgba = 4
    bgra = 5
    argb = 6


def channel_count(channels: Channels) -> int:
    """Number of channels for a pixel."""
    if channels in (Channels.rgba, Channels.bgra, Channels.argb):
        return 4
    return channels.value


# Channel index maps used to extract RGB from any supported order.
RGB_CHANNEL_MAP = {
    Channels.mask: (0, 0, 0),
    Channels.rgb: (0, 1, 2),
    Channels.rgba: (0, 1, 2),
    Channels.bgra: (2, 1, 0),
    Channels.argb: (1, 2, 3),
}


@dataclass
class ImageView:
    """Read-only view of packed row-major uint8 pixel data.

    ``pixels`` is a numpy array of shape (height, width, channel_count) or
    (height, width) for masks. The view does not copy.
    """

    pixels: np.ndarray
    extent: Extent
    channels: Channels = Channels.rgba

    @staticmethod
    def from_array(arr: np.ndarray, channels: Optional[Channels] = None) -> "ImageView":
        if arr.dtype != np.uint8:
            raise ValueError(f"ImageView requires uint8 pixels, got {arr.dtype}")
        if arr.ndim == 2:
            arr = arr[:, :, None]
        h, w, c = arr.shape
        if channels is None:
            channels = {1: Channels.mask, 3: Channels.rgb, 4: Channels.rgba}.get(c)
            if channels is None:
                raise ValueError(f"Unsupported number of channels ({c})")
        if channel_count(channels) != c:
            raise ValueError(
                f"channels={channels} expects {channel_count(channels)} planes, got {c}"
            )
        return ImageView(pixels=arr, extent=Extent(w, h), channels=channels)


class Image:
    """An image owning packed uint8 pixel data."""

    def __init__(self, extent: Extent, channels: Channels = Channels.rgba,
                 pixels: Optional[np.ndarray] = None):
        self._extent = extent
        self._channels = channels
        c = channel_count(channels)
        if pixels is None:
            pixels = np.empty((extent.height, extent.width, c), dtype=np.uint8)
        else:
            if np.asarray(pixels).dtype != np.uint8:
                # A silent cast would WRAP int16 values and floor a float
                # [0, 1] mask to all-zeros.
                raise ValueError(
                    f"Image pixels must be uint8 (got "
                    f"{np.asarray(pixels).dtype}); scale/convert explicitly")
            pixels = np.ascontiguousarray(pixels)
            if pixels.ndim == 2:
                pixels = pixels[:, :, None]
            if pixels.shape != (extent.height, extent.width, c):
                raise ValueError(
                    f"pixel buffer shape {pixels.shape} does not match "
                    f"extent {extent} x {c} channels"
                )
        self._pixels = pixels

    @property
    def extent(self) -> Extent:
        return self._extent

    @property
    def channels(self) -> Channels:
        return self._channels

    @property
    def pixels(self) -> np.ndarray:
        return self._pixels

    @property
    def size(self) -> int:
        """Size in bytes."""
        return self._pixels.nbytes

    def view(self) -> ImageView:
        return ImageView(self._pixels, self._extent, self._channels)

    @staticmethod
    def load(filepath) -> "Image":
        """Decode an image file (image/io.py ``load_image``)."""
        from .image.io import load_image

        return load_image(str(filepath))

    def save(img: Union["Image", ImageView], filepath) -> None:  # noqa: N805
        """Write a PNG. Not a @staticmethod, so both ``img.save(path)`` and
        ``Image.save(img_or_view, path)`` work."""
        from .image.io import save_image

        save_image(img if isinstance(img, ImageView) else img.view(),
                   str(filepath))


class Backend(enum.Enum):
    """Hardware backend. ``gpu`` maps to CUDA (``cuda:0``); ``cpu`` to
    PyTorch's CPU device."""

    cpu = 0
    gpu = 1


@dataclass
class Options:
    """Inference options; the fields of the JAX package's Options.

    ``Environment`` rejects with a ``DlimgError`` ``compilation_cache_dir``
    (a CUDA graph lives only as long as its process). ``sam_variant`` is
    one of "mobile_sam" (or "vit_t"), "vit_b", "vit_l", "vit_h".
    """

    backend: Backend = Backend.gpu
    model_directory: str = "models"
    allow_random_weights: bool = False
    # Compute dtype of the image encoder; the decoder stays float32.
    compute_dtype: str = "bfloat16"
    sam_variant: str = "mobile_sam"
    sam_image_size: int = 1024
    # For Region prompts: keep only the largest connected object in the box.
    largest_region_object: bool = False
    # Record per-executable call latencies (Environment.profiler.report()).
    enable_profiling: bool = False
    # int8 weights for the encoder's attention and MLP linears, scales per
    # output channel from the float32 weights (ops/quant.py) ...
    quantize_encoder: bool = False
    # ... and int8 activations, quantised per token, for an s8 x s8 product
    # (implies quantize_encoder).
    quantize_activations: bool = False
    birefnet_int8_deform: bool = False
    # "device" (antialiased bilinear resample on the device) or "host"
    # (stb-semantics sRGB resize with numpy, the reference's exact numerics).
    preprocess_mode: str = "device"
    # Row chunks of the pinned-memory canvas copy: chunk i's copy runs while
    # chunk i+1 is packed. 0 = auto (one copy: see ops/preprocess.py).
    h2d_overlap_chunks: int = 0
    compilation_cache_dir: Optional[str] = None
    # Devices one image may span: 1 (the default) one; 0 every device of the
    # backend; N that many, at most the count. Fewer than 2 take the
    # single-device path, so serving configs can set 0 unconditionally;
    # with 2 or more distinct CUDA devices the ViTs encode sequence-parallel
    # over an ('sp',) mesh (parallel/sp.py), and MobileSAM's `process` and
    # BiRefNet's `segment_objects` run on canvas-row bands over it
    # (parallel/spatial.py).
    scaleout_devices: int = 1


@dataclass(frozen=True)
class Point:
    """A point in image pixel coordinates, origin top-left."""

    x: int = 0
    y: int = 0


@dataclass(frozen=True)
class Region:
    """A rectangular region in image pixel coordinates."""

    top_left: Point
    bottom_right: Point

    @staticmethod
    def from_origin_extent(origin: Point, extent: Extent) -> "Region":
        return Region(origin, Point(origin.x + extent.width, origin.y + extent.height))

    @property
    def extent(self) -> Extent:
        return Extent(
            self.bottom_right.x - self.top_left.x,
            self.bottom_right.y - self.top_left.y,
        )
