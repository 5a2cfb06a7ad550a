"""Host-side image resize matching the reference's stb_image_resize semantics
(counterpart of dlimgedit_tpu/image/resize.py, numpy only).

Reference: image.cpp:37-62 of the original dlimgedit —
  * ``resize``      : STBIR_EDGE_CLAMP, STBIR_FILTER_DEFAULT (Catmull-Rom when
                      upsampling, Mitchell when downsampling), STBIR_COLORSPACE_SRGB.
  * ``resize_mask`` : 1 channel, STBIR_FILTER_BOX, STBIR_COLORSPACE_LINEAR.

Implemented as separable filtering with dense per-axis weight matrices — the
whole resize is two matmuls. This is the "compat"-quality path
(Options.preprocess_mode="host"); the device path (ops/preprocess.py) uses
the same sampling geometry with a bilinear kernel. ``resize_mask`` applies
the same box-filter matrices through each row's nonzero taps
(``_resample_taps``): BiRefNet's 2048 mask goes back to the image's extent
on the host after every ``segment_objects``.
"""

from __future__ import annotations

import functools

import numpy as np

from ..types import Extent, Image, ImageView

__all__ = ["resize", "resize_mask", "resize_longest_side_extent", "filter_matrix"]


def resize_longest_side_extent(extent: Extent, max_side: int) -> tuple[Extent, float]:
    """Scale so that max(w, h) == max_side; per-axis round-half-up.

    Mirrors ResizeLongestSide (segmentation.cpp:58-74 of the original):
    ``scale = max_side / max(w, h)``, ``dim' = int(dim * scale + 0.5)``.
    """
    scale = float(max_side) / float(max(extent.width, extent.height))
    target = Extent(int(extent.width * scale + 0.5), int(extent.height * scale + 0.5))
    return target, scale


def transform_point(x: int, y: int, scale: float) -> tuple[int, int]:
    """Prompt-coordinate transform (segmentation.cpp:26,72-74)."""
    return int(x * scale + 0.5), int(y * scale + 0.5)


# ---------------------------------------------------------------------------
# Filter kernels (stb_image_resize v1 definitions)
# ---------------------------------------------------------------------------

def _kernel_catmull_rom(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(
        x < 1.0,
        ((9.0 * x - 15.0) * x * x + 6.0) / 6.0,
        np.where(x < 2.0, (((-3.0 * x + 15.0) * x - 24.0) * x + 12.0) / 6.0, 0.0),
    )


def _kernel_mitchell(x: np.ndarray) -> np.ndarray:
    # Mitchell-Netravali with B = C = 1/3 (stb's downsample default).
    x = np.abs(x)
    return np.where(
        x < 1.0,
        ((21.0 * x - 36.0) * x * x + 16.0) / 18.0,
        np.where(x < 2.0, (((-7.0 * x + 36.0) * x - 60.0) * x + 32.0) / 18.0, 0.0),
    )


def _kernel_box(x: np.ndarray) -> np.ndarray:
    return np.where((x >= -0.5) & (x < 0.5), 1.0, 0.0)


def _kernel_triangle(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.maximum(0.0, 1.0 - x)


_KERNELS = {
    "catmull-rom": (_kernel_catmull_rom, 2.0),
    "mitchell": (_kernel_mitchell, 2.0),
    "box": (_kernel_box, 0.5),
    "triangle": (_kernel_triangle, 1.0),
}


def filter_matrix(n_in: int, n_out: int, kernel: str) -> np.ndarray:
    """Dense (n_out, n_in) resampling matrix with clamp-to-edge boundary.

    Sampling geometry matches stb v1: output pixel centre i maps to input
    position (i + 0.5) * n_in / n_out - 0.5. When downsampling the kernel is
    stretched by the scale factor. Rows are normalised to sum to 1.
    """
    fn, support = _KERNELS[kernel]
    scale = n_out / n_in  # > 1 for upsampling
    # Filter scale: stretch the kernel when minifying.
    kscale = min(scale, 1.0)
    centers = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5  # (n_out,)
    radius = support / kscale
    lo = np.floor(centers - radius).astype(np.int64)
    hi = np.ceil(centers + radius).astype(np.int64)
    width = int((hi - lo).max()) + 1
    taps = lo[:, None] + np.arange(width)[None, :]  # (n_out, width)
    w = fn((taps - centers[:, None]) * kscale)
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    # Clamp-to-edge: fold out-of-range taps onto edge pixels.
    taps_c = np.clip(taps, 0, n_in - 1)
    mat = np.zeros((n_out, n_in), dtype=np.float64)
    np.add.at(mat, (np.repeat(np.arange(n_out), width), taps_c.ravel()), w.ravel())
    return mat


# ---------------------------------------------------------------------------
# sRGB <-> linear
# ---------------------------------------------------------------------------

def srgb_to_linear(s: np.ndarray) -> np.ndarray:
    s = s.astype(np.float64) / 255.0
    return np.where(s <= 0.04045, s / 12.92, ((s + 0.055) / 1.055) ** 2.4)


def linear_to_srgb_u8(lin: np.ndarray) -> np.ndarray:
    lin = np.clip(lin, 0.0, 1.0)
    s = np.where(lin <= 0.0031308, lin * 12.92, 1.055 * lin ** (1.0 / 2.4) - 0.055)
    return np.clip(np.round(s * 255.0), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Public resize ops
# ---------------------------------------------------------------------------

def _resample(arr: np.ndarray, target: Extent, kernel: str,
              kernel_w: str | None = None) -> np.ndarray:
    """Separable resample of float (H, W, C) data. `kernel` filters the H
    axis; `kernel_w` (default: same) the W axis — stb v1 picks the default
    filter per axis from each axis's own scale."""
    h_in, w_in = arr.shape[:2]
    mh = filter_matrix(h_in, target.height, kernel)
    mw = filter_matrix(w_in, target.width, kernel_w or kernel)
    # (H', W', C) = mh @ arr @ mw^T, batched over channels.
    out = np.einsum("ij,jkc->ikc", mh, arr)
    out = np.einsum("ikc,lk->ilc", out, mw)
    return out


def _resample_taps(arr: np.ndarray, target: Extent,
                   kernel: str) -> np.ndarray:
    """``_resample`` through each filter matrix's nonzero taps (a few per
    row, against the whole axis for the dense products): the same terms
    summed in column order, so equal to the dense products up to float64
    rounding; after rounding to uint8 an exact .5 can land one level away
    (seen only at strong minification, where the wide box filter's terms
    are summed in another order)."""
    ch, wh = _filter_taps(arr.shape[0], target.height, kernel)
    cw, ww = _filter_taps(arr.shape[1], target.width, kernel)
    rows = wh[:, 0, None, None] * arr[ch[:, 0]]
    for t in range(1, ch.shape[1]):
        rows += wh[:, t, None, None] * arr[ch[:, t]]
    out = rows[:, cw[:, 0]] * ww[None, :, 0, None]
    for t in range(1, cw.shape[1]):
        out += rows[:, cw[:, t]] * ww[None, :, t, None]
    return out


@functools.lru_cache(maxsize=64)
def _filter_taps(n_in: int, n_out: int, kernel: str):
    """``filter_matrix``'s nonzero entries per row, in column order: (cols,
    weights), each (n_out, taps), padded with zero weights; made once per
    (n_in, n_out, kernel)."""
    mat = filter_matrix(n_in, n_out, kernel)
    nz = mat != 0
    width = max(1, int(nz.sum(axis=1).max()))
    cols = np.argsort(~nz, axis=1, kind="stable")[:, :width]
    return cols, np.take_along_axis(mat, cols, axis=1)


def resize(img: ImageView | Image, target: Extent) -> Image:
    """Generic image resize, sRGB-aware, clamp edges (image.cpp:37-51).

    Uses Catmull-Rom for upsampling, Mitchell for downsampling, matching
    STBIR_FILTER_DEFAULT. All channels are treated as colour
    (STBIR_ALPHA_CHANNEL_NONE in the reference).
    """
    view = img.view() if isinstance(img, Image) else img
    arr = view.pixels
    if arr.ndim == 2:
        arr = arr[:, :, None]
    # stb v1 STBIR_FILTER_DEFAULT selects per axis from that axis's own
    # scale: Catmull-Rom when magnifying, Mitchell otherwise — STRICTLY
    # magnifying (stbir__use_upsampling is `ratio > 1`), so an axis that
    # keeps its size uses Mitchell, like any downsample. Mixed up/down
    # resizes use different kernels on H and W.
    kh = "catmull-rom" if target.height > view.extent.height else "mitchell"
    kw = "catmull-rom" if target.width > view.extent.width else "mitchell"
    lin = srgb_to_linear(arr)
    out = _resample(lin, target, kh, kw)
    return Image(target, view.channels, linear_to_srgb_u8(out))


def resize_mask(img: ImageView | Image, target: Extent,
                out: np.ndarray | None = None) -> np.ndarray:
    """Single-channel mask resize: box filter, linear colourspace
    (image.cpp:53-62), through the filter's nonzero taps (within 1 level
    of the dense products)."""
    view = img.view() if isinstance(img, Image) else img
    arr = view.pixels
    if arr.ndim == 3:
        if arr.shape[2] != 1:
            raise ValueError(
                f"resize_mask is single-channel only (got {arr.shape[2]} "
                f"channels) — use resize() for colour images")
        arr = arr[:, :, 0]
    res = _resample_taps(arr[:, :, None].astype(np.float64) / 255.0, target,
                         "box")
    res = np.clip(np.round(res[:, :, 0] * 255.0), 0, 255).astype(np.uint8)
    if out is not None:
        out[...] = res.reshape(out.shape)
        return out
    return res
