"""Image file I/O (counterpart of dlimgedit_tpu/image/io.py).

Loads any container the reference's stb loader reads (PNG, JPEG, BMP, TGA,
PNM, GIF, PSD, HDR, PIC), keeping the file's channel count and accepting
1, 3 or 4 channels; saves PNG (mask, rgb or rgba only). Pillow decodes and
encodes the common containers and is imported only when it is needed: its
absence raises ``DlimgError``. Radiance HDR and Softimage PIC, for which
Pillow has no plugin, have readers of their own here (the HDR conversion
is stb's LDR default, gamma 2.2 and scale 1), which need no Pillow.
"""

from __future__ import annotations

import numpy as np

from ..errors import DlimgError, UnsupportedImageError
from ..types import Channels, Extent, Image, ImageView, channel_count


def _pillow():
    """Pillow's Image module, imported at first use."""
    try:
        from PIL import Image as PILImage
    except ImportError as e:
        raise DlimgError("No image codec available (Pillow not installed)") from e
    return PILImage


def _load_hdr(filepath: str) -> np.ndarray:
    """Radiance RGBE (.hdr) -> (h, w, 3) uint8 with stb's hdr_to_ldr
    conversion: v = c * 2^(e-136), ldr = clip(v^(1/2.2) * 255 + 0.5).
    Flat and new-style RLE scanlines; -Y +X orientation."""
    with open(filepath, "rb") as f:
        sig = f.readline()
        if not (sig.startswith(b"#?RADIANCE") or sig.startswith(b"#?RGBE")):
            raise DlimgError(f"{filepath}: not a Radiance HDR file")
        fmt_ok = False
        while True:
            line = f.readline()
            if not line:
                raise DlimgError(f"{filepath}: truncated HDR header")
            if line in (b"\n", b"\r\n"):
                break
            if line.startswith(b"FORMAT=32-bit_rle_rgbe"):
                fmt_ok = True
        res = f.readline().split()
        if not fmt_ok or len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
            raise DlimgError(f"{filepath}: unsupported HDR layout")
        h, w = int(res[1]), int(res[3])
        rgbe = np.empty((h, w, 4), np.uint8)
        data = f.read()
    pos = 0
    for y in range(h):
        if pos + 4 > len(data):
            raise DlimgError(f"{filepath}: truncated HDR scanline")
        hd = data[pos:pos + 4]
        if 8 <= w < 32768 and hd[0] == 2 and hd[1] == 2 and not hd[2] & 0x80:
            if (hd[2] << 8 | hd[3]) != w:
                raise DlimgError(f"{filepath}: HDR scanline length mismatch")
            pos += 4
            for k in range(4):
                x = 0
                while x < w:
                    if pos >= len(data):
                        raise DlimgError(f"{filepath}: truncated HDR rle")
                    cnt = data[pos]
                    pos += 1
                    if cnt > 128:  # run
                        run = cnt - 128
                        if pos >= len(data) or x + run > w:
                            raise DlimgError(f"{filepath}: bad HDR rle run")
                        rgbe[y, x:x + run, k] = data[pos]
                        pos += 1
                        x += run
                    else:  # literals
                        if cnt == 0 or x + cnt > w or pos + cnt > len(data):
                            raise DlimgError(f"{filepath}: bad HDR rle")
                        rgbe[y, x:x + cnt, k] = np.frombuffer(
                            data, np.uint8, cnt, pos)
                        pos += cnt
                        x += cnt
        else:  # flat RGBE
            need = w * 4
            if pos + need > len(data):
                raise DlimgError(f"{filepath}: truncated HDR scanline")
            rgbe[y] = np.frombuffer(data, np.uint8, need, pos).reshape(w, 4)
            pos += need
    c = rgbe[:, :, :3].astype(np.float64)
    e = rgbe[:, :, 3:].astype(np.int32)
    v = c * np.exp2(e - 136.0)
    ldr = np.clip(np.power(v, 1.0 / 2.2) * 255.0 + 0.5, 0, 255)
    ldr[(c == 0) | (e == 0)] = 0
    return ldr.astype(np.uint8)


def _load_pic(filepath: str) -> np.ndarray:
    """Softimage PIC -> (h, w, 3|4) uint8 (Pillow has no PIC plugin).

    stb's reader: 104-byte header,
    chained {chained, bits, type, mask} channel packets, packet type 0 =
    uncompressed / 1 = pure RLE ({count, pixel} pairs, count clamping at
    the scanline end like stb, zero counts rejected) / 2 = mixed RLE
    (count < 128: count+1 literals; 128: BE16 run; > 128: count-127 run);
    masks 0x80/0x40/0x20/0x10 = R/G/B/A. Returns 4 channels when any
    packet carries alpha, else 3.
    """
    with open(filepath, "rb") as f:
        data = f.read()
    if len(data) < 104 or data[88:92] != b"PICT":
        raise DlimgError(f"{filepath}: bad PIC header")
    w = int.from_bytes(data[92:94], "big")
    h = int.from_bytes(data[94:96], "big")
    # Pixel cap: a tiny file claiming 32k x 32k would otherwise force a
    # 4 GiB allocation before any pixel data.
    if not (0 < w <= 1 << 15 and 0 < h <= 1 << 15 and w * h <= 1 << 26):
        raise DlimgError(f"{filepath}: bad PIC dimensions")
    pos = 104
    packets = []
    alpha = False
    while True:
        if len(packets) > 8:
            raise DlimgError(f"{filepath}: too many PIC channel packets")
        if pos + 4 > len(data):
            raise DlimgError(f"{filepath}: truncated PIC channel packets")
        chained, bits, ptype, mask = data[pos:pos + 4]
        pos += 4
        if bits != 8:
            raise DlimgError(f"{filepath}: only 8-bit PIC supported")
        if ptype not in (0, 1, 2):
            raise DlimgError(f"{filepath}: unsupported PIC compression")
        idx = [i for i, b in enumerate((0x80, 0x40, 0x20, 0x10)) if mask & b]
        packets.append((ptype, idx))
        alpha = alpha or bool(mask & 0x10)
        if not chained:
            break
    rgba = np.zeros((h, w, 4), np.uint8)
    rgba[:, :, 3] = 255
    for y in range(h):
        for ptype, idx in packets:
            nc = len(idx)
            if nc == 0:
                continue
            if ptype == 0:  # uncompressed
                need = w * nc
                if pos + need > len(data):
                    raise DlimgError(f"{filepath}: truncated PIC pixels")
                row = np.frombuffer(data[pos:pos + need],
                                    np.uint8).reshape(w, nc)
                rgba[y, :, idx] = row.T
                pos += need
            elif ptype == 1:  # pure RLE: {count, pixel} pairs
                x = 0
                while x < w:
                    if pos + 1 + nc > len(data):
                        raise DlimgError(f"{filepath}: truncated PIC rle")
                    c = data[pos]
                    pos += 1
                    if c == 0:  # no progress: corrupt
                        raise DlimgError(
                            f"{filepath}: zero-length PIC rle run")
                    px = np.frombuffer(data[pos:pos + nc], np.uint8)
                    pos += nc
                    run = min(c, w - x)  # stb clamps at the scanline end
                    rgba[y, x:x + run, idx] = px[:, None]
                    x += run
            else:  # mixed RLE
                x = 0
                while x < w:
                    if pos >= len(data):
                        raise DlimgError(f"{filepath}: truncated PIC rle")
                    c = data[pos]
                    pos += 1
                    if c >= 128:
                        if c == 128:
                            if pos + 2 > len(data):
                                raise DlimgError(
                                    f"{filepath}: truncated PIC rle")
                            run = int.from_bytes(data[pos:pos + 2], "big")
                            pos += 2
                        else:
                            run = c - 127
                        if pos + nc > len(data):
                            raise DlimgError(
                                f"{filepath}: truncated PIC pixels")
                        if x + run > w:
                            raise DlimgError(
                                f"{filepath}: PIC rle run past scanline")
                        px = np.frombuffer(data[pos:pos + nc], np.uint8)
                        pos += nc
                        rgba[y, x:x + run, idx] = px[:, None]
                        x += run
                    else:
                        cnt = c + 1
                        need = cnt * nc
                        if x + cnt > w:
                            raise DlimgError(
                                f"{filepath}: PIC literals past scanline")
                        if pos + need > len(data):
                            raise DlimgError(
                                f"{filepath}: truncated PIC pixels")
                        lit = np.frombuffer(data[pos:pos + need],
                                            np.uint8).reshape(cnt, nc)
                        rgba[y, x:x + cnt, idx] = lit.T
                        pos += need
                        x += cnt
    return rgba if alpha else np.ascontiguousarray(rgba[:, :, :3])


def load_image(filepath: str) -> Image:
    """Load an image file. Supported containers match the reference's stb
    loader: PNG, JPEG, BMP, TGA, PNM, GIF (first frame), PSD, HDR, PIC.

    Keeps the file's native channel count and rejects anything other than
    1/3/4 channels.
    """
    try:
        with open(filepath, "rb") as probe:
            magic = probe.read(4)
            if magic[:2] == b"#?":  # Radiance HDR: no Pillow plugin
                arr = _load_hdr(filepath)
                h, w = arr.shape[:2]
                return Image(Extent(w, h), Channels.rgb, arr)
            if magic == b"\x53\x80\xf6\x34":  # Softimage PIC: ditto
                arr = _load_pic(filepath)
                h, w = arr.shape[:2]
                return Image(Extent(w, h),
                             Channels.rgba if arr.shape[2] == 4
                             else Channels.rgb, arr)
    except OSError as e:
        raise DlimgError(f"Failed to load image {filepath}: {e}") from e
    PILImage = _pillow()
    try:
        with PILImage.open(filepath) as im:
            # Keep native channels like stbi_load(..., desired_channels=0):
            # palette images decode to their underlying mode's channel count.
            # GIF and PSD always decode to RGBA in stb: match that.
            if im.format in ("GIF", "PSD"):
                im = im.convert("RGBA")
            elif im.mode == "P":
                im = im.convert("RGBA" if "transparency" in im.info else "RGB")
            elif im.mode in ("I", "I;16", "I;16B", "I;16L", "I;16N"):
                # 16/32-bit integer grays: stb's 16->8 semantics keep the
                # HIGH byte. PIL's .convert() would CLIP at 255 instead —
                # a full-range 16-bit scan came out 99.6% pure white.
                wide = np.asarray(im)
                # Pick the shift from the SOURCE format, not the container
                # width or the frame's data range: older Pillow (<10.1)
                # opens 16-bit gray PNGs as mode 'I' (32-bit container)
                # with 0..65535 values — keying on itemsize alone would
                # shift those by 24 and black the image out, and keying on
                # the data range would scale a dark frame of a genuine
                # 32-bit sequence differently from a bright one. PNG caps
                # at 16 bits/channel, so mode 'I' from a PNG is always
                # 16-bit data; only true 32-bit containers from other
                # formats (e.g. int32 TIFF) take the high byte of 32.
                if wide.dtype.itemsize == 2 or im.format == "PNG":
                    shift = 8
                else:
                    shift = 24
                im = PILImage.fromarray(
                    np.clip(wide >> shift, 0, 255).astype(np.uint8), "L")
            elif im.mode not in ("L", "RGB", "RGBA"):
                # gray+alpha promotes to RGBA; everything else to 8-bit RGB.
                im = im.convert("RGBA" if im.mode in ("LA", "PA") else "RGB")
            arr = np.asarray(im, dtype=np.uint8)
    except (OSError, ValueError) as e:
        raise DlimgError(f"Failed to load image {filepath}: {e}") from e
    if arr.ndim == 2:
        arr = arr[:, :, None]
    c = arr.shape[2]
    if c not in (1, 3, 4):
        raise UnsupportedImageError(
            f"Unsupported number of channels ({c}) in {filepath}"
        )
    channels = {1: Channels.mask, 3: Channels.rgb, 4: Channels.rgba}[c]
    h, w = arr.shape[:2]
    return Image(Extent(w, h), channels, arr)


def save_image(img: ImageView, filepath: str) -> None:
    """Store an image as a PNG file.

    Only mask/rgb/rgba channel orders are supported, as in the reference.
    """
    if img.channels not in (Channels.mask, Channels.rgb, Channels.rgba):
        raise UnsupportedImageError(f"Unsupported channel order [{img.channels}]")
    PILImage = _pillow()

    arr = np.ascontiguousarray(img.pixels)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    mode = {1: "L", 3: "RGB", 4: "RGBA"}[channel_count(img.channels)]
    try:
        PILImage.fromarray(arr, mode=mode).save(filepath, format="PNG")
    except OSError as e:
        raise DlimgError(f"Failed to save image {filepath}: {e}") from e
