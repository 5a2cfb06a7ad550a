"""The port's image file I/O (image/io.py, ``Image.load`` / ``Image.save``)
against the JAX package's ``image/io.py``, on the same files, written into
``tmp_path`` from numpy seeds: both must decode every file to the same
channels and the same pixels, and refuse the same files with their
``DlimgError``. Pillow is imported at first use: without it the Pillow
containers raise ``DlimgError`` while HDR and PIC, read by the package's
own readers, still load.
"""

import struct
import sys

import numpy as np
import pytest
from PIL import Image as PILImage

import dlimgedit_tpu.errors as jerr
from dlimgedit_tpu.image import io as jio
from dlimgedit_tpu_torch import errors as perr
from dlimgedit_tpu_torch.image import io as pio
from dlimgedit_tpu_torch.types import Channels, Extent, Image, ImageView


def _rng(seed):
    return np.random.default_rng(seed)


def _assert_same(path):
    got, want = pio.load_image(str(path)), jio.load_image(str(path))
    assert got.channels.name == want.channels.name
    assert tuple(got.extent) == tuple(want.extent)
    assert got.pixels.dtype == np.uint8
    np.testing.assert_array_equal(got.pixels, want.pixels)
    return got


@pytest.mark.parametrize("channels", [Channels.mask, Channels.rgb, Channels.rgba])
def test_png_round_trip_matches_jax(tmp_path, channels):
    c = {Channels.mask: 1, Channels.rgb: 3, Channels.rgba: 4}[channels]
    px = _rng(c).integers(0, 256, (13, 17, c), dtype=np.uint8)
    p = tmp_path / "img.png"
    pio.save_image(ImageView(px, Extent(17, 13), channels), str(p))
    got = _assert_same(p)
    assert got.channels == channels
    np.testing.assert_array_equal(got.pixels, px)


@pytest.mark.parametrize("mode,suffix", [("RGB", ".jpg"), ("L", ".jpg"),
                                         ("RGB", ".gif"), ("RGB", ".ppm"),
                                         ("RGB", ".bmp"), ("LA", ".png"),
                                         ("P", ".png")])
def test_pillow_containers_match_jax(tmp_path, mode, suffix):
    """JPEG (shape and channels after the lossy round trip), GIF (always
    RGBA, as stb), PNM, BMP, gray + alpha (promoted to RGBA), palette."""
    rgb = _rng(7).integers(0, 256, (10, 14, 3), dtype=np.uint8)
    im = PILImage.fromarray(rgb).convert(mode)
    p = tmp_path / f"img{suffix}"
    im.save(p)
    got = _assert_same(p)
    assert tuple(got.extent) == (14, 10)


def test_16bit_png_keeps_the_high_byte(tmp_path):
    wide = (_rng(8).integers(0, 65536, (6, 9))).astype(np.uint16)
    p = tmp_path / "g16.png"
    PILImage.fromarray(wide).save(p)
    got = _assert_same(p)
    np.testing.assert_array_equal(got.pixels[:, :, 0], (wide >> 8).astype(np.uint8))


def _hdr(w, rows):
    data = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {len(rows)} +X {w}\n".encode()
    return data + b"".join(rows)


def test_hdr_matches_jax(tmp_path):
    w = 8
    rle = bytes([2, 2, 0, w]) + b"".join(bytes([128 + w, v]) for v in (128, 64, 0, 129))
    lit = bytes([2, 2, 0, w]) + b"".join(bytes([w]) + bytes([v]) * w
                                        for v in (200, 10, 255, 128))
    p = tmp_path / "img.hdr"
    p.write_bytes(_hdr(w, [rle, lit]))
    got = _assert_same(p)
    assert got.channels == Channels.rgb and got.extent == Extent(w, 2)
    # Flat scanlines (a width below 8 has no RLE form).
    flat = _rng(9).integers(0, 256, (3, 5, 4), dtype=np.uint8)
    p.write_bytes(_hdr(5, [r.tobytes() for r in flat]))
    _assert_same(p)


def _pic_header(w, h):
    return (struct.pack(">I", 0x5380F634) + struct.pack(">f", 3.71)
            + b"c" * 80 + b"PICT" + struct.pack(">HH", w, h)
            + struct.pack(">f", 1.0) + struct.pack(">HH", 3, 0))


def test_pic_matches_jax(tmp_path):
    """Raw RGB, mixed RLE with a raw alpha packet, the long-run form and
    pure RLE with its end-of-scanline clamp."""
    arr = _rng(13).integers(0, 256, (4, 6, 4), dtype=np.uint8)
    p = tmp_path / "img.pic"
    p.write_bytes(_pic_header(6, 4) + bytes([0, 8, 0, 0xE0])
                  + b"".join(arr[y, :, :3].tobytes() for y in range(4)))
    assert _assert_same(p).channels == Channels.rgb
    arr[:, 1:4] = arr[:, 1:2]
    body = b"".join(bytes([0]) + arr[y, 0, :3].tobytes()
                    + bytes([130]) + arr[y, 1, :3].tobytes()
                    + bytes([1]) + arr[y, 4:6, :3].tobytes()
                    + arr[y, :, 3].tobytes() for y in range(4))
    p.write_bytes(_pic_header(6, 4) + bytes([1, 8, 2, 0xE0])
                  + bytes([0, 8, 0, 0x10]) + body)
    got = _assert_same(p)
    assert got.channels == Channels.rgba
    np.testing.assert_array_equal(got.pixels, arr)
    p.write_bytes(_pic_header(300, 1) + bytes([0, 8, 2, 0xE0]) + bytes([128])
                  + (300).to_bytes(2, "big") + bytes([9, 8, 7]))
    _assert_same(p)
    p.write_bytes(_pic_header(5, 2) + bytes([0, 8, 1, 0xE0])
                  + bytes([3, 1, 2, 3, 9, 4, 5, 6, 5, 7, 8, 9]))
    _assert_same(p)


@pytest.mark.parametrize("name,payload", [
    ("trunc.hdr", b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 4 +X 16\n\x02\x02"),
    ("layout.hdr", b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 4 -X 16\n"),
    ("trunc.pic", _pic_header(6, 4) + bytes([0, 8, 0, 0xE0]) + b"\x01\x02"),
    ("run.pic", _pic_header(2, 1) + bytes([0, 8, 2, 0xE0]) + bytes([132]) + b"\x01\x02\x03"),
    ("zero.pic", _pic_header(5, 1) + bytes([0, 8, 1, 0xE0]) + bytes([0, 1, 2, 3])),
    ("huge.pic", _pic_header(32768, 32768) + bytes([0, 8, 0, 0xE0])),
    ("bits.pic", _pic_header(2, 1) + bytes([0, 16, 0, 0xE0])),
    ("junk.png", b"not an image at all"),
])
def test_unsupported_files_raise_like_jax(tmp_path, name, payload):
    p = tmp_path / name
    p.write_bytes(payload)
    with pytest.raises(jerr.DlimgError) as want:
        jio.load_image(str(p))
    with pytest.raises(perr.DlimgError) as got:
        pio.load_image(str(p))
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_missing_file_and_unsupported_save_raise(tmp_path):
    with pytest.raises(perr.DlimgError, match="Failed to load image"):
        pio.load_image(str(tmp_path / "missing.png"))
    px = np.zeros((4, 4, 4), np.uint8)
    with pytest.raises(perr.UnsupportedImageError, match="Unsupported channel order"):
        pio.save_image(ImageView(px, Extent(4, 4), Channels.bgra),
                       str(tmp_path / "x.png"))
    with pytest.raises(jerr.UnsupportedImageError):
        jio.save_image(jio.ImageView(px, jio.Extent(4, 4), jio.Channels.bgra),
                       str(tmp_path / "y.png"))


def test_image_load_and_save_round_trip(tmp_path):
    px = _rng(3).integers(0, 256, (9, 11, 4), dtype=np.uint8)
    img = Image(Extent(11, 9), Channels.rgba, px)
    img.save(tmp_path / "a.png")
    Image.save(img.view(), tmp_path / "b.png")
    for name in ("a.png", "b.png"):
        back = Image.load(tmp_path / name)
        assert back.channels == Channels.rgba and back.extent == img.extent
        np.testing.assert_array_equal(back.pixels, px)


def test_without_pillow_only_hdr_and_pic_load(tmp_path, monkeypatch):
    hdr = tmp_path / "img.hdr"
    hdr.write_bytes(_hdr(2, [bytes([9, 9, 9, 130] * 2)]))
    png = tmp_path / "img.png"
    PILImage.fromarray(np.zeros((2, 2, 3), np.uint8)).save(png)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert pio.load_image(str(hdr)).extent == Extent(2, 1)
    with pytest.raises(perr.DlimgError, match="Pillow not installed"):
        pio.load_image(str(png))
    with pytest.raises(perr.DlimgError, match="Pillow not installed"):
        pio.save_image(ImageView(np.zeros((2, 2, 3), np.uint8), Extent(2, 2),
                                 Channels.rgb), str(tmp_path / "o.png"))
