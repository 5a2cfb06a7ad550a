"""The port's native host loops (utils/hostops.py, csrc/hostops.cpp), on the
CPU:

  * the native channel-map pack is byte-equal to its numpy plain version
    (``ops/preprocess.py::pack_rows_plain``) for every ``Channels``, on
    odd widths, padded rows and pixels that are not packed, whole and in
    row chunks, and through ``pack_rgb_canvas``;
  * its bounds are checked before the native loop runs;
  * ``resize_mask_box`` agrees with ``image/resize.py::resize_mask``
    within one grey level, differing on under 0.5% of pixels (a .5 tie
    that two float64 summation orders round apart), as the JAX package
    holds its own native resize;
  * a compiler that fails raises ``DlimgError`` and nothing falls back to
    numpy.
"""

from pathlib import Path

import numpy as np
import pytest

from dlimgedit_tpu_torch.errors import DlimgError
from dlimgedit_tpu_torch.image.resize import resize_mask
from dlimgedit_tpu_torch.ops import preprocess
from dlimgedit_tpu_torch.types import RGB_CHANNEL_MAP, Channels, Extent, ImageView
from dlimgedit_tpu_torch.utils import hostops

CHANNELS = {Channels.mask: 1, Channels.rgb: 3, Channels.rgba: 4,
            Channels.bgra: 4, Channels.argb: 4}


def _pixels(h, w, c, seed, pad=13):
    """(h, w, c) uint8 with rows `pad` bytes longer than the pixels."""
    base = np.random.default_rng(seed).integers(0, 256, (h, w * c + pad),
                                                dtype=np.uint8)
    return base[:, :w * c].reshape(h, w, c)


@pytest.mark.parametrize("w", [1, 37, 1023])
@pytest.mark.parametrize("channels", list(CHANNELS))
def test_native_pack_equals_numpy(channels, w):
    h, bucket = 29, 1024
    arr = _pixels(h, w, CHANNELS[channels], w)
    cmap = RGB_CHANNEL_MAP[channels]
    for step in (h, 7, 1):  # whole, row chunks, single rows
        got = np.full((bucket, bucket, 3), 7, np.uint8)
        want = got.copy()
        for r0 in range(0, h, step):
            r1 = min(r0 + step, h)
            preprocess._pack_rows(arr, cmap, got, r0, r1, w)
            preprocess.pack_rows_plain(arr, cmap, want, r0, r1, w)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", list(CHANNELS))
def test_pack_rgb_canvas_is_the_numpy_pack(channels):
    arr = _pixels(37, 53, CHANNELS[channels], 1)
    view = ImageView(arr[:, :, 0] if channels is Channels.mask else arr,
                     Extent(53, 37), channels)
    want = np.zeros((64, 64, 3), np.uint8)
    preprocess.pack_rows_plain(arr, RGB_CHANNEL_MAP[channels], want, 0, 37, 53)
    np.testing.assert_array_equal(preprocess.pack_rgb_canvas(view, 64), want)


def test_native_pack_takes_any_source_layout():
    """Pixels that are not packed (every other column, a flipped image) are
    made packed first; the result is the numpy pack's."""
    arr = _pixels(20, 60, 4, 2)
    for src in (arr[:, ::2], arr[::-1], np.asfortranarray(arr)):
        got = np.zeros((64, 64, 3), np.uint8)
        want = got.copy()
        w = src.shape[1]
        hostops.pack_rgb(src, (2, 1, 0), got, 20, w)
        preprocess.pack_rows_plain(src, (2, 1, 0), want, 0, 20, w)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,cmap", [(33, 8, (0, 1, 2)), (8, 33, (0, 1, 2)),
                                      (21, 8, (0, 1, 2)), (8, 8, (0, 1, 4)),
                                      (8, 8, (-1, 1, 2))])
def test_native_pack_checks_its_bounds(h, w, cmap):
    src = _pixels(20, 30, 4, 3)
    dst = np.zeros((32, 32, 3), np.uint8)
    with pytest.raises(DlimgError, match="out of bounds"):
        hostops.pack_rgb(src, cmap, dst, h, w)


@pytest.mark.parametrize("src_shape,dst_shape", [((64, 64), (37, 53)),
                                                 ((33, 47), (128, 96)),
                                                 ((128, 128), (128, 128)),
                                                 ((1024, 1024), (640, 480))])
@pytest.mark.parametrize("binary", [False, True])
def test_resize_mask_box_matches_resize_mask(src_shape, dst_shape, binary):
    src = np.random.default_rng(5).integers(0, 256, src_shape, dtype=np.uint8)
    if binary:
        src = (src > 127).astype(np.uint8) * 255
    dh, dw = dst_shape
    want = resize_mask(ImageView.from_array(src, Channels.mask), Extent(dw, dh))
    got = np.empty((dh, dw), np.uint8)
    hostops.resize_mask_box(src, got)
    diff = np.abs(got.astype(np.int16) - want.reshape(dh, dw).astype(np.int16))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.005


@pytest.mark.parametrize("compiler", ["fails", "missing"])
def test_a_failing_build_raises(tmp_path, monkeypatch, compiler):
    if compiler == "fails":
        cxx = tmp_path / "cxx"
        cxx.write_text("#!/bin/sh\necho 'broken compiler' >&2\nexit 1\n")
        cxx.chmod(0o755)
    else:
        cxx = tmp_path / "no-such-compiler"
    monkeypatch.setattr(hostops, "CXX", str(cxx))
    monkeypatch.setattr(hostops, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(hostops, "LIBRARY", hostops.HostOpsLibrary())
    with pytest.raises(DlimgError, match="failed"):
        hostops.LIBRARY.get()
    view = ImageView(_pixels(8, 8, 3, 4), Extent(8, 8), Channels.rgb)
    with pytest.raises(DlimgError, match="failed"):
        preprocess.pack_rgb_canvas(view, 256)
    assert not list((tmp_path / "build").glob("*.so"))


def test_package_data_ships_every_csrc_source():
    """Each file of the port's csrc/ matches a package-data glob of
    pyproject.toml, so an installed port carries every source it builds
    (the host pack's hostops.cpp included)."""
    import fnmatch
    import tomllib

    root = Path(__file__).resolve().parent.parent
    data = tomllib.loads((root / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["dlimgedit_tpu_torch"]
    csrc = root / "dlimgedit_tpu_torch" / "csrc"
    files = sorted(f.relative_to(csrc.parent).as_posix()
                   for f in csrc.iterdir() if f.is_file())
    assert "csrc/hostops.cpp" in files
    missing = [f for f in files
               if not any(fnmatch.fnmatch(f, g) for g in globs)]
    assert not missing, f"not shipped by the package data: {missing}"


def test_a_missing_source_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(hostops, "SOURCE", tmp_path / "hostops.cpp")
    monkeypatch.setattr(hostops, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(hostops, "LIBRARY", hostops.HostOpsLibrary())
    with pytest.raises(DlimgError, match="hostops.cpp"):
        hostops.LIBRARY.get()
