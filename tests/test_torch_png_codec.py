"""The port's own PNG codec (dlimgedit_tpu_torch/native/src/png.cpp) through
the C library's ``load_image`` / ``save_image``, on the CPU.

The library is loaded with ctypes into this process: a PNG never reaches
the bridge, so no interpreter state is touched.

- Decode corpus: one case per colour type and bit depth, with ``tRNS``,
  with Adam7 interlacing, under each of the five filters and their mix,
  and with stored, fixed- and dynamic-Huffman deflate data split over many
  IDAT chunks. The files are written here by a small numpy and ``zlib``
  writer that can set every field. The expected pixels are computed in
  numpy from the source samples by the libpng path's rules (16-bit samples
  keep their high byte, gray below 8 bits is scaled to 8 bits, palette
  becomes RGB or RGBA with tRNS, gray with tRNS and gray+alpha become RGBA).
  Where the JAX package's library is built (native/build, with libpng),
  its ``load_image`` gives the same pixels.
- Pillow's own files in modes 1, L, I;16, RGB, RGBA, P (with and without
  transparency) and LA decode to Pillow's pixels converted by those rules.
- The encoder: files of 1, 3 and 4 channels, tight and with padded rows,
  decode in Pillow to the source; a seeded 1024 x 768 mask's file is
  within 4x of Pillow's default encoding.
- Corrupt input (a wrong CRC-32 or Adler-32, truncation, too much or too
  little data, an oversized IHDR, a bad filter type, bit depth or chunk
  length) fails with the codec's message.
- The library links no libpng: ``ldd`` shows it on this machine, which
  has libpng, so the tests run the path the card's machine runs.
"""

import ctypes
import io
import shutil
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np
import pytest

from dlimgedit_tpu_torch import native_build

ROOT = Path(__file__).resolve().parent.parent
JAX_LIBRARY = ROOT / "native" / "build" / "libdlimgedit_tpu.so"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.fixture(scope="module")
def build():
    if native_build.compiler() is None:
        pytest.skip("no C++ compiler installed")
    return native_build.build()


@pytest.fixture(scope="module")
def api(build):
    return native_build.load_api(build.library)


@pytest.fixture(scope="module")
def jax_api():
    """The JAX package's library (libpng) where it is built, else None."""
    return native_build.load_api(JAX_LIBRARY) if JAX_LIBRARY.is_file() else None


def load(api, path):
    """-> (pixels (h, w, c), None) or (None, the library's error)."""
    ext, ch = (ctypes.c_int * 2)(), ctypes.c_int()
    px = ctypes.POINTER(ctypes.c_uint8)()
    if api.load_image(str(path).encode(), ext, ctypes.byref(ch),
                      ctypes.byref(px)):
        return None, api.last_error().decode()
    w, h, c = ext[0], ext[1], ch.value
    out = np.frombuffer(ctypes.string_at(px, w * h * c), np.uint8)
    api.destroy_image(px)
    return out.reshape(h, w, c), None


def save(api, path, arr, pad=0):
    """Save an (h, w, c) array through a buffer whose rows are `pad` bytes
    longer than the image's."""
    h, w, c = arr.shape
    buf = np.full((h, w * c + pad), 0xAB, np.uint8)
    buf[:, :w * c] = arr.reshape(h, w * c)
    img = native_build.DlimgImageView(
        width=w, height=h, channels=c, stride=buf.shape[1] if pad else 0,
        pixels=buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if api.save_image(ctypes.byref(img), str(path).encode()):
        raise AssertionError(api.last_error().decode())


# -- a PNG writer that sets every field ------------------------------------


def chunk(tag: bytes, body: bytes, crc=None) -> bytes:
    crc = zlib.crc32(tag + body) if crc is None else crc
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", crc)


def pack_rows(samples, depth):
    """(h, w, nc) samples at `depth` -> h rows of packed bytes."""
    h, w, nc = samples.shape
    flat = samples.reshape(h, w * nc).astype(np.uint32)
    if depth == 16:
        return [r.astype(">u2").tobytes() for r in flat]
    if depth == 8:
        return [r.astype(np.uint8).tobytes() for r in flat]
    bits = (flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return [np.packbits(r.reshape(-1).astype(np.uint8)).tobytes()
            for r in bits]


def paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(rows, bpp, filters):
    """Each row after its filter-type byte, the types cycling `filters`."""
    out, prev = [], np.zeros(len(rows[0]), np.int32)
    for y, row in enumerate(rows):
        r = np.frombuffer(row, np.uint8).astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])[:len(r)]
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])[:len(r)]
        t = filters[y % len(filters)]
        pred = {0: 0, 1: left, 2: prev, 3: (left + prev) >> 1,
                4: paeth(left, prev, upleft)}[t]
        out.append(bytes([t]) + ((r - pred) & 255).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def image_data(samples, depth, color, interlace, filters):
    nc = CHANNELS[color]
    bpp = max(1, nc * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            data += filter_rows(pack_rows(sub, depth), bpp, filters)
    return data


def compress(data, mode):
    if mode == "stored":
        return zlib.compress(data, 0)
    if mode == "fixed":
        z = zlib.compressobj(9, zlib.DEFLATED, 15, 9, zlib.Z_FIXED)
        return z.compress(data) + z.flush()
    return zlib.compress(data, 9)


def png_file(samples, depth, color, *, plte=None, trns=None, interlace=0,
             filters=(0,), deflate="dynamic", split=0, raw=None):
    h, w, _ = samples.shape
    z = compress(image_data(samples, depth, color, interlace, filters)
                 if raw is None else raw, deflate)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    out += chunk(b"tEXt", b"Comment\x00an ancillary chunk")
    if plte is not None:
        out += chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        body = (bytes(np.asarray(trns, np.uint8)) if color == 3
                else struct.pack(f">{len(trns)}H", *trns))
        out += chunk(b"tRNS", body)
    step = split or len(z)
    for i in range(0, len(z), step):
        out += chunk(b"IDAT", z[i:i + step])
    return out + chunk(b"IEND", b"")


def expected(samples, depth, color, plte=None, trns=None):
    """The libpng path's pixels for the source samples."""
    s = samples.astype(np.uint32)
    to8 = (s >> 8 if depth == 16
           else s * {1: 255, 2: 85, 4: 17, 8: 1}[depth]).astype(np.uint8)
    opaque = np.full(s.shape[:2], 255, np.uint8)
    if color == 0:
        g = to8[..., :1]
        if trns is None:
            return g
        a = np.where(s[..., 0] == trns[0], 0, opaque).astype(np.uint8)
        return np.dstack([g, g, g, a])
    if color == 2:
        if trns is None:
            return to8
        a = np.where((s == np.asarray(trns)).all(-1), 0, opaque)
        return np.dstack([to8, a.astype(np.uint8)])
    if color == 3:
        idx = s[..., 0]
        table = np.zeros((256, 3), np.uint8)
        table[:len(plte)] = plte
        if trns is None:
            return table[idx]
        alpha = np.full(256, 255, np.uint8)
        alpha[:len(trns)] = trns
        return np.dstack([table[idx], alpha[idx]])
    if color == 4:
        g = to8[..., :1]
        return np.dstack([g, g, g, to8[..., 1:]])
    return to8


def case(color, depth, *, trns=False, interlace=0, filters=(0, 1, 2, 3, 4),
         deflate="dynamic", split=0, hw=(11, 13), seed=0):
    return pytest.param(dict(color=color, depth=depth, trns=trns,
                             interlace=interlace, filters=filters,
                             deflate=deflate, split=split, hw=hw, seed=seed),
                        id=f"c{color}-d{depth}{'-trns' if trns else ''}"
                           f"{'-adam7' if interlace else ''}-f"
                           f"{''.join(map(str, filters))}-{deflate}"
                           f"{f'-split{split}' if split else ''}-{hw[0]}x{hw[1]}")


CORPUS = [
    *(case(0, d) for d in (1, 2, 4, 8, 16)),
    case(0, 2, trns=True), case(0, 8, trns=True), case(0, 16, trns=True),
    case(2, 8), case(2, 16), case(2, 8, trns=True), case(2, 16, trns=True),
    *(case(3, d) for d in (1, 2, 4, 8)),
    case(3, 2, trns=True), case(3, 8, trns=True),
    case(4, 8), case(4, 16), case(6, 8), case(6, 16),
    *(case(2, 8, filters=(f,), seed=f) for f in range(5)),
    *(case(6, 16, filters=(f,), seed=f) for f in range(5)),
    *(case(0, 1, filters=(f,), hw=(9, 21), seed=f) for f in range(5)),
    case(0, 1, interlace=1, hw=(9, 10)), case(0, 4, interlace=1, hw=(5, 17)),
    case(0, 16, trns=True, interlace=1, hw=(8, 8)),
    case(2, 8, interlace=1, hw=(9, 10)), case(2, 16, interlace=1, hw=(3, 2)),
    case(3, 4, trns=True, interlace=1, hw=(13, 11)),
    case(3, 1, interlace=1, hw=(1, 1)), case(4, 8, interlace=1, hw=(2, 3)),
    case(6, 16, interlace=1, hw=(16, 16)), case(6, 8, interlace=1, hw=(7, 1)),
    case(2, 8, deflate="stored", split=7), case(6, 8, deflate="fixed", split=1),
    case(0, 8, trns=True, deflate="fixed"), case(3, 8, split=3),
    case(2, 8, hw=(120, 97), deflate="stored"),
    case(6, 8, hw=(64, 300), split=1000, seed=3),
]


def corpus_file(p):
    rng = np.random.default_rng(p["seed"])
    h, w = p["hw"]
    color, depth = p["color"], p["depth"]
    nc = CHANNELS[color]
    plte = trns = None
    if color == 3:
        plte = rng.integers(0, 256, (min(1 << depth, 200), 3))
        samples = rng.integers(0, len(plte), (h, w, 1))
        if p["trns"]:
            trns = rng.integers(0, 256, max(1, len(plte) // 2))
    else:
        samples = rng.integers(0, 1 << depth, (h, w, nc))
        if p["trns"]:
            trns = [int(v) for v in rng.integers(0, 1 << depth, nc)]
            samples[rng.random((h, w)) < 0.3] = trns  # pixels on the key
    data = png_file(samples, depth, color, plte=plte, trns=trns,
                    interlace=p["interlace"], filters=p["filters"],
                    deflate=p["deflate"], split=p["split"])
    return data, expected(samples, depth, color, plte, trns)


@pytest.mark.parametrize("p", CORPUS)
def test_decode_corpus_gives_the_libpng_paths_pixels(api, jax_api, tmp_path,
                                                     p):
    data, want = corpus_file(p)
    path = tmp_path / "in.png"
    path.write_bytes(data)
    got, err = load(api, path)
    assert err is None, err
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if jax_api is not None:  # the JAX package's libpng load_image
        theirs, err = load(jax_api, path)
        assert err is None, err
        np.testing.assert_array_equal(got, theirs)


PILLOW_MODES = ("1", "L", "I;16", "RGB", "RGBA", "P", "P+transparency", "LA")


@pytest.mark.parametrize("mode", PILLOW_MODES)
def test_pillows_files_decode_to_pillows_pixels(api, jax_api, tmp_path, mode):
    from PIL import Image as PILImage

    rng = np.random.default_rng(len(mode))
    rgba = rng.integers(0, 256, (37, 53, 4), dtype=np.uint8)
    rgba[5:20, 10:40] = (200, 40, 40, 255)  # runs for the compressor
    base = PILImage.fromarray(rgba, "RGBA")
    path = tmp_path / "pil.png"
    if mode == "I;16":
        arr16 = rng.integers(0, 65536, (37, 53), dtype=np.uint16)
        PILImage.fromarray(arr16).save(path)  # mode I;16
        want = (arr16 >> 8).astype(np.uint8)[..., None]
    elif mode.startswith("P"):
        img = base.convert("RGB").quantize(64)
        if mode == "P+transparency":
            img.save(path, transparency=bytes(range(0, 256, 8)))
            want = np.asarray(PILImage.open(path).convert("RGBA"))
        else:
            img.save(path)
            want = np.asarray(PILImage.open(path).convert("RGB"))
    else:
        base.convert(mode).save(path)
        conv = {"1": "L", "L": "L", "RGB": "RGB", "RGBA": "RGBA",
                "LA": "RGBA"}[mode]
        want = np.asarray(PILImage.open(path).convert(conv))
        if want.ndim == 2:
            want = want[..., None]
    got, err = load(api, path)
    assert err is None, err
    np.testing.assert_array_equal(got, want)
    if jax_api is not None:
        np.testing.assert_array_equal(got, load(jax_api, path)[0])


@pytest.mark.parametrize("c,pad", [(1, 0), (1, 3), (3, 0), (3, 7), (4, 0),
                                   (4, 12)])
def test_encoded_files_decode_in_pillow_to_the_source(api, tmp_path, c, pad):
    from PIL import Image as PILImage

    rng = np.random.default_rng(c * 10 + pad)
    arr = rng.integers(0, 256, (29, 41, c), dtype=np.uint8)
    arr[3:20, 5:30] = rng.integers(0, 256, c)  # a flat region: matches
    path = tmp_path / f"port_{c}_{pad}.png"
    save(api, path, arr, pad)
    pil = np.asarray(PILImage.open(path))
    np.testing.assert_array_equal(pil.reshape(arr.shape), arr)
    got, err = load(api, path)
    assert err is None, err
    np.testing.assert_array_equal(got, arr)


def seeded_mask(seed=0, h=768, w=1024):
    """A mask as a served one looks: a few filled ellipses, 0 or 255."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    mask = np.zeros((h, w), bool)
    for _ in range(4):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        ry, rx = rng.integers(40, 300, 2)
        mask |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    return (mask * 255).astype(np.uint8)


def test_a_served_size_mask_is_within_4x_of_pillows_bytes(api, tmp_path):
    from PIL import Image as PILImage

    mask = seeded_mask()
    path = tmp_path / "mask.png"
    save(api, path, mask[..., None])
    buf = io.BytesIO()
    PILImage.fromarray(mask, "L").save(buf, format="PNG")
    mine, pillow = path.stat().st_size, len(buf.getvalue())
    assert mine <= 4 * pillow, (mine, pillow)
    np.testing.assert_array_equal(np.asarray(PILImage.open(path)), mask)
    # A constant mask: every row one long run.
    save(api, path, np.zeros((768, 1024, 1), np.uint8))
    buf = io.BytesIO()
    PILImage.fromarray(np.zeros((768, 1024), np.uint8)).save(buf, "PNG")
    assert path.stat().st_size <= 4 * len(buf.getvalue())


def _good():
    rng = np.random.default_rng(5)
    samples = rng.integers(0, 256, (12, 16, 3))
    return samples, image_data(samples, 8, 2, 0, (0, 1, 2, 3, 4))


def _with_adler(raw: bytes, delta: int) -> bytes:
    z = bytearray(zlib.compress(raw))
    z[-1] ^= delta
    return bytes(z)


def _idat_of(z: bytes, w=16, h=12, depth=8, color=2) -> bytes:
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                         0, 0))
            + chunk(b"IDAT", z) + chunk(b"IEND", b""))


def corrupt_cases():
    samples, raw = _good()
    good = png_file(samples, 8, 2, filters=(0, 1, 2, 3, 4))
    idat_at = good.index(b"IDAT")
    bad_crc = bytearray(good)
    bad_crc[idat_at + 10] ^= 0x40  # the body changes, its CRC does not
    bad_filter = bytearray(raw)
    bad_filter[3 * (16 * 3 + 1)] = 5  # row 3's filter type
    return {
        "crc": (bytes(bad_crc), "CRC-32 mismatch"),
        "adler": (_idat_of(_with_adler(raw, 1)), "Adler-32"),
        "truncated in IDAT": (good[:idat_at + 40], "truncated"),
        "truncated before IEND": (good[:-12], "missing"),
        "truncated zlib stream": (_idat_of(zlib.compress(raw)[:-30]),
                                  "truncated zlib stream"),
        "too much data": (_idat_of(zlib.compress(raw + b"\0" * 40)),
                          "more than"),
        "too little data": (_idat_of(zlib.compress(raw[:-20])),
                            "the image needs"),
        "oversized IHDR": (_idat_of(zlib.compress(raw), w=200000, h=100000,
                                    color=6), "over the decoder's"),
        "IHDR larger than its data": (_idat_of(zlib.compress(raw), w=6000,
                                               h=5000), "cannot inflate"),
        "bad filter type": (_idat_of(zlib.compress(bytes(bad_filter))),
                            "bad filter type 5"),
        "bad bit depth": (_idat_of(zlib.compress(raw), depth=3, color=0),
                          "bad bit depth"),
        "chunk length": (good[:33] + struct.pack(">I", 0xFFFFFFF0)
                         + good[37:], "chunk length"),
        "no IDAT": (good[:33] + chunk(b"IEND", b""), "no IDAT"),
    }


@pytest.mark.parametrize("name", list(corrupt_cases()))
def test_corrupt_input_fails_with_the_codecs_message(api, tmp_path, name):
    data, words = corrupt_cases()[name]
    path = tmp_path / "bad.png"
    path.write_bytes(data)
    got, err = load(api, path)
    assert got is None
    assert err.startswith("load_image: png: ") and words in err, err


def test_the_library_links_no_libpng(build):
    assert build.codecs[0] == "png"
    if shutil.which("ldd") is None:
        pytest.skip("no ldd on this machine")
    out = subprocess.run(["ldd", str(build.library)], capture_output=True,
                         text=True, check=True).stdout
    assert "libpython" in out  # ldd read the library's dependencies
    assert "libpng" not in out and "libz." not in out, out
