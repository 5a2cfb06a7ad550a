"""Drive the C library (native/build/libdlimgedit_tpu.so, built from the
unedited native/src/capi.cpp) on the port's bridge, on the CPU, in a
process of its own:

    python tests/_torch_bridge_worker.py LIBRARY MODEL_DIR

The library imports its bridge by the name ``dlimgedit_tpu.native_bridge``
and binds it once per process, so this process first puts the port's
``dlimgedit_tpu_torch.native_bridge`` under that name in ``sys.modules``,
with an empty stand-in for its parent package (``PyImport_ImportModule``
imports a dotted name's parent first, and the real parent would import
jax). Then it drives every entry of ``dlimg_init()``'s table that reaches
the bridge and holds each output byte for byte against the same call made
directly on the port's bridge, with the same ctypes buffers, in a second
environment of the same options; also three threads through the library
at once. It fails (non-zero exit) on any difference, and when jax or the
JAX package was imported. The environment variables (DLIMG_*) come from
the caller. The last line of its output is ``{"ok": true, ...}``.
"""

import ctypes
import json
import sys
import tempfile
import threading
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import dlimgedit_tpu_torch.native_bridge as bridge  # noqa: E402

_parent = types.ModuleType("dlimgedit_tpu")
_parent.__path__ = []
_parent.native_bridge = bridge
sys.modules["dlimgedit_tpu"] = _parent
sys.modules["dlimgedit_tpu.native_bridge"] = bridge

from test_native_abi import DlimgApi, DlimgImageView, DlimgOptions  # noqa: E402

U8P = ctypes.POINTER(ctypes.c_uint8)


def check(cond, msg):
    if not cond:
        print(f"FAILED: {msg}", file=sys.stderr)
        sys.exit(1)


def pixels(h, w, c, stride, seed):
    """A caller's buffer: rows of `stride` bytes, `w * c` of them pixels,
    the rest a pattern no pixel copy may read."""
    buf = (ctypes.c_uint8 * (stride * h))()
    arr = np.frombuffer(buf, np.uint8).reshape(h, stride)
    arr[:] = 77
    arr[:, :w * c] = np.random.default_rng(seed).integers(
        0, 256, (h, w * c), dtype=np.uint8)
    return buf


def out_buffers(n, size):
    bufs = [(ctypes.c_uint8 * size)() for _ in range(n)]
    return bufs, (U8P * n)(*[ctypes.cast(b, U8P) for b in bufs])


def addresses(bufs):
    return [ctypes.addressof(b) for b in bufs]


def same(a, b, what):
    check(bytes(a) == bytes(b), f"{what}: the library's bytes differ from "
          f"the bridge's")


def main(lib_path: str, model_dir: str, tmp: str) -> int:
    lib = ctypes.CDLL(lib_path)
    lib.dlimg_init.restype = ctypes.POINTER(DlimgApi)
    api = lib.dlimg_init().contents

    def ok(rc, what):
        check(rc == 0, f"{what}: rc {rc}: {api.last_error().decode()}")

    import torch

    check(api.is_backend_supported(0) == 1, "backend 0 unsupported")
    check(api.is_backend_supported(1) == int(torch.cuda.is_available()),
          "backend 1's support is not torch.cuda.is_available()")
    handle = ctypes.c_void_p()
    if not torch.cuda.is_available():
        gpu = DlimgOptions(backend=1, model_directory=model_dir.encode())
        check(api.create_environment(ctypes.byref(handle), ctypes.byref(gpu))
              == 1 and b"no CUDA device" in api.last_error(),
              "backend 1 without CUDA did not fail with the port's error")
    opts = DlimgOptions(backend=0, model_directory=model_dir.encode())
    ok(api.create_environment(ctypes.byref(handle), ctypes.byref(opts)),
       "create_environment")
    env = bridge.create_environment(0, model_dir)  # the direct calls' twin

    h, w, c = 48, 72, 4
    stride = w * c + 12
    src = pixels(h, w, c, stride, 1)
    view = DlimgImageView(width=w, height=h, channels=c, stride=stride,
                          pixels=ctypes.cast(src, U8P))
    seg = ctypes.c_void_p()
    ok(api.process_image_for_segmentation(ctypes.byref(seg),
                                          ctypes.byref(view), handle),
       "process")
    pseg = bridge.process(env, ctypes.addressof(src), w, h, c, stride)
    extent = (ctypes.c_int * 2)()
    api.get_segmentation_extent(seg, extent)
    check((extent[0], extent[1]) == bridge.segmentation_extent(pseg) == (w, h),
          "extent")

    n = h * w
    acc, pacc = (ctypes.c_float * 3)(), (ctypes.c_float * 3)()
    for label, point, region in (("point", (30, 20), None),
                                 ("region", None, (5, 6, 60, 40))):
        bufs, ptrs = out_buffers(1, n)
        ptr3 = (U8P * 3)(ptrs[0], None, None)
        ok(api.get_segmentation_mask(
            seg, (ctypes.c_int * 2)(*point) if point else None,
            (ctypes.c_int * 4)(*region) if region else None, ptr3, acc),
           f"{label} mask")
        mine, _ = out_buffers(1, n)
        bridge.compute_mask(pseg, point, region,
                            [ctypes.addressof(mine[0]), 0, 0],
                            ctypes.addressof(pacc))
        same(bufs[0], mine[0], f"{label} mask")
    bufs, ptrs = out_buffers(3, n)
    ok(api.get_segmentation_mask(seg, (ctypes.c_int * 2)(30, 20), None, ptrs,
                                 acc), "three masks")
    mine, _ = out_buffers(3, n)
    bridge.compute_mask(pseg, (30, 20), None, addresses(mine),
                        ctypes.addressof(pacc))
    for i in range(3):
        same(bufs[i], mine[i], f"mask {i} of three")
    same(acc, pacc, "accuracies of three")

    prompts = [(30, 20, 0, 0), (5, 6, 60, 40), (10, 40, 0, 0),
               (0, 0, 71, 47), (60, 10, 0, 0)]
    is_region = [0, 1, 0, 1, 0]
    flat = (ctypes.c_int * 20)(*[v for p in prompts for v in p])
    reg = (ctypes.c_int * 5)(*is_region)
    bufs, ptrs = out_buffers(5, n)
    bacc, pbacc = (ctypes.c_float * 5)(), (ctypes.c_float * 5)()
    ok(api.compute_mask_batch(seg, flat, reg, 5, ptrs, bacc), "batch")
    mine, _ = out_buffers(5, n)
    bridge.compute_mask_batch(pseg, tuple(flat), tuple(reg), 5,
                              addresses(mine), ctypes.addressof(pbacc))
    for i in range(5):
        same(bufs[i], mine[i], f"batch mask {i}")
    same(bacc, pbacc, "batch accuracies")

    K = 4
    thr = (ctypes.c_float * 3)(0.0, 0.0, 0.7)
    bufs, ptrs = out_buffers(K, n)
    kacc, pkacc = (ctypes.c_float * K)(), (ctypes.c_float * K)()
    count = ctypes.c_int(-1)
    ok(api.generate_masks(seg, thr, K, ptrs, kacc, ctypes.byref(count)),
       "generate_masks")
    mine, _ = out_buffers(K, n)
    got = bridge.generate_masks(pseg, 0.0, 0.0, 0.7, K, addresses(mine),
                                ctypes.addressof(pkacc))
    check(count.value == got >= 1, f"generate_masks count {count.value} "
          f"!= {got}")
    for i in range(K):
        same(bufs[i], mine[i], f"generated mask {i}")
    same(kacc, pkacc, "generated accuracies")
    api.destroy_segmentation(seg)

    rgb = pixels(h, w, 3, w * 3, 2)
    view3 = DlimgImageView(width=w, height=h, channels=3, stride=0,
                           pixels=ctypes.cast(rgb, U8P))
    bufs, _ = out_buffers(1, n)
    ok(api.segment_objects(ctypes.byref(view3), ctypes.cast(bufs[0], U8P),
                           handle), "segment_objects")
    mine, _ = out_buffers(1, n)
    bridge.run_segment_objects(env, ctypes.addressof(rgb), w, h, 3, 0,
                               ctypes.addressof(mine[0]))
    same(bufs[0], mine[0], "segment_objects mask")

    # Codecs the native layer leaves to the bridge: a TIFF to load, a BGRA
    # buffer to save (the port's save_image refuses it, as JAX's does).
    from PIL import Image as PILImage

    tif = Path(tmp) / "bridge.tif"
    PILImage.fromarray(np.frombuffer(rgb, np.uint8).reshape(h, w, 3)).save(tif)
    ext, ch, px = (ctypes.c_int * 2)(), ctypes.c_int(), U8P()
    ok(api.load_image(str(tif).encode(), ext, ctypes.byref(ch),
                      ctypes.byref(px)), "load_image")
    lw, lh, lc, data = bridge.load_image(str(tif))
    check((ext[0], ext[1], ch.value) == (lw, lh, lc) == (w, h, 3),
          "load_image extent")
    check(ctypes.string_at(px, lw * lh * lc) == data, "load_image bytes")
    api.destroy_image(px)
    bgra = DlimgImageView(width=w, height=h, channels=5, stride=stride,
                          pixels=ctypes.cast(src, U8P))
    check(api.save_image(ctypes.byref(bgra), str(tif).encode()) == 1
          and b"Unsupported channel order" in api.last_error(),
          "save_image of bgra did not fail with the port's error")

    # Three threads through the library at once, each against its own
    # serial direct result.
    want, errors = {}, []
    for i in range(3):
        buf = pixels(h + 8 * i, w, 3, w * 3, 10 + i)
        s = bridge.process(env, ctypes.addressof(buf), w, h + 8 * i, 3, 0)
        m, _ = out_buffers(1, (h + 8 * i) * w)
        bridge.compute_mask(s, (20, 20), None, [ctypes.addressof(m[0]), 0, 0],
                            ctypes.addressof(pacc))
        want[i] = (buf, bytes(m[0]))

    def worker(i):
        try:
            buf, expect = want[i]
            hh = h + 8 * i
            v = DlimgImageView(width=w, height=hh, channels=3, stride=0,
                               pixels=ctypes.cast(buf, U8P))
            s = ctypes.c_void_p()
            if api.process_image_for_segmentation(ctypes.byref(s),
                                                  ctypes.byref(v), handle):
                raise RuntimeError(api.last_error().decode())
            m, p = out_buffers(1, hh * w)
            a = (ctypes.c_float * 3)()
            if api.get_segmentation_mask(s, (ctypes.c_int * 2)(20, 20), None,
                                         (U8P * 3)(p[0], None, None), a):
                raise RuntimeError(api.last_error().decode())
            api.destroy_segmentation(s)
            if bytes(m[0]) != expect:
                raise RuntimeError(f"thread {i}: mask differs")
        except Exception as e:  # reported after the join
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, f"threads: {errors}")
    api.destroy_environment(handle)

    loaded = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax."))
    check(not loaded, f"jax was imported: {loaded[:5]}")
    check(sys.modules["dlimgedit_tpu"] is _parent,
          "the JAX package was imported")
    print(json.dumps({"ok": True, "generated": count.value}))
    return 0


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as tmp:
        code = main(sys.argv[1], sys.argv[2], tmp)
    sys.exit(code)
