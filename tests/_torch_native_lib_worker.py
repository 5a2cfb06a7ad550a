"""Drive the port's own C library (libdlimgedit_tpu_torch.so, built by
dlimgedit_tpu_torch/native_build.py) on the CPU, in a process of its own:

    python tests/_torch_native_lib_worker.py OUT.npz MODEL_DIR BIREFNET.npz TIFF

The library is loaded with ctypes and imports
``dlimgedit_tpu_torch.native_bridge`` itself, on its first call: nothing
puts a module into ``sys.modules`` for it. It drives every entry of
``dlimg_init()``'s table that reaches the bridge, with backend 0, and
writes what came back into OUT.npz for the caller to hold against the
bridges of both packages (tests/test_torch_native_lib.py): the inputs are
made from the same seeds there. BIREFNET.npz is a slim BiRefNet tree that
serves as the environment's ``general`` model (the test seam of
tests/test_torch_native_bridge.py: the bridge's ``create_environment`` is
wrapped to keep the environments it makes); TIFF is an image file the
native codecs leave to the bridge. The error paths are checked here:
backend 1 without CUDA and ``DLIMG_PJRT_BUNDLE`` naming a directory that
is no serving bundle must fail with the port's messages. It exits non-zero when a call fails, when the library
did not import the bridge itself, or when jax or the JAX package was
imported. The environment variables (DLIMG_*) come from the caller.
"""

import ctypes
import os
import sys
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dlimgedit_tpu_torch import native_build  # noqa: E402

BRIDGE = "dlimgedit_tpu_torch.native_bridge"
U8P = ctypes.POINTER(ctypes.c_uint8)
H, W = 48, 72
# (channel code, bytes of padding a row, seed): the seeds of
# tests/test_torch_native_bridge.py's `_pixels(nch, 10 + code + pad)`.
CASES = ((1, 0), (3, 0), (4, 12), (5, 20), (6, 4))
POINT, REGION, POINT3 = (30, 20), (5, 6, 60, 40), (40, 30)
BATCH = ((30, 20, 0, 0), (5, 6, 60, 40), (10, 40, 0, 0), (0, 0, 71, 47),
         (60, 10, 0, 0))
BATCH_REGION = (0, 1, 0, 1, 0)
AMG_SLOTS = 6
SAVES = ((1, 3), (3, 0), (4, 8))  # (channel code, padding)


def check(cond, msg):
    if not cond:
        print(f"FAILED: {msg}", file=sys.stderr)
        sys.exit(1)


def pixels(c: int, seed: int, h: int = H, w: int = W) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, c),
                                                dtype=np.uint8)


def buffer(arr: np.ndarray, pad: int):
    """A caller's buffer (rows of ``w * c + pad`` bytes, the padding a
    pattern) -> (ctypes array, stride argument)."""
    h, w, c = arr.shape
    stride = w * c + pad
    buf = (ctypes.c_uint8 * (stride * h))()
    rows = np.frombuffer(buf, np.uint8).reshape(h, stride)
    rows[:] = 77
    rows[:, :w * c] = arr.reshape(h, w * c)
    return buf, (stride if pad else 0)


def view(buf, w, h, code, stride):
    return native_build.DlimgImageView(width=w, height=h, channels=code,
                                       stride=stride,
                                       pixels=ctypes.cast(buf, U8P))


def out_buffers(n: int, size: int = H * W):
    bufs = [(ctypes.c_uint8 * size)() for _ in range(n)]
    return bufs, (U8P * n)(*[ctypes.cast(b, U8P) for b in bufs])


def as_array(bufs) -> np.ndarray:
    return np.stack([np.frombuffer(b, np.uint8).copy() for b in bufs])


def inject_birefnet(env, tree_path: str) -> None:
    """The slim BiRefNet tree as `env`'s general model, float32 at 64."""
    import torch

    from dlimgedit_tpu_torch.convert.from_numpy import params_from_numpy
    from dlimgedit_tpu_torch.models import birefnet as bn
    from dlimgedit_tpu_torch.runtime import birefnet as rbn
    from dlimgedit_tpu_torch.utils.pytree_io import load_pytree

    cfg = rbn.slim_config(64, False)
    model = bn.BiRefNet(cfg)
    model.load_state_dict(params_from_numpy(load_pytree(tree_path)),
                          strict=True)
    env._birefnet_models["general"].get_or_create(
        lambda: rbn.BiRefNetBundle(cfg, model, torch.float32, 64))


def main(out_path: str, model_dir: str, birefnet_tree: str, tif: str) -> int:
    import torch

    # The caller's thread count (tests/test_torch_native_bridge.py sets 2):
    # the CPU's float32 sums then run in the same order in both processes.
    torch.set_num_threads(2)
    check(BRIDGE not in sys.modules, "the bridge was imported before the "
          "library's first call")
    build = native_build.build()
    api = native_build.load_api(build.library)
    out = {"codecs": np.array(",".join(build.codecs))}

    def ok(rc, what):
        check(rc == 0, f"{what}: rc {rc}: {api.last_error().decode()}")

    # -- the library imports the bridge itself --------------------------------
    check(api.is_backend_supported(0) == 1, "backend 0 unsupported")
    check(BRIDGE in sys.modules, "the library's first call did not import "
          "the bridge")
    check(api.is_backend_supported(1) == 0, "backend 1 supported on a machine "
          "without CUDA")
    bridge = sys.modules[BRIDGE]

    # -- error paths -----------------------------------------------------------
    handle = ctypes.c_void_p()
    gpu = native_build.DlimgOptions(backend=1,
                                    model_directory=model_dir.encode())
    check(api.create_environment(ctypes.byref(handle), ctypes.byref(gpu)) == 1
          and b"no CUDA device" in api.last_error(),
          f"backend 1 without CUDA: {api.last_error()}")
    opts = native_build.DlimgOptions(backend=0,
                                     model_directory=model_dir.encode())
    os.environ["DLIMG_PJRT_BUNDLE"] = model_dir
    check(api.create_environment(ctypes.byref(handle), ctypes.byref(opts)) == 1
          and b"holds no serving.txt" in api.last_error(),
          f"DLIMG_PJRT_BUNDLE: {api.last_error()}")
    check(api.is_backend_supported(0) == 0,
          "DLIMG_PJRT_BUNDLE: backend 0 still reported")
    del os.environ["DLIMG_PJRT_BUNDLE"]

    # -- the environment the library makes, kept for the BiRefNet seam ---------
    made = []
    real = bridge.create_environment

    def recording(backend, model_directory):
        env = real(backend, model_directory)
        made.append(env)
        return env

    bridge.create_environment = recording
    ok(api.create_environment(ctypes.byref(handle), ctypes.byref(opts)),
       "create_environment")
    check(len(made) == 1, "create_environment did not reach the bridge")
    inject_birefnet(made[0], birefnet_tree)

    # -- process, a point and a region mask, every channel code ---------------
    acc = (ctypes.c_float * 3)()
    for code, pad in CASES:
        nch = 4 if code in (5, 6) else code
        buf, stride = buffer(pixels(nch, 10 + code + pad), pad)
        seg = ctypes.c_void_p()
        ok(api.process_image_for_segmentation(
            ctypes.byref(seg), ctypes.byref(view(buf, W, H, code, stride)),
            handle), f"process code {code}")
        extent = (ctypes.c_int * 2)()
        api.get_segmentation_extent(seg, extent)
        check((extent[0], extent[1]) == (W, H), "extent")
        bufs, ptrs = out_buffers(2)
        ok(api.get_segmentation_mask(seg, (ctypes.c_int * 2)(*POINT), None,
                                     (U8P * 3)(ptrs[0], None, None), acc),
           "point mask")
        ok(api.get_segmentation_mask(seg, None, (ctypes.c_int * 4)(*REGION),
                                     (U8P * 3)(ptrs[1], None, None), acc),
           "region mask")
        out[f"single_{code}_{pad}"] = as_array(bufs)
        api.destroy_segmentation(seg)

    # -- three masks, a batch and generate_masks on one image ------------------
    buf, stride = buffer(pixels(4, 3), 8)
    seg = ctypes.c_void_p()
    ok(api.process_image_for_segmentation(
        ctypes.byref(seg), ctypes.byref(view(buf, W, H, 4, stride)), handle),
        "process")
    bufs, ptrs = out_buffers(3)
    ok(api.get_segmentation_mask(seg, (ctypes.c_int * 2)(*POINT3), None, ptrs,
                                 acc), "three masks")
    out["three"], out["three_acc"] = as_array(bufs), np.array(list(acc))
    flat = (ctypes.c_int * 20)(*[v for p in BATCH for v in p])
    reg = (ctypes.c_int * 5)(*BATCH_REGION)
    bufs, ptrs = out_buffers(5)
    bacc = (ctypes.c_float * 5)()
    ok(api.compute_mask_batch(seg, flat, reg, 5, ptrs, bacc), "batch")
    out["batch"], out["batch_acc"] = as_array(bufs), np.array(list(bacc))
    again, ptrs = out_buffers(5)
    ok(api.compute_mask_batch(seg, flat, reg, 5, ptrs, None),
       "batch without accuracies")
    check((as_array(again) == out["batch"]).all(),
          "a null accuracy pointer changed the batch's masks")
    bufs, ptrs = out_buffers(AMG_SLOTS)
    kacc = (ctypes.c_float * AMG_SLOTS)()
    count = ctypes.c_int(-1)
    ok(api.generate_masks(seg, (ctypes.c_float * 3)(0.0, 0.0, 1.0), AMG_SLOTS,
                          ptrs, kacc, ctypes.byref(count)), "generate_masks")
    out["generated"] = as_array(bufs)[:count.value]
    out["generated_acc"] = np.array(list(kacc))[:count.value]
    api.destroy_segmentation(seg)

    # -- segment_objects on padded BGRA rows -----------------------------------
    buf, stride = buffer(pixels(4, 5), 16)
    bufs, _ = out_buffers(1)
    ok(api.segment_objects(ctypes.byref(view(buf, W, H, 5, stride)),
                           ctypes.cast(bufs[0], U8P), handle),
       "segment_objects")
    out["objects"] = as_array(bufs)

    # -- image files -------------------------------------------------------------
    tmp = Path(out_path).parent
    for code, pad in SAVES:
        buf, stride = buffer(pixels(code, 30 + code), pad)
        path = tmp / f"lib_{code}.png"
        ok(api.save_image(ctypes.byref(view(buf, W, H, code, stride)),
                          str(path).encode()), f"save_image code {code}")
        ext, ch, px = (ctypes.c_int * 2)(), ctypes.c_int(), U8P()
        ok(api.load_image(str(path).encode(), ext, ctypes.byref(ch),
                          ctypes.byref(px)), f"load_image code {code}")
        check((ext[0], ext[1], ch.value) == (W, H, code), "load_image extent")
        out[f"loaded_{code}"] = np.frombuffer(
            ctypes.string_at(px, W * H * code), np.uint8).copy()
        api.destroy_image(px)
    ext, ch, px = (ctypes.c_int * 2)(), ctypes.c_int(), U8P()
    ok(api.load_image(tif.encode(), ext, ctypes.byref(ch), ctypes.byref(px)),
       "load_image of a TIFF")
    out["tif"] = np.frombuffer(
        ctypes.string_at(px, ext[0] * ext[1] * ch.value), np.uint8).copy()
    out["tif_shape"] = np.array([ext[0], ext[1], ch.value])
    api.destroy_image(px)
    buf, stride = buffer(pixels(4, 1), 0)
    check(api.save_image(ctypes.byref(view(buf, W, H, 5, stride)),
                         str(tmp / "bgra.png").encode()) == 1
          and b"channel order" in api.last_error(),
          "save_image of bgra did not fail with the port's error")

    # -- three threads through the library at once ------------------------------
    errors, results = [], {}

    def worker(i):
        try:
            hh = H + 8 * i
            buf, _ = buffer(pixels(3, 10 + i, hh), 0)
            s = ctypes.c_void_p()
            if api.process_image_for_segmentation(
                    ctypes.byref(s), ctypes.byref(view(buf, W, hh, 3, 0)),
                    handle):
                raise RuntimeError(api.last_error().decode())
            m, p = out_buffers(1, hh * W)
            if api.get_segmentation_mask(s, (ctypes.c_int * 2)(20, 20), None,
                                         (U8P * 3)(p[0], None, None),
                                         (ctypes.c_float * 3)()):
                raise RuntimeError(api.last_error().decode())
            api.destroy_segmentation(s)
            results[i] = as_array(m)
        except Exception as e:  # reported after the join
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not errors and len(results) == 3, f"threads: {errors}")
    for i, m in results.items():
        out[f"thread_{i}"] = m
    api.destroy_environment(handle)

    loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "dlimgedit_tpu.")) or m == "dlimgedit_tpu")
    check(not loaded, f"jax or the JAX package was imported: {loaded[:5]}")
    np.savez(out_path, **out)
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:5]))
