"""The port's C ABI bridge (dlimgedit_tpu_torch/native_bridge.py) against the
JAX package's (dlimgedit_tpu/native_bridge.py), on the CPU, in float32.

Both bridges get the same ctypes buffers, exactly as native/src/capi.cpp
passes them (pointers as Python ints, a point ``(x, y)``, a region
``(x0, y0, x1, y1)``, lists of output pointers), and serve ONE weight bundle
(JAX's seed-0 ``init_sam`` tree at 64, as tests/test_torch_segmentation.py
writes it): channel codes 1, 3, 4, 5 and 6, padded row strides, a point, a
region, three masks, a batch of 5 and ``generate_masks``. Masks must be
equal byte for byte, except where JAX's logit is within 1e-4 of zero;
accuracies within 1e-4 (2e-5 for generated masks, as
tests/test_torch_amg.py). ``run_segment_objects`` on JAX's slim BiRefNet
tree (nonzero offsets): within 1 quantum a pixel. Image files: equal bytes.

Also: a caller's buffer overwritten after ``process`` changes no later
mask; the masks are host uint8 arrays of exactly ``h * w`` bytes; backend
1 without CUDA and ``DLIMG_COMPILATION_CACHE`` raise; and, in a process of
its own (the library binds its bridge once per process), the C library
built from the unedited native/src/capi.cpp drives the port's bridge with
no jax imported (tests/_torch_bridge_worker.py).
"""

import ctypes
import inspect
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlimgedit_tpu as jdl
import dlimgedit_tpu.native_bridge as jnb
import dlimgedit_tpu_torch as pdl
import dlimgedit_tpu_torch.native_bridge as pnb
from dlimgedit_tpu.models import birefnet as jbn
from dlimgedit_tpu.models import sam as jax_sam
from dlimgedit_tpu.runtime.birefnet import BiRefNetBundle as JBiRefNetBundle
from dlimgedit_tpu.utils.pytree_io import save_pytree
from dlimgedit_tpu_torch.convert.from_numpy import params_from_numpy
from dlimgedit_tpu_torch.models import birefnet as bn
from dlimgedit_tpu_torch.runtime import birefnet as rbn

from test_torch_amg import _assert_amg_matches
from test_torch_birefnet import _randomise, _slim_jax_cfg
from test_torch_segmentation import _jax_logits

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SO_PATH = ROOT / "native" / "build" / "libdlimgedit_tpu.so"
IMAGE_SIZE = 64
NEAR_ZERO = 1e-4
H, W = 48, 72
BRIDGE_VARS = {
    "DLIMG_ALLOW_RANDOM_WEIGHTS": "1",
    "DLIMG_SAM_IMAGE_SIZE": str(IMAGE_SIZE),
    "DLIMG_COMPUTE_DTYPE": "float32",
    "DLIMG_AMG_GRID": "4",
    "DLIMG_BIREFNET_TEST_SLIM": "1",
    "DLIMG_BIREFNET_RESOLUTION": "64",
}
UNSET_VARS = ("DLIMG_SAM_VARIANT", "DLIMG_COMPILATION_CACHE",
              "DLIMG_SCALEOUT_DEVICES", "DLIMG_PJRT_BUNDLE")
FUNCTIONS = ("_wrap_pixels", "backend_supported", "create_environment",
             "process", "segmentation_extent", "compute_mask",
             "compute_mask_batch", "generate_masks", "run_segment_objects",
             "load_image", "save_image")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    (d / "segmentation").mkdir()
    params = jax_sam.init_sam(jax.random.PRNGKey(0),
                              jax_sam.make_config("mobile_sam", IMAGE_SIZE))
    save_pytree(d / "segmentation" / "mobile_sam.npz",
                jax.tree_util.tree_map(np.asarray, params))
    return d


@pytest.fixture(scope="module")
def bridge_vars():
    saved = {k: os.environ.get(k) for k in (*BRIDGE_VARS, *UNSET_VARS)}
    os.environ.update(BRIDGE_VARS)
    for k in UNSET_VARS:
        os.environ.pop(k, None)
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope="module")
def envs(model_dir, bridge_vars):
    """(JAX's, the port's) environment, each from its bridge."""
    return (jnb.create_environment(0, str(model_dir)),
            pnb.create_environment(0, str(model_dir)))


def _buffer(arr: np.ndarray, pad: int):
    """A caller's pixel buffer: rows of ``w * c + pad`` bytes (the padding a
    pattern no pixel copy may read) -> (ctypes array, stride argument)."""
    h, w, c = arr.shape
    stride = w * c + pad
    buf = (ctypes.c_uint8 * (stride * h))()
    rows = np.frombuffer(buf, np.uint8).reshape(h, stride)
    rows[:] = 77
    rows[:, :w * c] = arr.reshape(h, w * c)
    return buf, (stride if pad else 0)


def _pixels(c: int, seed: int, h: int = H, w: int = W) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, c),
                                                dtype=np.uint8)


def _masks(n: int, size: int = H * W):
    return [(ctypes.c_uint8 * size)() for _ in range(n)]


def _addr(bufs):
    return [ctypes.addressof(b) for b in bufs]


def _as_mask(buf, h: int = H, w: int = W) -> np.ndarray:
    return np.frombuffer(buf, np.uint8).reshape(h, w, 1).copy()


def _assert_mask_matches(got, want, logits_fn):
    assert got.shape == want.shape and got.dtype == np.uint8
    flips = got[..., 0] != want[..., 0]
    if not flips.any():
        return
    near = np.abs(logits_fn()[flips]) <= NEAR_ZERO
    assert near.all(), (
        f"{int(flips.sum())} pixels flipped, {int((~near).sum())} of them where "
        f"JAX's logit is not within {NEAR_ZERO} of zero")


def _process_both(envs, arr, code, pad):
    buf, stride = _buffer(arr, pad)
    h, w = arr.shape[:2]
    js = jnb.process(envs[0], ctypes.addressof(buf), w, h, code, stride)
    ps = pnb.process(envs[1], ctypes.addressof(buf), w, h, code, stride)
    return buf, js, ps


def test_the_same_eleven_functions_and_signatures():
    for name in FUNCTIONS:
        got = list(inspect.signature(getattr(pnb, name)).parameters)
        want = list(inspect.signature(getattr(jnb, name)).parameters)
        assert got == want, name


@pytest.mark.parametrize("code,pad", [(1, 0), (3, 0), (4, 0), (5, 0), (6, 0),
                                      (4, 12), (5, 20), (6, 4)])
def test_process_and_single_masks_match_jax(envs, code, pad):
    """Every channel code, contiguous and padded rows: the extent, a point
    mask and a region mask."""
    nch = 4 if code in (5, 6) else code
    _, js, ps = _process_both(envs, _pixels(nch, 10 + code + pad), code, pad)
    assert pnb.segmentation_extent(ps) == jnb.segmentation_extent(js) == (W, H)
    acc = (ctypes.c_float * 3)()
    for point, region in (((30, 20), None), (None, (5, 6, 60, 40))):
        got, want = _masks(1), _masks(1)
        pnb.compute_mask(ps, point, region, [_addr(got)[0], 0, 0],
                         ctypes.addressof(acc))
        jnb.compute_mask(js, point, region, [_addr(want)[0], 0, 0],
                         ctypes.addressof(acc))
        prompt = (jdl.Point(*point) if point else
                  jdl.Region(jdl.Point(*region[:2]), jdl.Point(*region[2:])))
        _assert_mask_matches(_as_mask(got[0]), _as_mask(want[0]),
                             lambda: _jax_logits(envs[0], js, prompt)[0])


@pytest.fixture(scope="module")
def segs(envs):
    return _process_both(envs, _pixels(4, 3), 4, 8)


def test_three_masks_and_accuracies_match_jax(envs, segs):
    _, js, ps = segs
    got, want = _masks(3), _masks(3)
    gacc, wacc = (ctypes.c_float * 3)(), (ctypes.c_float * 3)()
    pnb.compute_mask(ps, (40, 30), None, _addr(got), ctypes.addressof(gacc))
    jnb.compute_mask(js, (40, 30), None, _addr(want), ctypes.addressof(wacc))
    logits = _jax_logits(envs[0], js, jdl.Point(40, 30), multimask=True)
    for i in range(3):
        _assert_mask_matches(_as_mask(got[i]), _as_mask(want[i]),
                             lambda i=i: logits[i])
    np.testing.assert_allclose(list(gacc), list(wacc), atol=1e-4, rtol=0)


def test_batch_of_five_matches_jax(envs, segs):
    _, js, ps = segs
    prompts = [(30, 20, 0, 0), (5, 6, 60, 40), (10, 40, 0, 0),
               (0, 0, 71, 47), (60, 10, 0, 0)]
    is_region = (0, 1, 0, 1, 0)
    flat = tuple(v for p in prompts for v in p)
    got, want = _masks(5), _masks(5)
    gacc, wacc = (ctypes.c_float * 5)(), (ctypes.c_float * 5)()
    pnb.compute_mask_batch(ps, flat, is_region, 5, _addr(got),
                           ctypes.addressof(gacc))
    jnb.compute_mask_batch(js, flat, is_region, 5, _addr(want),
                           ctypes.addressof(wacc))
    for i, (p, r) in enumerate(zip(prompts, is_region)):
        prompt = (jdl.Region(jdl.Point(*p[:2]), jdl.Point(*p[2:])) if r
                  else jdl.Point(*p[:2]))
        _assert_mask_matches(_as_mask(got[i]), _as_mask(want[i]),
                             lambda prompt=prompt: _jax_logits(
                                 envs[0], js, prompt)[0])
    np.testing.assert_allclose(list(gacc), list(wacc), atol=1e-4, rtol=0)
    # A null accuracy pointer writes the masks only.
    again = _masks(5)
    pnb.compute_mask_batch(ps, flat, is_region, 5, _addr(again), 0)
    assert [bytes(b) for b in again] == [bytes(b) for b in got]


def test_generate_masks_matches_jax(envs, segs):
    _, js, ps = segs
    K = 6
    got, want = _masks(K), _masks(K)
    gacc, wacc = (ctypes.c_float * K)(), (ctypes.c_float * K)()
    n = pnb.generate_masks(ps, 0.0, 0.0, 1.0, K, _addr(got),
                           ctypes.addressof(gacc))
    assert n == jnb.generate_masks(js, 0.0, 0.0, 1.0, K, _addr(want),
                                   ctypes.addressof(wacc))
    assert n >= 2

    def as_masks(bufs, acc):
        return [types.SimpleNamespace(accuracy=acc[i], image=types.SimpleNamespace(
            pixels=_as_mask(bufs[i]))) for i in range(n)]

    _assert_amg_matches(envs[0], js, as_masks(got, gacc), as_masks(want, wacc))


def test_masks_are_host_bytes_at_the_extent(segs):
    """What the bridge copies into a caller's buffer is a host uint8 array
    of exactly h * w bytes, not a padded canvas or a device tensor."""
    _, _, ps = segs
    for image in (ps.compute_mask(pdl.Point(30, 20)),
                  ps.compute_masks(pdl.Point(30, 20))[1].image,
                  ps.compute_mask_batch([pdl.Point(1, 1)])[0].image):
        px = image.pixels
        assert isinstance(px, np.ndarray) and px.dtype == np.uint8
        assert px.size == H * W and px.flags.c_contiguous


def test_the_callers_buffer_may_change_after_process(envs):
    """A C caller may free or reuse its pixels once ``process`` returns:
    the port keeps none of them, so every later mask is the one the
    buffer's first contents give."""
    buf, stride = _buffer(_pixels(3, 21), 9)
    ps = pnb.process(envs[1], ctypes.addressof(buf), W, H, 3, stride)

    def all_masks():
        single, three, batch = _masks(1), _masks(3), _masks(2)
        acc = (ctypes.c_float * 3)()
        pnb.compute_mask(ps, (30, 20), None, [_addr(single)[0], 0, 0], 0)
        pnb.compute_mask(ps, (30, 20), None, _addr(three),
                         ctypes.addressof(acc))
        pnb.compute_mask_batch(ps, (5, 5, 60, 40, 50, 30, 0, 0), (1, 0), 2,
                               _addr(batch), 0)
        return [bytes(b) for b in single + three + batch] + [bytes(acc)]

    before = all_masks()
    rows = np.frombuffer(buf, np.uint8)
    rows[:] = np.random.default_rng(22).integers(0, 256, rows.shape,
                                                 dtype=np.uint8)
    assert all_masks() == before
    ctypes.memset(buf, 0, ctypes.sizeof(buf))
    assert all_masks() == before


def test_run_segment_objects_matches_jax(envs):
    """JAX's slim BiRefNet tree with nonzero offsets as both environments'
    general bundle; padded BGRA rows; within 1 quantum a pixel."""
    je, pe = envs
    tree = _randomise(jax.tree_util.tree_map(
        np.asarray, jbn.init_birefnet(jax.random.PRNGKey(0), _slim_jax_cfg(64))),
        seed=3)
    je._birefnet_models["general"].get_or_create(lambda: JBiRefNetBundle(
        _slim_jax_cfg(64), jax.tree_util.tree_map(jnp.asarray, tree),
        je.put_target, jnp.float32, 64))
    cfg = rbn.slim_config(64, False)
    model = bn.BiRefNet(cfg)
    model.load_state_dict(params_from_numpy(tree), strict=True)
    pe._birefnet_models["general"].get_or_create(
        lambda: rbn.BiRefNetBundle(cfg, model, torch.float32, 64))
    buf, stride = _buffer(_pixels(4, 5), 16)
    got, want = _masks(1), _masks(1)
    pnb.run_segment_objects(pe, ctypes.addressof(buf), W, H, 5, stride,
                            _addr(got)[0])
    jnb.run_segment_objects(je, ctypes.addressof(buf), W, H, 5, stride,
                            _addr(want)[0])
    g = np.frombuffer(got[0], np.uint8).astype(np.int32)
    w = np.frombuffer(want[0], np.uint8).astype(np.int32)
    assert np.abs(g - w).max() <= 1
    assert len(np.unique(g)) > 2  # a grey-level mask, not a constant


@pytest.mark.parametrize("code,pad", [(1, 3), (3, 0), (4, 8)])
def test_save_and_load_give_jax_bytes(tmp_path, code, pad):
    buf, stride = _buffer(_pixels(code, 30 + code), pad)
    mine, theirs = tmp_path / "port.png", tmp_path / "jax.png"
    pnb.save_image(ctypes.addressof(buf), W, H, code, stride, str(mine))
    jnb.save_image(ctypes.addressof(buf), W, H, code, stride, str(theirs))
    assert mine.read_bytes() == theirs.read_bytes()
    got = pnb.load_image(str(mine))
    assert got == jnb.load_image(str(mine)) == jnb.load_image(str(theirs))
    assert got[:3] == (W, H, code)
    assert got[3] == _pixels(code, 30 + code).tobytes()


def test_save_refuses_bgra_as_jax_does(tmp_path):
    buf, stride = _buffer(_pixels(4, 1), 0)
    with pytest.raises(pdl.UnsupportedImageError, match="channel order"):
        pnb.save_image(ctypes.addressof(buf), W, H, 5, stride,
                       str(tmp_path / "x.png"))
    with pytest.raises(jdl.UnsupportedImageError, match="channel order"):
        jnb.save_image(ctypes.addressof(buf), W, H, 5, stride,
                       str(tmp_path / "x.png"))


def test_gpu_backend_raises_without_cuda(model_dir, bridge_vars, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pnb.backend_supported(0) and not pnb.backend_supported(1)
    with pytest.raises(pdl.DlimgError, match="no CUDA device"):
        pnb.create_environment(1, str(model_dir))


def test_compilation_cache_raises(model_dir, bridge_vars, monkeypatch,
                                  tmp_path):
    monkeypatch.setenv("DLIMG_COMPILATION_CACHE", str(tmp_path))
    with pytest.raises(pdl.DlimgError, match="compilation_cache_dir"):
        pnb.create_environment(0, str(model_dir))


def test_environment_variables_reach_the_options(model_dir, bridge_vars,
                                                 monkeypatch):
    monkeypatch.setenv("DLIMG_SAM_VARIANT", "vit_b")
    monkeypatch.setenv("DLIMG_SCALEOUT_DEVICES", "0")
    o = pnb.create_environment(0, str(model_dir)).options
    assert (o.backend, o.model_directory, o.allow_random_weights,
            o.sam_variant, o.sam_image_size, o.compute_dtype,
            o.scaleout_devices) == (pdl.Backend.cpu, str(model_dir), True,
                                    "vit_b", IMAGE_SIZE, "float32", 0)


def test_the_unedited_library_drives_the_port_bridge(model_dir):
    """native/build/libdlimgedit_tpu.so, built as tests/test_native_abi.py
    builds it, on the port's bridge in a process of its own: every output
    byte-equal to the direct bridge call, three threads, and no jax."""
    from _native_build import ensure_native_build

    ensure_native_build(SO_PATH)
    env = {k: v for k, v in os.environ.items() if k not in UNSET_VARS}
    env.update(BRIDGE_VARS)
    r = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_bridge_worker.py"),
         str(SO_PATH), str(model_dir)],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["generated"] >= 1
