"""The port's own C library (dlimgedit_tpu_torch/native/, built by
dlimgedit_tpu_torch/native_build.py) on the CPU, in float32, at
sam_image_size 64 on JAX's seed-0 ``init_sam`` bundle.

- The ABI headers are byte copies of native/include/ (a host built against
  either copy loads either library), and the package data ships every
  source the build compiles.
- In a process of its own (tests/_torch_native_lib_worker.py) the library
  is loaded with ctypes and imports ``dlimgedit_tpu_torch.native_bridge``
  itself (no ``sys.modules`` stand-in, no jax); it drives every table
  entry that reaches the bridge with backend 0. Here every buffer is held
  byte for byte against the port's bridge, and against JAX's bridge under
  tests/test_torch_native_bridge.py's rules: masks equal except where
  JAX's logit is within 1e-4 of zero, accuracies within 1e-4 (2e-5 for
  generated masks), BiRefNet within 1 quantum, image files written by the
  library's own PNG encoder decoded to the saved pixels by both the
  library and JAX's bridge, and within 4x of the bytes JAX's bridge
  (Pillow) writes. The worker checks the error paths: backend 1
  without CUDA, and DLIMG_PJRT_BUNDLE naming a directory that is no
  serving bundle, fail with the port's messages.
- ``dlimg segment`` writes the port's Python API's mask; ``dlimg
  apply-mask`` starts no Python; ``dlimg info`` reports the port's mode
  (and, with DLIMG_PJRT_BUNDLE, the serving mode without starting Python);
  ``test_cpp_api`` and ``test_cpp_dynamic`` exit 0.
"""

import ctypes
import fnmatch
import os
import subprocess
import sys
import tomllib
import types
from pathlib import Path

import jax
import numpy as np
import pytest

import dlimgedit_tpu as jdl
import dlimgedit_tpu.native_bridge as jnb
import dlimgedit_tpu_torch as pdl
import dlimgedit_tpu_torch.native_bridge as pnb
from dlimgedit_tpu.models import birefnet as jbn
from dlimgedit_tpu.utils.pytree_io import save_pytree
from dlimgedit_tpu_torch import native_build

from test_torch_amg import _assert_amg_matches
from test_torch_birefnet import _randomise, _slim_jax_cfg
from test_torch_native_bridge import (  # noqa: F401 (fixtures)
    BRIDGE_VARS,
    UNSET_VARS,
    _addr,
    _as_mask,
    _assert_mask_matches,
    _buffer,
    _masks,
    _pixels,
    bridge_vars,
    envs,
    model_dir,
)
from test_torch_segmentation import _jax_logits

import _torch_native_lib_worker as lw

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "_torch_native_lib_worker.py"

H, W = lw.H, lw.W


@pytest.fixture(scope="module")
def build():
    if native_build.compiler() is None:
        pytest.skip("no C++ compiler installed")
    return native_build.build()


def _env_vars(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in UNSET_VARS and k != "PYTHONPATH"}
    env.update(BRIDGE_VARS)
    env.update(extra)
    return env


def test_abi_headers_are_byte_copies():
    for rel in ("dlimgedit.hpp", "detail/dlimgedit.h", "detail/handle.hpp"):
        mine = native_build.INCLUDE_DIR / "dlimgedit" / rel
        theirs = ROOT / "native" / "include" / "dlimgedit" / rel
        assert mine.read_bytes() == theirs.read_bytes(), rel


def test_package_data_ships_every_native_source():
    """Every file native_build reads matches a glob of pyproject.toml's
    package data, as tests/test_torch_hostops.py checks for csrc/."""
    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = cfg["tool"]["setuptools"]["package-data"]["dlimgedit_tpu_torch"]
    compiled = {*native_build.LIBRARY_SOURCES,
                *(src for src, _ in native_build.EXECUTABLES.values())}
    assert compiled <= set(native_build.sources())
    files = [p.relative_to(native_build.PACKAGE_DIR).as_posix()
             for p in native_build.sources()]
    assert "native/include/dlimgedit/detail/dlimgedit.h" in files
    missing = [f for f in files
               if not any(fnmatch.fnmatch(f, g) for g in globs)]
    assert not missing, f"not package data: {missing}"


@pytest.fixture(scope="module")
def worker_out(build, model_dir, envs, tmp_path_factory):
    """The worker's outputs; the same slim BiRefNet tree (JAX's, nonzero
    offsets) is the general model of both bridges' environments here."""
    tmp = tmp_path_factory.mktemp("lib")
    tree = _randomise(jax.tree_util.tree_map(
        np.asarray, jbn.init_birefnet(jax.random.PRNGKey(0),
                                      _slim_jax_cfg(64))), seed=3)
    save_pytree(tmp / "birefnet.npz", tree)
    _inject_birefnet(envs, tree, tmp / "birefnet.npz")
    from PIL import Image as PILImage

    tif = tmp / "bridge.tif"
    PILImage.fromarray(_pixels(3, 2)).save(tif)
    out = tmp / "out.npz"
    r = subprocess.run(
        [sys.executable, str(WORKER), str(out), str(model_dir),
         str(tmp / "birefnet.npz"), str(tif)],
        capture_output=True, text=True, env=_env_vars(), timeout=600,
        cwd=tmp)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(out)), tmp


def _inject_birefnet(envs, tree, path):
    import jax.numpy as jnp

    from dlimgedit_tpu.runtime.birefnet import BiRefNetBundle as JBundle

    je, pe = envs
    je._birefnet_models["general"].get_or_create(lambda: JBundle(
        _slim_jax_cfg(64), jax.tree_util.tree_map(jnp.asarray, tree),
        je.put_target, jnp.float32, 64))
    lw.inject_birefnet(pe, str(path))


def _prompt(v, is_region):
    return (jdl.Region(jdl.Point(*v[:2]), jdl.Point(*v[2:])) if is_region
            else jdl.Point(*v[:2]))


def _both_process(envs, arr, code, pad):
    buf, stride = _buffer(arr, pad)
    h, w = arr.shape[:2]
    return (jnb.process(envs[0], ctypes.addressof(buf), w, h, code, stride),
            pnb.process(envs[1], ctypes.addressof(buf), w, h, code, stride))


@pytest.mark.parametrize("code,pad", lw.CASES)
def test_single_masks_match_both_bridges(envs, worker_out, code, pad):
    got = worker_out[0][f"single_{code}_{pad}"]
    nch = 4 if code in (5, 6) else code
    js, ps = _both_process(envs, _pixels(nch, 10 + code + pad), code, pad)
    for i, (point, region) in enumerate(((lw.POINT, None), (None, lw.REGION))):
        mine, want = _masks(1), _masks(1)
        pnb.compute_mask(ps, point, region, [_addr(mine)[0], 0, 0], 0)
        jnb.compute_mask(js, point, region, [_addr(want)[0], 0, 0], 0)
        assert got[i].tobytes() == bytes(mine[0])
        prompt = _prompt(region or point, region is not None)
        _assert_mask_matches(got[i].reshape(H, W, 1), _as_mask(want[0]),
                             lambda: _jax_logits(envs[0], js, prompt)[0])


@pytest.fixture(scope="module")
def segs(envs):
    return _both_process(envs, lw.pixels(4, 3), 4, 8)


def test_three_masks_and_batch_match_both_bridges(envs, worker_out, segs):
    out = worker_out[0]
    js, ps = segs
    mine, want = _masks(3), _masks(3)
    macc, wacc = (ctypes.c_float * 3)(), (ctypes.c_float * 3)()
    pnb.compute_mask(ps, lw.POINT3, None, _addr(mine), ctypes.addressof(macc))
    jnb.compute_mask(js, lw.POINT3, None, _addr(want), ctypes.addressof(wacc))
    logits = _jax_logits(envs[0], js, jdl.Point(*lw.POINT3), multimask=True)
    for i in range(3):
        assert out["three"][i].tobytes() == bytes(mine[i])
        _assert_mask_matches(out["three"][i].reshape(H, W, 1),
                             _as_mask(want[i]), lambda i=i: logits[i])
    np.testing.assert_array_equal(out["three_acc"], np.array(list(macc)))
    np.testing.assert_allclose(out["three_acc"], list(wacc), atol=1e-4, rtol=0)

    flat = tuple(v for p in lw.BATCH for v in p)
    mine, want = _masks(5), _masks(5)
    macc, wacc = (ctypes.c_float * 5)(), (ctypes.c_float * 5)()
    pnb.compute_mask_batch(ps, flat, lw.BATCH_REGION, 5, _addr(mine),
                           ctypes.addressof(macc))
    jnb.compute_mask_batch(js, flat, lw.BATCH_REGION, 5, _addr(want),
                           ctypes.addressof(wacc))
    for i, (p, r) in enumerate(zip(lw.BATCH, lw.BATCH_REGION)):
        assert out["batch"][i].tobytes() == bytes(mine[i])
        _assert_mask_matches(out["batch"][i].reshape(H, W, 1),
                             _as_mask(want[i]),
                             lambda p=p, r=r: _jax_logits(
                                 envs[0], js, _prompt(p, r))[0])
    np.testing.assert_array_equal(out["batch_acc"], np.array(list(macc)))
    np.testing.assert_allclose(out["batch_acc"], list(wacc), atol=1e-4, rtol=0)


def test_generate_masks_matches_both_bridges(envs, worker_out, segs):
    out = worker_out[0]
    js, ps = segs
    K = lw.AMG_SLOTS
    mine, want = _masks(K), _masks(K)
    macc, wacc = (ctypes.c_float * K)(), (ctypes.c_float * K)()
    n = pnb.generate_masks(ps, 0.0, 0.0, 1.0, K, _addr(mine),
                           ctypes.addressof(macc))
    assert n == len(out["generated"]) >= 2
    assert n == jnb.generate_masks(js, 0.0, 0.0, 1.0, K, _addr(want),
                                   ctypes.addressof(wacc))
    for i in range(n):
        assert out["generated"][i].tobytes() == bytes(mine[i])
    np.testing.assert_array_equal(out["generated_acc"], list(macc)[:n])

    def as_masks(pixels, acc):
        return [types.SimpleNamespace(accuracy=acc[i], image=types.SimpleNamespace(
            pixels=pixels[i])) for i in range(n)]

    _assert_amg_matches(envs[0], js,
                        as_masks([m.reshape(H, W, 1) for m in out["generated"]],
                                 out["generated_acc"]),
                        as_masks([_as_mask(b) for b in want], wacc))


def test_segment_objects_matches_both_bridges(envs, worker_out):
    je, pe = envs
    got = worker_out[0]["objects"][0]
    buf, stride = _buffer(lw.pixels(4, 5), 16)
    mine, want = _masks(1), _masks(1)
    pnb.run_segment_objects(pe, ctypes.addressof(buf), W, H, 5, stride,
                            _addr(mine)[0])
    jnb.run_segment_objects(je, ctypes.addressof(buf), W, H, 5, stride,
                            _addr(want)[0])
    assert got.tobytes() == bytes(mine[0])
    w = np.frombuffer(want[0], np.uint8).astype(np.int32)
    assert np.abs(got.astype(np.int32) - w).max() <= 1
    assert len(np.unique(got)) > 2  # a grey-level mask, not a constant


@pytest.mark.parametrize("code,pad", lw.SAVES)
def test_image_files_match_jax(worker_out, tmp_path, code, pad):
    out, tmp = worker_out
    src = lw.pixels(code, 30 + code)
    assert out[f"loaded_{code}"].tobytes() == src.tobytes()
    written = tmp / f"lib_{code}.png"  # the port's own PNG encoder's
    assert jnb.load_image(str(written)) == (W, H, code, src.tobytes())
    buf, stride = _buffer(src, pad)
    jnb.save_image(ctypes.addressof(buf), W, H, code, stride,
                   str(tmp_path / "jax.png"))
    assert written.stat().st_size <= 4 * (tmp_path / "jax.png").stat().st_size


def test_bridge_codecs_match_jax(worker_out):
    out, tmp = worker_out
    w, h, c, data = jnb.load_image(str(tmp / "bridge.tif"))
    assert tuple(out["tif_shape"]) == (w, h, c) == (W, H, 3)
    assert out["tif"].tobytes() == data


def test_threads_match_the_bridge(envs, worker_out):
    for i in range(3):
        hh = H + 8 * i
        buf, _ = _buffer(lw.pixels(3, 10 + i, hh), 0)
        s = pnb.process(envs[1], ctypes.addressof(buf), W, hh, 3, 0)
        mine = _masks(1, hh * W)
        pnb.compute_mask(s, (20, 20), None, [_addr(mine)[0], 0, 0], 0)
        assert worker_out[0][f"thread_{i}"].tobytes() == bytes(mine[0])


def _png(path, arr):
    from PIL import Image as PILImage

    PILImage.fromarray(arr).save(path)


def _read_png(path):
    from PIL import Image as PILImage

    return np.asarray(PILImage.open(path))


def test_cli_segment_writes_the_python_apis_mask(build, model_dir, tmp_path):
    rgb = lw.pixels(3, 50)
    _png(tmp_path / "in.png", rgb)
    r = subprocess.run(
        [str(build.executable("dlimg")), "segment", str(tmp_path / "in.png"),
         "--backend", "cpu", "--models", str(model_dir), "--point", "30,20",
         "-o", str(tmp_path / "m.png"), "--time"],
        env=_env_vars(DLIMG_ALLOW_RANDOM_WEIGHTS="0"), capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[dlimg] process" in r.stderr
    env = pdl.Environment(pdl.Options(
        backend=pdl.Backend.cpu, model_directory=str(model_dir),
        sam_image_size=64, compute_dtype="float32"))
    seg = pdl.Segmentation.process(
        pdl.ImageView(rgb, pdl.Extent(W, H), pdl.Channels.rgb), env)
    want = seg.compute_mask(pdl.Point(30, 20)).pixels.reshape(H, W)
    np.testing.assert_array_equal(_read_png(tmp_path / "m.png"), want)


def test_cli_apply_mask_starts_no_python(build, tmp_path):
    """A sitecustomize on PYTHONPATH leaves a file when an interpreter
    starts: ``apply-mask`` (native codecs) leaves none, ``info`` (which
    asks the bridge) leaves one."""
    site = tmp_path / "site"
    site.mkdir()
    marker = tmp_path / "python-started"
    (site / "sitecustomize.py").write_text(
        f"open({str(marker)!r}, 'w').close()\n")
    env = _env_vars(PYTHONPATH=str(site))
    rgb = np.zeros((40, 60, 3), np.uint8)
    rgb[:, :, 0] = 180
    mask = np.zeros((40, 60), np.uint8)
    mask[10:30, 20:50] = 255
    _png(tmp_path / "in.png", rgb)
    _png(tmp_path / "mask.png", mask)
    r = subprocess.run(
        [str(build.executable("dlimg")), "apply-mask", str(tmp_path / "in.png"),
         str(tmp_path / "mask.png"), "-o", str(tmp_path / "fg.png")],
        env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    fg = _read_png(tmp_path / "fg.png")
    np.testing.assert_array_equal(fg[:, :, 3], mask)
    assert (fg[:, :, 0] == 180).all()
    assert not marker.exists()
    r = subprocess.run([str(build.executable("dlimg")), "info"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "runtime mode: embedded-Python PyTorch" in r.stdout
    assert "backend cpu: supported" in r.stdout
    assert "backend gpu: unavailable" in r.stdout  # no CUDA device here
    assert marker.exists()
    marker.unlink()
    r = subprocess.run([str(build.executable("dlimg")), "info"],
                       env={**env, "DLIMG_PJRT_BUNDLE": str(tmp_path)},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "runtime mode: Python-free serving bundle" in r.stdout
    assert "bundle refused" in r.stdout and "holds no serving.txt" in r.stdout
    assert not marker.exists()


@pytest.mark.parametrize("name", ["test_cpp_api", "test_cpp_dynamic"])
def test_cpp_programs_exit_0(build, tmp_path, name):
    """The standalone embedder and the dlopen client, from a directory
    outside the repo and without PYTHONPATH: the library starts the
    interpreter that built it and finds the package itself."""
    args = [str(build.library)] if name == "test_cpp_dynamic" else ["cpu"]
    r = subprocess.run(
        [str(build.executable(name)), *args],
        env=_env_vars(TMPDIR=str(tmp_path)), cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-1000:] + r.stderr[-2000:]
    assert ("CPP_API_OK" if name == "test_cpp_api" else "CPP_DYNAMIC_OK") \
        in r.stdout


def test_a_failed_build_raises_with_the_compilers_output(monkeypatch,
                                                          tmp_path):
    if native_build.compiler() is None:
        pytest.skip("no C++ compiler installed")
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_build, "CXX_FLAGS", [
        *native_build.CXX_FLAGS, "-include", str(tmp_path / "missing.h")])
    with pytest.raises(pdl.DlimgError, match="missing.h"):
        native_build.NativeBuilder().get()
    assert not list(tmp_path.glob("native_*"))  # nothing half-built in place


def test_python_h_and_libpython_are_required(monkeypatch, tmp_path):
    real = native_build.sysconfig.get_config_var
    for var, match in (("INCLUDEPY", "Python.h not found"),
                       ("LDLIBRARY", "no shared libpython")):
        monkeypatch.setattr(native_build.sysconfig, "get_config_var",
                            lambda k, var=var: str(tmp_path / "x.a")
                            if k == var else real(k))
        with pytest.raises(pdl.DlimgError, match=match):
            native_build.python_flags()
