"""The port's C++ package surface (``python -m
dlimgedit_tpu_torch.native_build --install PREFIX --tgz``), as
tests/test_cmake_package.py holds the JAX package's ``cmake --install``:

- the install tree: ``lib/`` with the soname chain
  ``libdlimgedit_tpu_torch.so -> .so.1 -> .so.1.0.0``, the ABI headers
  under ``include/dlimgedit/``, ``bin/dlimg`` and ``bin/dlimg-serve``
  finding ``lib/`` through ``$ORIGIN/../lib``, and
  ``lib/cmake/dlimgedit/`` with the config and version files;
- the JAX package's external consumer (native/test/consumer/, used as it
  is) configured with ``CMAKE_PREFIX_PATH`` at the port's prefix:
  ``find_package(dlimgedit 1.0 REQUIRED CONFIG)`` finds it, links the
  imported target ``dlimgedit``, and the program prints ``CONSUMER_OK
  cpu=1``; a request for version 2.0 is not satisfied;
- the ``--tgz`` archive lists the tree;
- ``test_cpp_surface`` (every declaration of the C++14 header) and
  ``test_codecs`` (the native codecs with the interpreter never started)
  exit 0.
"""

import os
import shutil
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest

from dlimgedit_tpu_torch import native_build

from test_torch_native_bridge import BRIDGE_VARS, UNSET_VARS

ROOT = Path(__file__).resolve().parent.parent
CONSUMER = ROOT / "native" / "test" / "consumer"


@pytest.fixture(scope="module")
def build():
    if native_build.compiler() is None:
        pytest.skip("no C++ compiler installed")
    return native_build.build()


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in UNSET_VARS and k != "PYTHONPATH"}
    env.update(BRIDGE_VARS)
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def installed(build, tmp_path_factory):
    """(prefix, archive) written by the module's command line."""
    work = tmp_path_factory.mktemp("package")
    prefix = work / "prefix"
    r = subprocess.run(
        [sys.executable, "-m", "dlimgedit_tpu_torch.native_build",
         "--install", str(prefix), "--tgz"], cwd=work, env=_env(
             PYTHONPATH=str(ROOT)), capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert f"installed        {prefix.resolve()}" in r.stdout
    return prefix, work / native_build.TGZ_NAME


def _dynamic(path: Path) -> str:
    if shutil.which("readelf") is None:
        pytest.skip("no readelf on this machine")
    return subprocess.run(["readelf", "-d", str(path)], capture_output=True,
                          text=True, check=True).stdout


def test_install_tree_layout(installed):
    prefix, _ = installed
    lib = prefix / "lib"
    cmake = lib / "cmake" / "dlimgedit"
    assert (cmake / "dlimgeditConfig.cmake").is_file()
    assert (cmake / "dlimgeditConfigVersion.cmake").is_file()
    assert os.readlink(lib / "libdlimgedit_tpu_torch.so") == \
        "libdlimgedit_tpu_torch.so.1"
    assert os.readlink(lib / "libdlimgedit_tpu_torch.so.1") == \
        "libdlimgedit_tpu_torch.so.1.0.0"
    assert (lib / "libdlimgedit_tpu_torch.so.1.0.0").is_file()
    assert "Library soname: [libdlimgedit_tpu_torch.so.1]" in _dynamic(
        lib / "libdlimgedit_tpu_torch.so.1.0.0")
    assert not (lib / native_build.SERVING_LIBRARY).exists()  # no --serving
    for rel in ("dlimgedit.hpp", "detail/dlimgedit.h", "detail/handle.hpp"):
        assert (prefix / "include" / "dlimgedit" / rel).read_bytes() == \
            (native_build.INCLUDE_DIR / "dlimgedit" / rel).read_bytes()
    for name in native_build.INSTALLED_EXECUTABLES:
        exe = prefix / "bin" / name
        assert os.access(exe, os.X_OK)
        dyn = _dynamic(exe)
        assert "$ORIGIN/../lib" in dyn
        assert "Shared library: [libdlimgedit_tpu_torch.so.1]" in dyn


def test_installed_cli_finds_its_library(installed, tmp_path):
    """bin/dlimg from the tree (its directory holds no library) cuts out a
    masked image with the native codecs alone."""
    from PIL import Image as PILImage

    prefix, _ = installed
    rgb = np.zeros((20, 30, 3), np.uint8)
    rgb[..., 1] = 99
    mask = np.zeros((20, 30), np.uint8)
    mask[5:15, 8:22] = 255
    PILImage.fromarray(rgb).save(tmp_path / "in.png")
    PILImage.fromarray(mask).save(tmp_path / "mask.png")
    r = subprocess.run(
        [str(prefix / "bin" / "dlimg"), "apply-mask", str(tmp_path / "in.png"),
         str(tmp_path / "mask.png"), "-o", str(tmp_path / "fg.png")],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    fg = np.asarray(PILImage.open(tmp_path / "fg.png"))
    np.testing.assert_array_equal(fg[..., 3], mask)
    assert (fg[..., 1] == 99).all()


def _cmake(*args, **kw):
    r = subprocess.run(["cmake", *args], capture_output=True, text=True,
                       timeout=600, **kw)
    return r, r.stdout[-2000:] + r.stderr[-2000:]


def test_find_package_consumer_builds_and_runs(installed, tmp_path):
    if shutil.which("cmake") is None:
        pytest.skip("cmake not installed")
    prefix, _ = installed
    bdir = tmp_path / "consumer"
    r, log = _cmake("-S", str(CONSUMER), "-B", str(bdir),
                    f"-DCMAKE_PREFIX_PATH={prefix}")
    assert r.returncode == 0, log
    r, log = _cmake("--build", str(bdir))
    assert r.returncode == 0, log
    r = subprocess.run([str(bdir / "consumer")], env=_env(), cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert "CONSUMER_OK cpu=1" in r.stdout
    # AnyNewerVersion: 1.0.0 does not satisfy a request for 2.0.
    newer = tmp_path / "newer"
    newer.mkdir()
    (newer / "CMakeLists.txt").write_text(
        "cmake_minimum_required(VERSION 3.20)\nproject(newer NONE)\n"
        "find_package(dlimgedit 2.0 CONFIG)\n"
        'message(STATUS "dlimgedit_FOUND=${dlimgedit_FOUND}")\n')
    r, log = _cmake("-S", str(newer), "-B", str(newer / "b"),
                    f"-DCMAKE_PREFIX_PATH={prefix}")
    assert r.returncode == 0 and "dlimgedit_FOUND=0" in log, log


def test_tgz_lists_the_tree(installed):
    prefix, archive = installed
    tree = {p.relative_to(prefix).as_posix() for p in prefix.rglob("*")}
    with tarfile.open(archive) as tar:
        members = {m.name: m for m in tar.getmembers()}
    assert set(members) == tree
    link = members["lib/libdlimgedit_tpu_torch.so"]
    assert link.issym() and link.linkname == "libdlimgedit_tpu_torch.so.1"


@pytest.mark.parametrize("name", ["test_cpp_surface", "test_codecs"])
def test_cpp_test_programs_exit_0(build, tmp_path, name):
    """From a directory outside the repo, without PYTHONPATH; test_codecs
    also decodes a JPEG where the build has libjpeg."""
    args = []
    if name == "test_codecs" and "libjpeg" in build.codecs:
        from PIL import Image as PILImage

        rgb = np.random.default_rng(0).integers(0, 256, (30, 40, 3),
                                                dtype=np.uint8)
        PILImage.fromarray(rgb).save(tmp_path / "in.jpg")
        args = [str(tmp_path / "in.jpg"), "40", "30"]
    r = subprocess.run([str(build.executable(name)), *args],
                       env=_env(TMPDIR=str(tmp_path)), cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-1000:] + r.stderr[-2000:]
    want = ("CPP_SURFACE_OK" if name == "test_cpp_surface"
            else "libpython never initialised")
    assert want in r.stdout
    if args:
        assert "jpeg: decoded" in r.stdout
