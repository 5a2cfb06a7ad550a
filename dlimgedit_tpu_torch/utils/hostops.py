"""The port's native host loops (csrc/hostops.cpp), loaded with ctypes.

The channel-map pack before every ``Segmentation.process`` is a byte
shuffle of the whole image into the canvas that goes to the device; numpy
does it as three strided slice copies, the native loop in one pass over
the rows with a small persistent thread pool. ``resize_mask_box`` is the
box-filter resize of ``image/resize.py::resize_mask`` in the same library
(within one grey level at rounding ties).

The library is built at first use with ``g++ -O3 -shared -fPIC -pthread``
into ``dlimgedit_tpu_torch/_build/``, under a name that carries a hash of
the source, the flags and the machine, and is moved into place
atomically, so parallel processes may race on it. A build or load that
fails raises ``DlimgError``: nothing falls back to numpy. The numpy loop
stays as the plain version the tests hold the native one against
(``ops/preprocess.py::pack_rows_plain``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..errors import DlimgError

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "hostops.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]
ABI_VERSION = 2

_VP, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # src, src_stride, h, w, src_c, m0, m1, m2, dst, dst_stride, threads
    "dlimg_hostops_pack_rgb": [_VP, _I64, _I, _I, _I, _I, _I, _I, _VP, _I64, _I],
    # src, src_h, src_w, src_stride, dst, dst_h, dst_w, dst_stride
    "dlimg_hostops_resize_mask_box": [_VP, _I, _I, _I64, _VP, _I, _I, _I64],
}


class HostOpsLibrary:
    """The loaded host-ops library; built on first use (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.path: Optional[Path] = None

    def get(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                path = self._build()
                try:
                    lib = ctypes.CDLL(str(path))
                    version = lib.dlimg_hostops_abi_version()
                except (OSError, AttributeError) as e:
                    raise DlimgError(f"loading {path} failed: {e}") from e
                if version != ABI_VERSION:
                    raise DlimgError(f"{path}: ABI version {version}, want "
                                     f"{ABI_VERSION}")
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = None
                self.path = path
                self._lib = lib
        return self._lib

    def _build(self) -> Path:
        cmd = [CXX, *CXX_FLAGS]
        try:
            source = SOURCE.read_bytes()
        except OSError as e:
            raise DlimgError(f"reading {SOURCE} failed (is the package "
                             f"installed without its csrc/ sources?): "
                             f"{e}") from e
        key = hashlib.sha256(source + " ".join(cmd).encode()
                             + platform.machine().encode()).hexdigest()[:16]
        target = BUILD_DIR / f"libdlimg_hostops_{key}.so"
        if target.exists():
            return target
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        work = Path(tempfile.mkdtemp(prefix="hostops-", dir=BUILD_DIR))
        try:
            tmp = work / target.name
            try:
                r = subprocess.run([*cmd, str(SOURCE), "-o", str(tmp)],
                                   capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.SubprocessError) as e:
                raise DlimgError(f"building {SOURCE.name} with {CXX} failed: "
                                 f"{e}") from e
            if r.returncode != 0:
                raise DlimgError(f"building {SOURCE.name} with {CXX} failed "
                                 f"(exit {r.returncode}):\n{r.stderr}")
            os.replace(tmp, target)  # atomic against a concurrent build
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return target


LIBRARY = HostOpsLibrary()


def pack_rgb(src: np.ndarray, cmap: Sequence[int], dst: np.ndarray,
             h: int, w: int) -> None:
    """dst[:h, :w, k] = src[:h, :w, cmap[k]] for k = 0, 1, 2, natively.

    src: uint8 (H, W, C) (pixels that are not packed (C, 1)-strided are
    made so first); dst: uint8 (rows, cols, 3) with packed pixels, any row
    stride. The arguments are checked here, since the native loop trusts
    them: a bad extent or channel index would write past the canvas."""
    if src.dtype != np.uint8 or dst.dtype != np.uint8:
        raise DlimgError("pack_rgb: src and dst must be uint8")
    c = src.shape[2]
    if ((c > 1 and src.strides[2] != 1) or src.strides[1] != c
            or src.strides[0] < c * w):
        src = np.ascontiguousarray(src)
    if dst.shape[2] != 3 or dst.strides[2] != 1 or dst.strides[1] != 3:
        raise DlimgError("pack_rgb: dst must hold packed RGB pixels")
    if (h > dst.shape[0] or w > dst.shape[1] or h > src.shape[0]
            or w > src.shape[1] or max(cmap) >= c or min(cmap) < 0):
        raise DlimgError(f"pack_rgb: extent ({h}, {w}) or channel map {cmap} "
                         f"out of bounds for src {src.shape}, dst {dst.shape}")
    if h <= 0 or w <= 0:
        return
    LIBRARY.get().dlimg_hostops_pack_rgb(
        src.ctypes.data, src.strides[0], h, w, c, cmap[0], cmap[1], cmap[2],
        dst.ctypes.data, dst.strides[0], 0)


def resize_mask_box(src: np.ndarray, dst: np.ndarray) -> None:
    """Box-filter resize of a single-channel uint8 image src (H, W) into
    dst (H', W'), the ``image/resize.py::resize_mask`` semantics within one
    grey level at rounding ties. Rows may be strided; pixels must be
    packed."""
    if (src.dtype != np.uint8 or dst.dtype != np.uint8 or src.ndim != 2
            or dst.ndim != 2 or src.strides[1] != 1 or dst.strides[1] != 1):
        raise DlimgError("resize_mask_box: src and dst must be 2-D uint8 with "
                         "packed pixels")
    LIBRARY.get().dlimg_hostops_resize_mask_box(
        src.ctypes.data, src.shape[0], src.shape[1], src.strides[0],
        dst.ctypes.data, dst.shape[0], dst.shape[1], dst.strides[0])
