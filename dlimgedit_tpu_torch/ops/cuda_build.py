"""Build and load the port's hand-written CUDA kernels.

The sources in ``dlimgedit_tpu_torch/csrc/`` are compiled with ``nvcc`` for
Hopper (``sm_90a``) into ONE shared library with a plain C interface, which
is loaded with ``ctypes``. Nothing here includes PyTorch's headers, so a
build takes seconds. Each ``.cu`` file is compiled by its own ``nvcc``
process, all started together, and the objects are linked at the end.

The build happens at the first kernel launch, into
``dlimgedit_tpu_torch/_build/``. The library's file name carries a hash of
the sources and flags, so an edited source never loads a stale library; the
finished library is moved into place atomically. A failed build raises
``DlimgError``: no kernel falls back to its plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

from ..errors import DlimgError

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]

# Element-type codes of the C entry points (csrc/common.cuh): the dtypes
# every kernel takes (P1, greedy_nms, takes float32 boxes only).
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1, "torch.float16": 2}
KERNEL_DTYPES = "float32, bfloat16 or float16"

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point: argtypes, restype int (a cudaError_t).
_SIGNATURES = {
    # x, scale, bias, out, rows, cols, dtype, eps, stream
    "dlimg_layer_norm": [_VP, _VP, _VP, _VP, _I, _I, _I, _F, _VP],
    # rows, cols, dtype, plan (5 ints out: K1's launch plan)
    "dlimg_layer_norm_plan": [_I, _I, _I, _VP],
    # x, d, scale, bias, s_out, out, rows, cols, dtype, eps, stream
    "dlimg_add_layer_norm": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _F, _VP],
    # qkv, bias, out, g, n, nh, kd, dtype, scale, stream
    "dlimg_levit_attention": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _VP],
    # q, k, v, bhw, out, g, n, hd, gh, gw, dtype, scale, stream
    "dlimg_relpos_attention_global": [_VP] * 5 + [_I] * 6 + [_F, _VP],
    # q, k, v, bhw, out, g, n, hd, gh, gw, folded, g_skip, n_valid, dtype,
    # scale, stream
    "dlimg_relpos_attention_windowed": [_VP] * 5 + [_I] * 9 + [_F, _VP],
    # qkv, bhw, out, w, nh, n, hd, gh, gw, dtype, scale, stream
    "dlimg_relpos_attention_qkv": [_VP] * 3 + [_I] * 7 + [_F, _VP],
    # q, k, v, rh, rw, out, b, hp, wp, c, ts, ws, nh, hd, dtype, scale, stream
    "dlimg_window_strip_attention": [_VP] * 6 + [_I] * 9 + [_F, _VP],
    # kernel, dtype, hd, n, gh, gw, heads: 0 tuned, 1 general
    "dlimg_attention_route": [_I] * 7,
    # table, idx, out, rows, lanes, reps, row_chunks, dtype, stream
    "dlimg_gather_probe": [_VP] * 3 + [_I] * 5 + [_VP],
    # boxes, scores, thresh, keep, scratch, scratch words, m, stream
    "dlimg_greedy_nms": [_VP] * 5 + [ctypes.c_longlong, _I, _VP],
    # x, q, scale, rows, cols, dtype, stream
    "dlimg_quantize_rows_int8": [_VP] * 3 + [_I] * 3 + [_VP],
    # acc, x_scale, w_scale, b, y, rows, cols, dtype, stream
    "dlimg_int8_epilogue": [_VP] * 5 + [_I] * 3 + [_VP],
}


def _sources() -> List[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(COMPILE_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise DlimgError("nvcc not found (PATH, CUDA_HOME): the port's CUDA "
                     "kernels cannot be built")


class KernelLibrary:
    """The loaded kernel library; built on first use (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.path: Optional[Path] = None
        self.build_seconds: Optional[float] = None
        # nvcc's output of the build this process ran (ptxas register and
        # shared-memory report); empty when the library was already built.
        self.build_log = ""

    def get(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                path = self._build()
                lib = ctypes.CDLL(str(path))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self.path = path
                self._lib = lib
        return self._lib

    def _build(self) -> Path:
        import time

        target = BUILD_DIR / f"libdlimg_kernels_{source_hash()}.so"
        if target.exists():
            return target
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        work = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
        try:
            procs = []
            for src in _sources():
                if src.suffix != ".cu":
                    continue
                obj = work / (src.stem + ".o")
                cmd = [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
                procs.append((src, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            logs, failed = [], []
            for src, _, proc in procs:
                out, _ = proc.communicate()
                logs.append(f"== {src.name}\n{out}")
                if proc.returncode != 0:
                    failed.append(src.name)
            self.build_log = "\n".join(logs)
            if failed:
                raise DlimgError(f"nvcc failed on {', '.join(failed)}:\n"
                                 f"{self.build_log}")
            tmp_lib = work / target.name
            link = subprocess.run(
                [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                 *(str(obj) for _, obj, _ in procs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if link.returncode != 0:
                raise DlimgError(f"linking the kernel library failed:\n"
                                 f"{link.stdout}")
            os.replace(tmp_lib, target)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        self.build_seconds = time.perf_counter() - t0
        return target


LIBRARY = KernelLibrary()


def kernel_operand(t):
    """``t`` as a kernel reads it: dense (row-major) and starting on a
    16-byte boundary, the layout every kernel's 16-byte loads take.

    Returns ``t`` itself when it already is; otherwise ``t.contiguous()``,
    or a clone where that is still off 16 bytes (a contiguous view at an
    odd storage offset), and counts the copy in ``kernel_operand.copies``.
    Every wrapper passes every pointer it hands a kernel through this one
    rule, so a kernel takes any view the plain version takes; the main
    paths' operands are dense and aligned, and the count over them stays
    0. The C entry points still refuse a misaligned pointer."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    kernel_operand.copies += 1
    c = t.contiguous()
    return c.clone() if c.data_ptr() % 16 else c


kernel_operand.copies = 0


def check_launch(name: str, rc: int, shape: str = "") -> None:
    """Raise if a C entry point reported a CUDA error (its return value is
    the cudaError_t of the launch); ``shape`` names the call's shape."""
    if rc != 0:
        at = f" on {shape}" if shape else ""
        raise DlimgError(f"CUDA kernel {name} failed to launch{at}: "
                         f"cudaError {rc}")
