"""Build the port's C library and its executables (the port's counterpart of
native/CMakeLists.txt), with the C++ compiler called directly:

    python -m dlimgedit_tpu_torch.native_build [--serving]

builds (when not built yet) and prints the paths, the compiler and the
codecs found.

From ``dlimgedit_tpu_torch/native/`` and ``csrc/hostops.cpp`` it builds

  libdlimgedit_tpu_torch.so  the dlimg_Api table (native/src/capi.cpp), the
                             native codecs (native/src/codecs.cpp) and the
                             host loops (csrc/hostops.cpp); it embeds the
                             interpreter that runs this module and imports
                             ``dlimgedit_tpu_torch.native_bridge``
  dlimg                      the command-line tool (native/tools/cli.cpp)
  dlimg-serve                the HTTP daemon (native/tools/serve.cpp)
  test_cpp_api               the standalone embedder's smoke test
  test_cpp_dynamic           the ``dlopen`` client (DLIMGEDIT_LOAD_DYNAMIC)

each executable with an ``$ORIGIN`` rpath to the library, all into
``dlimgedit_tpu_torch/_build/native_<hash>/``. With ``--serving``
(``build_serving()``) it also builds, into the same directory,

  libdlimgedit_tpu_torch_serving.so
                             the Python-free serving backend
                             (native/src/torch_backend.cpp,
                             torch_programs.cpp) on libtorch's ATen, which
                             the library dlopens when DLIMG_PJRT_BUNDLE is
                             set; linked against the installed torch (its
                             C++ ABI flag, an rpath to torch/lib, and on a
                             CUDA build libtorch_cuda with --no-as-needed, so
                             that its CUDA hooks register)
  test_serving               the public C++ API against a serving bundle
  test_serving_programs      each program of a bundle against its samples
  test_bundle_parse          a bundle's specs against its .npy files

so the embedded-mode library keeps its build time and links no libtorch.
The hash covers every source and every flag: the compiler, the
interpreter's paths (baked into the library: see the head of capi.cpp),
the codecs and the torch installation. libpng and libjpeg are
compiled in where a test program that includes their header links against
them (CMake's ``find_package(PNG)`` / ``find_package(JPEG)`` in
native/CMakeLists.txt); without them PNG and JPEG files go through the
bridge (Pillow).

Each translation unit compiles in its own process, all started together.
The build runs at first use under a file lock and is renamed into place
when complete, so several processes (a daemon, xdist workers) may ask for
it at once. A failed build, a missing ``Python.h`` or a missing shared
libpython raises ``DlimgError`` with what the compiler said.

``load_api(build().library)`` loads the library into this process with
ctypes and returns ``dlimg_init()``'s table (``DlimgApi``).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .errors import DlimgError

PACKAGE_DIR = Path(__file__).resolve().parent
NATIVE_DIR = PACKAGE_DIR / "native"
INCLUDE_DIR = NATIVE_DIR / "include"
BUILD_DIR = PACKAGE_DIR / "_build"
LIBRARY_NAME = "libdlimgedit_tpu_torch.so"
CXX_FLAGS = ["-std=c++17", "-O2", "-fPIC", "-Wall", "-Wextra", "-pthread"]
SERVING_LIBRARY = "libdlimgedit_tpu_torch_serving.so"
SERVING_SOURCES = (NATIVE_DIR / "src" / "torch_backend.cpp",
                   NATIVE_DIR / "src" / "torch_programs.cpp")
# serving executable -> (source, what it links: "library", "serving", None)
SERVING_EXECUTABLES = {
    "test_serving": (NATIVE_DIR / "test" / "test_serving.cpp", "library"),
    "test_serving_programs": (NATIVE_DIR / "test" / "test_serving_programs.cpp",
                              "serving"),
    "test_bundle_parse": (NATIVE_DIR / "test" / "test_bundle_parse.cpp", None),
}
LIBRARY_SOURCES = (NATIVE_DIR / "src" / "capi.cpp",
                   NATIVE_DIR / "src" / "codecs.cpp",
                   PACKAGE_DIR / "csrc" / "hostops.cpp")
# executable -> (source, links the library)
EXECUTABLES = {
    "dlimg": (NATIVE_DIR / "tools" / "cli.cpp", True),
    "dlimg-serve": (NATIVE_DIR / "tools" / "serve.cpp", True),
    "test_cpp_api": (NATIVE_DIR / "test" / "test_cpp_api.cpp", True),
    "test_cpp_dynamic": (NATIVE_DIR / "test" / "test_cpp_dynamic.cpp", False),
}
# codec -> (define, link flag, a program that needs both)
CODECS = {
    "libpng": ("DLIMG_HAVE_LIBPNG", "-lpng",
               "#include <png.h>\n"
               "int main() { return png_access_version_number() == 0; }\n"),
    "libjpeg": ("DLIMG_HAVE_LIBJPEG", "-ljpeg",
                "#include <cstdio>\n#include <jpeglib.h>\n"
                "int main() { jpeg_error_mgr e; return !jpeg_std_error(&e); }\n"),
}
TIMEOUT_S = 600


def compiler() -> Optional[str]:
    """The C++ compiler on PATH (c++, g++ or clang++), or None."""
    for name in ("c++", "g++", "clang++"):
        found = shutil.which(name)
        if found:
            return found
    return None


def sources() -> List[Path]:
    """Every file the build reads: the package data that must ship."""
    return sorted([p for p in NATIVE_DIR.rglob("*")
                   if p.is_file() and p.suffix in (".h", ".hpp", ".cpp")]
                  + [PACKAGE_DIR / "csrc" / "hostops.cpp"])


def python_flags() -> Tuple[List[str], List[str]]:
    """(compile flags, link flags) that embed the interpreter running this
    module: its headers, its shared libpython with an rpath, and its
    executable and the package's root baked in (capi.cpp's head)."""
    include = Path(sysconfig.get_config_var("INCLUDEPY") or "")
    if not (include / "Python.h").is_file():
        raise DlimgError(f"Python.h not found in {include}: the C library "
                         f"embeds the interpreter {sys.executable} and needs "
                         f"its development headers")
    libdir = Path(sysconfig.get_config_var("LIBDIR") or "")
    library = libdir / (sysconfig.get_config_var("LDLIBRARY") or "")
    if library.suffix != ".so" or not library.is_file():
        raise DlimgError(f"no shared libpython for {sys.executable} "
                         f"({library}): the C library must link one to "
                         f"embed the interpreter")
    # json.dumps of an ASCII path is a valid C string literal.
    return ([f"-I{include}",
             f"-DDLIMG_PYTHON_EXECUTABLE={json.dumps(sys.executable)}",
             f"-DDLIMG_PACKAGE_ROOT={json.dumps(str(PACKAGE_DIR.parent))}"],
            [str(library), f"-Wl,-rpath,{libdir}"])


def torch_flags(cuda_home: Optional[str] = None) -> Tuple[List[str], List[str]]:
    """(compile flags, link flags) of a translation unit on libtorch's ATen:
    the installed torch's headers, its C++ ABI flag, and its libraries
    with an rpath; on a CUDA build of torch also the CUDA headers
    (``cuda_home``) and libtorch_cuda / libc10_cuda, linked with
    --no-as-needed (nothing names them, but their static initialisers
    register the CUDA hooks: without them a C++ process sees no CUDA).
    The C++ standard follows torch: gnu++20 from torch 2.12 on."""
    import torch

    root = Path(torch.__file__).resolve().parent
    lib = root / "lib"
    if not (root / "include" / "ATen" / "ATen.h").is_file():
        raise DlimgError(f"no ATen headers in {root / 'include'}: the serving "
                         f"library is built against the installed torch")
    major, minor = (int(v) for v in torch.__version__.split(".")[:2])
    std = "-std=gnu++20" if (major, minor) >= (2, 12) else "-std=gnu++17"
    cflags = [std, "-O2", "-fPIC", "-pthread", "-Wall", "-Wextra",
              "-Wno-unused-parameter",
              f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
              f"-I{root / 'include'}"]
    libs = ["-lc10", "-ltorch_cpu", "-ltorch"]
    if torch.version.cuda is not None and (lib / "libtorch_cuda.so").is_file():
        if cuda_home is None:
            from torch.utils.cpp_extension import CUDA_HOME

            cuda_home = CUDA_HOME
        if not cuda_home or not (Path(cuda_home) / "include"
                                 / "cuda_runtime_api.h").is_file():
            raise DlimgError(f"torch {torch.__version__} is a CUDA build, but "
                             f"no CUDA headers were found (CUDA_HOME "
                             f"{cuda_home}): the serving library includes "
                             f"ATen's CUDA headers")
        cflags += ["-DDLIMG_SERVING_CUDA", f"-I{Path(cuda_home) / 'include'}"]
        libs += ["-lc10_cuda", "-ltorch_cuda"]
    return cflags, [f"-L{lib}", "-Wl,--no-as-needed", *libs,
                    "-Wl,--as-needed", f"-Wl,-rpath,{lib}"]


def _torch_identity() -> List[str]:
    """What of the installed torch a serving build depends on."""
    import torch

    return [torch.__version__, str(Path(torch.__file__).resolve().parent),
            str(torch._C._GLIBCXX_USE_CXX11_ABI), str(torch.version.cuda)]


def _run_all(commands: Dict[str, List[str]]) -> Dict[str, subprocess.CompletedProcess]:
    """Run the commands in parallel: -> name -> finished process."""
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, cmd in commands.items()}
    done = {}
    for name, proc in procs.items():
        try:
            out, _ = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            raise DlimgError(f"{name}: the compiler ran over {TIMEOUT_S} s")
        done[name] = subprocess.CompletedProcess(commands[name],
                                                 proc.returncode, out)
    return done


def find_codecs(cxx: str, work: Path) -> Tuple[str, ...]:
    """The codecs whose header and library the compiler finds."""
    commands = {}
    for name, (_, lib, program) in CODECS.items():
        src = work / f"probe_{name}.cpp"
        src.write_text(program)
        commands[name] = [cxx, str(src), "-o", str(work / f"probe_{name}"),
                          lib]
    return tuple(name for name, r in _run_all(commands).items()
                 if r.returncode == 0)


@dataclass(frozen=True)
class NativeBuild:
    """A finished build: its directory and what went into it."""

    directory: Path
    compiler: str
    codecs: Tuple[str, ...]
    seconds: Optional[float]  # None when this process found it built

    @property
    def library(self) -> Path:
        return self.directory / LIBRARY_NAME

    @property
    def serving_library(self) -> Path:
        """The serving library (present after ``build_serving()``)."""
        return self.directory / SERVING_LIBRARY

    def executable(self, name: str) -> Path:
        if name not in EXECUTABLES and name not in SERVING_EXECUTABLES:
            raise DlimgError(f"no executable {name!r} in the native build")
        return self.directory / name


class NativeBuilder:
    """Builds once per process (thread-safe) and once per machine (a file
    lock around the build, an atomic rename at its end)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._build: Optional[NativeBuild] = None
        self._serving: Optional[NativeBuild] = None

    def get(self) -> NativeBuild:
        with self._lock:
            if self._build is None:
                self._build = self._get()
            return self._build

    def get_serving(self) -> NativeBuild:
        """The build with the serving library and its test programs."""
        build = self.get()
        with self._lock:
            if self._serving is None:
                self._serving = self._get_serving(build)
            return self._serving

    def _get_serving(self, build: NativeBuild) -> NativeBuild:
        with open(BUILD_DIR / "native.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if build.serving_library.is_file():
                return build
            t0 = time.perf_counter()
            work = Path(tempfile.mkdtemp(prefix="serving-", dir=BUILD_DIR))
            try:
                self._compile_serving(build.compiler, build.directory, work)
                # The library last: its presence marks a complete build.
                for name in (*SERVING_EXECUTABLES, SERVING_LIBRARY):
                    os.replace(work / name, build.directory / name)
            finally:
                shutil.rmtree(work, ignore_errors=True)
            return NativeBuild(build.directory, build.compiler, build.codecs,
                               time.perf_counter() - t0)

    @staticmethod
    def _compile_serving(cxx: str, directory: Path, work: Path,
                         sources=SERVING_SOURCES,
                         executables=SERVING_EXECUTABLES) -> None:
        """Compile the serving library and its executables into `work`;
        `directory` holds the embedded-mode library test_serving links."""
        t_cflags, t_ldflags = torch_flags()
        inc = [f"-I{INCLUDE_DIR}"]
        obj = work / "obj"
        obj.mkdir()
        commands = {src.name: [cxx, *t_cflags, *inc, "-c", str(src),
                               "-o", str(obj / (src.stem + ".o"))]
                    for src in sources}
        for name, (src, links) in executables.items():
            flags = t_cflags if links == "serving" else CXX_FLAGS
            commands[name] = [cxx, *flags, *inc, "-c", str(src),
                              "-o", str(obj / f"{name}.o")]
        _check(_run_all(commands))
        library = work / SERVING_LIBRARY
        _check(_run_all({SERVING_LIBRARY: [
            cxx, "-shared", "-pthread", f"-Wl,-soname,{SERVING_LIBRARY}",
            "-o", str(library), *(str(obj / (src.stem + ".o"))
                                  for src in sources),
            *t_ldflags, "-ldl"]}))
        links = {}
        for name, (_, what) in executables.items():
            extra = {"library": [str(directory / LIBRARY_NAME),
                                 "-Wl,-rpath,$ORIGIN", "-ldl"],
                     "serving": [str(library), "-Wl,-rpath,$ORIGIN",
                                 *t_ldflags],
                     None: []}[what]
            links[name] = [cxx, "-pthread", "-o", str(work / name),
                           str(obj / f"{name}.o"), *extra]
        _check(_run_all(links))

    def _get(self) -> NativeBuild:
        cxx = compiler()
        if cxx is None:
            raise DlimgError("no C++ compiler (c++, g++, clang++) on PATH: "
                             "the port's C library cannot be built")
        py_cflags, py_ldflags = python_flags()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="probe-", dir=BUILD_DIR) as t:
            codecs = find_codecs(cxx, Path(t))
        codec_cflags = [f"-D{CODECS[c][0]}" for c in codecs]
        codec_ldflags = [CODECS[c][1] for c in codecs]
        cflags = [*CXX_FLAGS, f"-I{INCLUDE_DIR}", *codec_cflags]
        h = hashlib.sha256(Path(__file__).read_bytes())  # the link lines
        for path in sources():
            h.update(str(path.relative_to(PACKAGE_DIR)).encode())
            h.update(path.read_bytes())
        h.update(json.dumps([cxx, cflags, py_cflags, py_ldflags,
                             codec_ldflags, _torch_identity()]).encode())
        target = BUILD_DIR / f"native_{h.hexdigest()[:16]}"
        with open(BUILD_DIR / "native.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if (target / LIBRARY_NAME).is_file():
                return NativeBuild(target, cxx, codecs, None)
            t0 = time.perf_counter()
            work = Path(tempfile.mkdtemp(prefix="native-", dir=BUILD_DIR))
            try:
                self._compile(cxx, cflags, py_cflags, py_ldflags,
                              codec_ldflags, work)
                shutil.rmtree(work / "obj")
                work.rename(target)
            finally:
                shutil.rmtree(work, ignore_errors=True)
            return NativeBuild(target, cxx, codecs, time.perf_counter() - t0)

    @staticmethod
    def _compile(cxx, cflags, py_cflags, py_ldflags, codec_ldflags,
                 work: Path) -> None:
        obj = work / "obj"
        obj.mkdir()
        commands = {}
        for src in LIBRARY_SOURCES:
            commands[src.name] = [
                cxx, *cflags, *py_cflags, "-DDLIMGEDIT_EXPORTS",
                "-fvisibility=hidden", "-fvisibility-inlines-hidden",
                "-c", str(src), "-o", str(obj / (src.stem + ".o"))]
        for name, (src, _) in EXECUTABLES.items():
            commands[name] = [cxx, *cflags, "-c", str(src),
                              "-o", str(obj / f"{name}.o")]
        _check(_run_all(commands))
        library = work / LIBRARY_NAME
        _check(_run_all({LIBRARY_NAME: [
            cxx, "-shared", "-pthread", f"-Wl,-soname,{LIBRARY_NAME}",
            "-o", str(library),
            *(str(obj / (src.stem + ".o")) for src in LIBRARY_SOURCES),
            *codec_ldflags, *py_ldflags, "-ldl"]}))
        links = {}
        for name, (_, links_library) in EXECUTABLES.items():
            extra = ([str(library), "-Wl,-rpath,$ORIGIN"] if links_library
                     else ["-ldl"])
            links[name] = [cxx, "-pthread", "-o", str(work / name),
                           str(obj / f"{name}.o"), *extra]
        _check(_run_all(links))


def _check(results: Dict[str, subprocess.CompletedProcess]) -> None:
    failed = {name: r for name, r in results.items() if r.returncode != 0}
    if failed:
        raise DlimgError("building the port's C library failed:\n" + "\n".join(
            f"== {name} (exit {r.returncode}): {' '.join(r.args)}\n{r.stdout}"
            for name, r in failed.items()))


BUILDER = NativeBuilder()


def build() -> NativeBuild:
    """The port's native build, built first if needed."""
    return BUILDER.get()


def build_serving() -> NativeBuild:
    """The native build with the serving library and its test programs,
    built first if needed."""
    return BUILDER.get_serving()


# The table of native/include/dlimgedit/detail/dlimgedit.h as ctypes sees
# it, for a Python host that loads the library (``load_api``). The
# CFUNCTYPE entries release the GIL for the call, as a C host runs them.
_U8P = ctypes.POINTER(ctypes.c_uint8)
_IP = ctypes.POINTER(ctypes.c_int)
_FP = ctypes.POINTER(ctypes.c_float)
_VP = ctypes.c_void_p


class DlimgImageView(ctypes.Structure):
    _fields_ = [("width", ctypes.c_int), ("height", ctypes.c_int),
                ("channels", ctypes.c_int), ("stride", ctypes.c_int),
                ("pixels", _U8P)]


class DlimgOptions(ctypes.Structure):
    _fields_ = [("backend", ctypes.c_int),
                ("model_directory", ctypes.c_char_p)]


_F = ctypes.CFUNCTYPE


class DlimgApi(ctypes.Structure):
    _fields_ = [
        ("is_backend_supported", _F(ctypes.c_int, ctypes.c_int)),
        ("create_environment", _F(ctypes.c_int, ctypes.POINTER(_VP),
                                  ctypes.POINTER(DlimgOptions))),
        ("destroy_environment", _F(None, _VP)),
        ("process_image_for_segmentation", _F(
            ctypes.c_int, ctypes.POINTER(_VP), ctypes.POINTER(DlimgImageView),
            _VP)),
        ("get_segmentation_mask", _F(ctypes.c_int, _VP, _IP, _IP,
                                     ctypes.POINTER(_U8P), _FP)),
        ("get_segmentation_extent", _F(None, _VP, _IP)),
        ("destroy_segmentation", _F(None, _VP)),
        ("segment_objects", _F(ctypes.c_int, ctypes.POINTER(DlimgImageView),
                               _U8P, _VP)),
        ("load_image", _F(ctypes.c_int, ctypes.c_char_p, _IP, _IP,
                          ctypes.POINTER(_U8P))),
        ("save_image", _F(ctypes.c_int, ctypes.POINTER(DlimgImageView),
                          ctypes.c_char_p)),
        ("create_image", _F(_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int)),
        ("destroy_image", _F(None, _U8P)),
        ("last_error", _F(ctypes.c_char_p)),
        ("generate_masks", _F(ctypes.c_int, _VP, _FP, ctypes.c_int,
                              ctypes.POINTER(_U8P), _FP, _IP)),
        ("compute_mask_batch", _F(ctypes.c_int, _VP, _IP, _IP, ctypes.c_int,
                                  ctypes.POINTER(_U8P), _FP)),
    ]


def load_api(library: Path) -> DlimgApi:
    """``dlimg_init()``'s table of the library at `library`, loaded into
    this process (the library then imports the bridge into this
    interpreter)."""
    lib = ctypes.CDLL(str(library))
    lib.dlimg_init.restype = ctypes.POINTER(DlimgApi)
    api = lib.dlimg_init().contents
    api._library = lib  # the table's functions live as long as the table
    return api


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--serving"]):
        print("usage: python -m dlimgedit_tpu_torch.native_build [--serving]",
              file=sys.stderr)
        return 2
    serving = argv == ["--serving"]
    b = build_serving() if serving else build()
    took = ("already built" if b.seconds is None
            else f"built in {b.seconds:.2f} s")
    print(f"compiler {b.compiler}; codecs: "
          f"{', '.join(b.codecs) or 'none (PNG and JPEG through the bridge)'}; "
          f"{took}")
    print(f"{'library':<17}{b.library}")
    for name in EXECUTABLES:
        print(f"{name:<17}{b.executable(name)}")
    if serving:
        print(f"{'serving library':<17}{b.serving_library}")
        for name in SERVING_EXECUTABLES:
            print(f"{name:<17}{b.executable(name)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
