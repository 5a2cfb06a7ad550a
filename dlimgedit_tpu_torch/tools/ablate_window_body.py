"""Where the time of the bf16 window body goes on one GPU (K5, K7, K6).

    python3 -m dlimgedit_tpu_torch.tools.ablate_window_body

Builds the kernel sources again, with parts of the tensor-core window body
of csrc/relpos_attention_tc.cu compiled out, and times each build's K5, K7
and K6 entry points at ViT-B's and ViT-H's shapes at 1024 (CUDA events
around back-to-back launches, median of 10 samples):

  full         the kernels as they are;
  no_prologue  K6's bias prologue replaced by zeros (K5 and K7 unchanged);
  no_stripes   every block returns after its loads and its bias staging;
  loads_only   both.

The ablated builds compute wrong outputs by design: only their times mean
anything. The switches are inserted into a copy of the source at fixed
lines; the tool stops if those lines have changed. Needs CUDA and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..ops import cuda_build

# (anchor line in relpos_attention_tc.cu, lines inserted before it)
SWITCHES = (
    ("    const int m0 = min(gr, ws - 1), m1 = min(gr + 8, ws - 1);\n",
     "#ifdef ABLATE_PROLOGUE\n"
     "    for (int e = threadIdx.x; e < ws * ws * kBiasCols; e += kWinThreads)\n"
     "      ba[e] = __float2bfloat16_rn(0.f);\n"
     "    return;\n"
     "#endif\n"),
    ("  const int stripes = (nq + 15) / 16;  // stripes holding a kept row\n",
     "#ifdef ABLATE_STRIPES\n"
     "  if (nq > 0) return;\n"
     "#endif\n"),
)
VARIANTS = {"full": [], "no_prologue": ["-DABLATE_PROLOGUE"],
            "no_stripes": ["-DABLATE_STRIPES"],
            "loads_only": ["-DABLATE_PROLOGUE", "-DABLATE_STRIPES"]}
ENTRIES = ("dlimg_relpos_attention_windowed", "dlimg_relpos_attention_qkv",
           "dlimg_window_strip_attention")
# (label, heads, head width) at 1024: a 70 x 70 padded grid of 14 x 14 windows
MODELS = (("ViT-B", 12, 64), ("ViT-H", 16, 80))


def build(work: Path) -> dict:
    """One library per variant, all compiled at once; name -> ctypes CDLL."""
    src = work / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, src)
    tc = src / "relpos_attention_tc.cu"
    text = tc.read_text()
    for anchor, insert in SWITCHES:
        if text.count(anchor) != 1:
            raise SystemExit(f"ablate_window_body: the line {anchor.strip()!r} "
                             f"is not in relpos_attention_tc.cu once")
        text = text.replace(anchor, insert + anchor)
    tc.write_text(text)
    nvcc, sources = cuda_build._nvcc(), sorted(map(str, src.glob("*.cu")))
    procs = {name: subprocess.Popen(
        [nvcc, *cuda_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
         "-fPIC", "-shared", *flags, "-o", str(work / f"{name}.so"), *sources],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in VARIANTS.items()}
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"ablate_window_body: nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(str(work / f"{name}.so"))
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = cuda_build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_us(fn, samples: int = 10, per_sample: int = 50) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / per_sample)
    return statistics.median(times)


def launches(heads: int, hd: int, stream: int):
    """(kernel label, lib -> C call) at one model's shapes, seeded inputs."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    grid, ws, W = 70, 14, 25
    n, G, C = ws * ws, W * heads, heads * hd

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    scale = float(hd ** -0.5)
    q, k, v = randn(G, n, hd), randn(G, n, hd), randn(G, n, hd)
    bhw, out = randn(G, n, 2 * ws), torch.empty_like(q)
    qkv5 = randn(W, 3, heads, n, hd)
    qkv = randn(1, grid, grid, 3 * C)
    rh, rw = 0.3 * randn(ws, ws, hd), 0.3 * randn(ws, ws, hd)
    out6 = torch.empty((1, grid, grid, C), device=dev, dtype=torch.bfloat16)
    p = torch.Tensor.data_ptr
    return (
        ("K5", lambda lib: lib.dlimg_relpos_attention_windowed(
            p(q), p(k), p(v), p(bhw), p(out), G, n, hd, ws, ws, 1,
            (W - 5) * heads, 8 * ws, 1, scale, stream)),
        ("K7", lambda lib: lib.dlimg_relpos_attention_qkv(
            p(qkv5), p(bhw), p(out), W, heads, n, hd, ws, ws, 1, scale,
            stream)),
        ("K6", lambda lib: lib.dlimg_window_strip_attention(
            p(qkv), p(qkv) + 2 * C, p(qkv) + 4 * C, p(rh), p(rw), p(out6), 1,
            grid, grid, C, 3 * C, ws, heads, hd, 1, scale, stream)),
    )


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_window_body: needs a CUDA device", file=sys.stderr)
        return 2
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="ablate-", dir=cuda_build.BUILD_DIR))
    try:
        libs = build(work)
        stream = torch.cuda.current_stream().cuda_stream
        print(f"{gpu}; bf16, us a launch (median of 10 x 50)")
        print(f"{'':12}" + "".join(f"{name:>13}" for name in VARIANTS))
        for model, heads, hd in MODELS:
            for label, call in launches(heads, hd, stream):
                for name, lib in libs.items():
                    if call(lib) != 0:
                        raise SystemExit(f"ablate_window_body: {label} "
                                         f"({name}) failed to launch")
                row = [time_us(lambda: call(lib)) for lib in libs.values()]
                print(f"{model} {label:6}" + "".join(f"{t:13.2f}" for t in row),
                      flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
