"""K1 (fused_layer_norm) under other launch plans, on one GPU.

    python3 -m dlimgedit_tpu_torch.tools.sweep_layer_norm [--parent DIR]
        [--variants NAME,...] [--samples N]

Builds csrc/fused_layer_norm.cu once per variant (one nvcc each, all
started together), each from a copy of the source with some of K1's
constants replaced:

  design       the source as it is;
  blocks4      every block 4 warps (kLnMinWarpsPerBlock = 4);
  blocks2      every block 2 warps;
  blocks1      every block 1 warp;
  wave16       at most 16 resident warps an SM a wave (kLnWaveWarpsPerSm);
  lanes2       at most 2 chunks a lane (kLnMaxChunksPerLane: more lanes a row);
  lanes8       at most 8 chunks a lane (fewer lanes a row);
  dependent    programmatic dependent launch: launched with
               cudaLaunchKernelEx and
               cudaLaunchAttributeProgrammaticStreamSerialization, every
               block waiting (griddepcontrol.wait) before it reads memory and
               releasing the next kernel (griddepcontrol.launch_dependents)
               once its first row's loads are issued;
  parent       with --parent DIR, DIR/dlimgedit_tpu_torch/csrc/ (another
               checkout, e.g. an unpacked parent commit) as it is.

Each build's dlimg_layer_norm is held against ops.fused_norm's
layer_norm_plain in bf16 (atol 2e-2) at every shape, then timed in bf16 at
every shape of K1's table in chip_smoke.py with that table's launches
(SHAPES): back to back (CUDA events around 10 launches behind a spin kernel,
median of N samples) and inside a CUDA graph of 100 launches (one replay a
sample). It also times K1 in a graph behind another kernel, as the main
path runs it: 100 pairs of (x *= 1, an elementwise kernel writing K1's
input; K1), less 100 of the elementwise kernel alone. Prints, per variant,
the launch-weighted sums in ms (the back-to-back one compares with the `ms`
of chip_smoke.py's K1 entry), then per shape the times in us. Needs CUDA
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..ops import cuda_build
from ..ops.fused_norm import layer_norm_plain

SOURCE = "fused_layer_norm.cu"
# K1's bf16 shapes in chip_smoke.py's table and their launches there (826):
# MobileSAM's, the ViTs', the frames and the teacher, phase 12's sp shards
# and mesh rows, phase 13's row bands.
SHAPES = (
    (17689, 128, 12), (16384, 128, 12), (4900, 160, 36), (4096, 160, 36),
    (4900, 320, 12), (4096, 320, 12), (4096, 256, 12), (4096, 768, 32),
    (4096, 1024, 2), (4096, 1280, 26), (70756, 128, 2), (65536, 128, 2),
    (19600, 160, 6), (16384, 160, 6), (19600, 320, 2), (16384, 320, 2),
    (16384, 256, 2), (16384, 768, 1), (8192, 1280, 1), (35378, 128, 4),
    (32768, 128, 4), (9800, 160, 12), (8192, 160, 12), (9800, 320, 4),
    (8192, 320, 4), (8192, 256, 4), (1372, 768, 64), (1372, 1280, 224),
    (2548, 768, 32), (2548, 1280, 112), (8192, 768, 2), (9310, 128, 4),
    (8192, 128, 4), (2940, 160, 12), (2048, 160, 12), (2450, 320, 2),
    (2048, 320, 4), (2940, 320, 2), (2048, 256, 4), (4655, 128, 4),
    (4096, 128, 8), (5586, 128, 4), (1960, 160, 24), (1024, 160, 24),
    (1470, 320, 6), (1024, 320, 8), (1960, 320, 2), (1024, 256, 8))
EPS = 1e-6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SPIN_CYCLES = 20_000_000

# Variant -> [(line in the source, its replacement)]; the tool stops if a
# line is not in the source exactly once.
BLOCKS = "constexpr int kLnMinWarpsPerBlock = 1;\n"
MAX_BLOCK = "constexpr int kLnMaxWarpsPerBlock = 4;\n"
WAVE = "constexpr int kLnWaveWarpsPerSm = 32;\n"
CHUNKS = "constexpr int kLnMaxChunksPerLane = 5;\n"
WAIT_AT = "  uint4 sc[CPL], bi[CPL], cur[CPL];\n"
RELEASE_AFTER = ("  load_chunks<L, CPL>(x, warp * kRowsPerWarp + sub, rows, gl, "
                 "cur);\n")
LAUNCH_AT = "    layer_norm_kernel<T, kLanes, kPerLane>\n"
DEPENDENT_LAUNCH = """\
    {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(p.blocks);
      cfg.blockDim = dim3(p.warps_per_block * 32);
      cfg.stream = stream;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
      attr[0].val.programmaticStreamSerializationAllowed = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      cudaLaunchKernelEx(&cfg, layer_norm_kernel<T, kLanes, kPerLane>,
                         static_cast<const uint4*>(x),
                         static_cast<const uint4*>(scale),
                         static_cast<const uint4*>(bias),
                         static_cast<uint4*>(out), rows, eps);
      return cudaGetLastError();
    }
"""
VARIANTS = {
    "design": [],
    "blocks4": [(BLOCKS, BLOCKS.replace("= 1", "= 4"))],
    "blocks2": [(BLOCKS, BLOCKS.replace("= 1", "= 2")),
                (MAX_BLOCK, MAX_BLOCK.replace("= 4", "= 2"))],
    "blocks1": [(MAX_BLOCK, MAX_BLOCK.replace("= 4", "= 1"))],
    "wave16": [(WAVE, WAVE.replace("32", "16"))],
    "lanes2": [(CHUNKS, CHUNKS.replace("5", "2"))],
    "lanes8": [(CHUNKS, CHUNKS.replace("5", "8"))],
    "dependent": [
        (WAIT_AT, '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
         + WAIT_AT),
        (RELEASE_AFTER, RELEASE_AFTER
         + '  asm volatile("griddepcontrol.launch_dependents;");\n'),
        (LAUNCH_AT, DEPENDENT_LAUNCH + LAUNCH_AT)],
}


def variant_source(text: str, edits) -> str:
    for line, new in edits:
        if text.count(line) != 1:
            raise SystemExit(f"sweep_layer_norm: the line {line.strip()!r} is "
                             f"not in {SOURCE} once")
        text = text.replace(line, new)
    return text


def build(work: Path, names, parent) -> dict:
    """One library per variant, all compiled at once; name -> ctypes CDLL."""
    procs = {}
    nvcc = cuda_build._nvcc()
    for name in names:
        src = work / name
        origin = (parent / "dlimgedit_tpu_torch" / "csrc" if name == "parent"
                  else cuda_build.CSRC_DIR)
        src.mkdir()
        for f in origin.glob("*.cuh"):
            shutil.copy(f, src)
        text = (origin / SOURCE).read_text()
        if name != "parent":
            text = variant_source(text, VARIANTS[name])
        (src / SOURCE).write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", "-shared", "-o", str(work / f"{name}.so"),
             str(src / SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"sweep_layer_norm: nvcc failed for {name}:\n{out}")
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in out.splitlines() if "Used " in line})
        print(f"{name}: built ({'; '.join(regs)})", flush=True)
        lib = ctypes.CDLL(str(work / f"{name}.so"))
        for entry in ("dlimg_layer_norm", "dlimg_layer_norm_plan"):
            if hasattr(lib, entry):  # the parent may lack the plan
                getattr(lib, entry).argtypes = cuda_build._SIGNATURES[entry]
                getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


_SPIN = []


def spin_ms() -> float:
    if not _SPIN:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(SPIN_CYCLES)
        end.record()
        end.synchronize()
        _SPIN.append(start.elapsed_time(end))
    return _SPIN[0]


def time_us(fn, samples: int, per_sample: int = 10) -> float:
    """Device time of one call: median over samples of per_sample calls
    queued behind a spin kernel (a sample the host queued slower than the
    spin is taken again)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times, tries = [], 0
    while len(times) < samples:
        tries += 1
        if tries > 10 * samples:
            raise SystemExit("sweep_layer_norm: the host queued the timed "
                             "calls slower than the spin ahead of them")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(per_sample):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if host_ms < 0.75 * spin_ms():
            times.append(start.elapsed_time(end) * 1e3 / per_sample)
    return statistics.median(times)


def graph_us(fn, samples: int, n: int = 100) -> float:
    """Device time of one of n calls of fn captured in a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    return time_us(graph.replay, samples, per_sample=1) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout's root, built as variant 'parent'")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all)")
    ap.add_argument("--samples", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_layer_norm: needs a CUDA device", file=sys.stderr)
        return 2
    names = [n for n in args.variants.split(",") if n]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"sweep_layer_norm: unknown variants {sorted(unknown)}")
    if args.parent is not None:
        names.append("parent")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="sweep-ln-", dir=cuda_build.BUILD_DIR))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    try:
        libs = build(work, names, args.parent)
        print(f"{gpu}; bf16; us a launch: back to back (median of "
              f"{args.samples} x 10) / in a graph of 100 / in a graph behind "
              f"an elementwise kernel", flush=True)
        sums = {n: [0.0, 0.0, 0.0] for n in names}
        bound = 0.0
        for rows, C, launches in SHAPES:
            x = torch.randn((rows, C), generator=gen, device=dev).to(torch.bfloat16)
            scale = (0.25 + 0.5 * torch.rand((C,), generator=gen, device=dev)
                     ).to(torch.bfloat16)
            bias = (0.5 * torch.rand((C,), generator=gen, device=dev) - 0.25
                    ).to(torch.bfloat16)
            out = torch.empty_like(x)
            want = layer_norm_plain(x, scale, bias, EPS)
            bytes_us = (2 * rows * C + 2 * C) * 2 / HBM_BYTES_PER_S * 1e6
            bound += bytes_us * launches / 1e3
            cells = []
            elementwise = graph_us(lambda: x.mul_(1.0), args.samples)
            for name, lib in libs.items():
                def call(lib=lib):
                    rc = lib.dlimg_layer_norm(
                        x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                        out.data_ptr(), rows, C, 1, EPS,
                        torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise SystemExit(f"sweep_layer_norm: {name} ({rows},"
                                         f"{C}) failed to launch: {rc}")
                out.zero_()
                call()
                err = (out.float() - want.float()).abs().max().item()
                if not err <= 2e-2:
                    raise SystemExit(f"sweep_layer_norm: {name} ({rows},{C}): "
                                     f"max|diff| {err} > 2e-2")
                eager = time_us(call, args.samples)
                in_graph = graph_us(call, args.samples)
                behind = graph_us(lambda: (x.mul_(1.0), call()),
                                  args.samples) - elementwise
                for i, t in enumerate((eager, in_graph, behind)):
                    sums[name][i] += t * launches / 1e3
                plan = ""
                if hasattr(lib, "dlimg_layer_norm_plan"):
                    p = (ctypes.c_int * 5)()
                    lib.dlimg_layer_norm_plan(rows, C, 1, p)
                    plan = " plan " + ",".join(map(str, p))
                cells.append(f"{name} {eager:.2f}/{in_graph:.2f}/{behind:.2f}"
                             f"{plan}")
            print(f"({rows},{C}) x{launches} bound {bytes_us:.2f}: "
                  + "; ".join(cells), flush=True)
        print(f"launch-weighted sums over {sum(s[2] for s in SHAPES)} launches "
              f"(ms; bound {bound:.5f}):")
        for name, (eager, in_graph, behind) in sums.items():
            print(f"  {name}: back to back {eager:.5f}, in a graph "
                  f"{in_graph:.5f}, behind an elementwise kernel {behind:.5f}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
