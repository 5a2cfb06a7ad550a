"""Device memory of the serving pipeline, per phase (counterpart of
tools/memory_footprint.py, the JAX package's tool).

    python -m dlimgedit_tpu_torch.tools.memory_footprint [--variant mobile_sam] [--size 1024]
    hermetic, on the CPU: --backend cpu --sam-image-size 64 --birefnet-resolution 64

The counterpart of the reference's published "~500 MB VRAM
(segmentation)" row: it loads each component through the public runtime
path and reads the card's memory after every phase: the environment, the
SAM variant's weights, ``process``, a click (``compute_mask``), automatic
mask generation (``generate_masks``), BiRefNet's weights and
``segment_objects``. Per phase (deltas over the phase):

  * allocated: ``torch.cuda.memory_allocated``, the caching allocator's
    live tensors (weights, the embedding, each CUDA graph's static
    outputs);
  * reserved: ``torch.cuda.memory_reserved``, what the allocator holds
    from the CUDA driver: also each graph's private pool, whose intermediates
    are reserved there, not allocated, once the graph is captured;
  * driver: the CUDA driver's used bytes, ``torch.cuda.mem_get_info`` (what
    ``nvidia-smi`` counts: also the CUDA context and cuBLAS's workspaces);
  * peak: ``max_memory_allocated`` during the phase (reset before it),
    above the allocated bytes at its start;
  * analytic: the bytes the phase must hold, from shapes: a model's
    parameters and persistent buffers (its ``state_dict``, the JAX tree's
    leaves; the non-persistent index buffers are listed apart), the
    image embedding.

Then, per cached executable, the bytes of its graphs' private pools: the
``torch.cuda.memory_snapshot()`` segments whose ``segment_pool_id`` is a
graph's ``CUDAGraph.pool()``. Where no segment carries those ids the tool
says so and gives the reserved delta of the phase that captured the key
instead. The pinned canvas pool is host memory and has a row of its own,
never in a device total. The run is in bfloat16 on the GPU (the SAM
decoder float32, as always) and in float32 on the CPU, where every device
meter reads n/a. ``--backend gpu`` (the default) without a CUDA device
raises: nothing falls back to the CPU.

``main(argv, meter=None)`` returns the ``Footprint`` (rows, pools,
totals, and the environment and segmentation, kept alive so a caller can
read the card while it still holds everything); ``meter`` lets a test
script the readings.
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

MB = 1 << 20
AMG_GRID = 32  # generate_masks' default point grid
REFERENCE_ROW = ("the reference's ~500 MB prose row (an RTX 4070 under ONNX "
                 "Runtime, its README.md:35): no yardstick")


@dataclass(frozen=True)
class Reading:
    """One reading of the device: bytes allocated, reserved and used by the
    CUDA driver (None where there is no meter)."""
    allocated: Optional[int]
    reserved: Optional[int]
    driver: Optional[int]


class CudaMeter:
    """The card's meters: the caching allocator's allocated and reserved
    bytes and its peak, the CUDA driver's used bytes, and a graph's pool."""

    def __init__(self, device: torch.device):
        self.device = device

    def read(self) -> Reading:
        torch.cuda.synchronize(self.device)
        free, total = torch.cuda.mem_get_info(self.device)
        return Reading(torch.cuda.memory_allocated(self.device),
                       torch.cuda.memory_reserved(self.device), total - free)

    def reset_peak(self) -> None:
        torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> Optional[int]:
        return torch.cuda.max_memory_allocated(self.device)

    def pool_bytes(self, graphs: Sequence) -> Optional[int]:
        """Bytes of the allocator's segments in these graphs' private pools;
        None when no segment carries one of their pool ids."""
        ids = {tuple(g.pool()) for g in graphs}
        sizes = [s["total_size"] for s in torch.cuda.memory_snapshot()
                 if tuple(s.get("segment_pool_id", ())) in ids]
        return sum(sizes) if sizes else None


class HostMeter:
    """The CPU has no device meter: every reading is n/a."""

    def read(self) -> Reading:
        return Reading(None, None, None)

    def reset_peak(self) -> None:
        pass

    def peak(self) -> Optional[int]:
        return None

    def pool_bytes(self, graphs: Sequence) -> Optional[int]:
        return None


@dataclass
class Row:
    """One phase: the deltas of its readings, its peak above its start,
    its analytic bytes, and the executables it built."""
    name: str
    allocated: Optional[int]
    reserved: Optional[int]
    driver: Optional[int]
    peak: Optional[int]
    analytic: Optional[int]
    keys: Tuple = ()
    note: str = ""


@dataclass
class Footprint:
    device: str
    baseline: Reading
    rows: List[Row]
    # Per executable key: (its graphs, their pools' bytes or None).
    pools: Dict[Tuple, Tuple[int, Optional[int]]]
    final: Reading
    peak: Optional[int]  # max_memory_allocated over the phases
    host_pinned: Optional[int]
    # What the pipeline holds (the environment, the image's segmentation),
    # kept alive with the footprint.
    env: Any = field(repr=False, default=None)
    seg: Any = field(repr=False, default=None)

    def row(self, name: str) -> Row:
        return next(r for r in self.rows if r.name == name)

    @property
    def pools_matched(self) -> bool:
        """Every captured executable's pool found in the snapshot."""
        return all(b is not None for n, b in self.pools.values() if n)


def _delta(a: Optional[int], b: Optional[int]) -> Optional[int]:
    return None if a is None or b is None else b - a


def _mb(n: Optional[int]) -> str:
    return f"{n / MB:12.3f} MB" if n is not None else f"{'n/a':>15s}"


def state_bytes(model: torch.nn.Module) -> int:
    """Bytes of a model's parameters and persistent buffers."""
    return sum(t.nbytes for t in model.state_dict().values())


def index_buffer_bytes(model: torch.nn.Module) -> int:
    """Bytes of its non-persistent buffers (the index tables a forward
    reads, made from the config, not weights)."""
    persistent = set(model.state_dict())
    return sum(b.nbytes for name, b in model.named_buffers()
               if name not in persistent)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m dlimgedit_tpu_torch.tools.memory_footprint",
        description="Device memory of the serving pipeline, per phase.")
    ap.add_argument("--variant", default="mobile_sam")
    ap.add_argument("--size", type=int, default=1024,
                    help="side of the square RGBA test image")
    ap.add_argument("--sam-image-size", type=int, default=0,
                    help="shrink the SAM canvas (CPU smoke runs)")
    ap.add_argument("--birefnet-resolution", type=int, default=0,
                    help="shrink the BiRefNet model (CPU smoke runs)")
    ap.add_argument("--backend", choices=("gpu", "cpu"), default="gpu")
    return ap.parse_args(argv)


def main(argv=None, meter=None) -> Footprint:
    args = parse_args(argv)
    if args.birefnet_resolution:
        os.environ["DLIMG_BIREFNET_RESOLUTION"] = str(args.birefnet_resolution)

    import dlimgedit_tpu_torch as dl

    gpu = args.backend == "gpu"
    if gpu and not dl.is_supported(dl.Backend.gpu):
        raise dl.DlimgError("memory_footprint: --backend gpu needs a CUDA "
                            "device (pass --backend cpu for the CPU run)")
    if meter is None:
        meter = CudaMeter(torch.device("cuda", 0)) if gpu else HostMeter()
    opt_kw = {"sam_image_size": args.sam_image_size} if args.sam_image_size else {}
    options = dl.Options(backend=dl.Backend.gpu if gpu else dl.Backend.cpu,
                         allow_random_weights=True,
                         compute_dtype="bfloat16" if gpu else "float32",
                         **opt_kw)
    rng = np.random.default_rng(0)
    img = dl.Image(dl.Extent(args.size, args.size), dl.Channels.rgba,
                   rng.integers(0, 256, (args.size, args.size, 4),
                                dtype=np.uint8))

    rows: List[Row] = []
    peaks: List[int] = []
    box: Dict[str, Any] = {}
    if gpu:
        # Start from the live segments only: a capture empties the
        # allocator's cache (torch.cuda.graph), which would otherwise show
        # as a phase giving memory back.
        gc.collect()
        torch.cuda.empty_cache()
    baseline = meter.read()

    def keys() -> set:
        env = box.get("env")
        return set(env.executables) if env is not None else set()

    def phase(name: str, fn: Callable[[], Tuple[Optional[int], str]]) -> None:
        before, had = meter.read(), keys()
        meter.reset_peak()
        analytic, note = fn()
        after, peak = meter.read(), meter.peak()
        if peak is not None and before.allocated is not None:
            peaks.append(peak)
            peak -= before.allocated
        rows.append(Row(name, _delta(before.allocated, after.allocated),
                        _delta(before.reserved, after.reserved),
                        _delta(before.driver, after.driver), peak, analytic,
                        tuple(k for k in box["env"].executables
                              if k not in had), note))

    def environment():
        box["env"] = dl.Environment(options)
        return None, ""

    def weights(model):
        n = index_buffer_bytes(model)
        return state_bytes(model), (f"index buffers {n / MB:.3f} MB apart"
                                    if n else "")

    def process():
        box["seg"] = dl.Segmentation.process(img, box["env"])
        return box["seg"].embedding.nbytes, "the embedding"

    def click():
        box["seg"].compute_mask(dl.Point(args.size // 2, args.size // 2))
        return None, ""

    def amg():
        n = len(box["seg"].generate_masks(grid=AMG_GRID))
        return None, f"{n} masks"

    def segment():
        dl.segment_objects(img, box["env"])
        return None, ""

    phase("environment", environment)
    env = box["env"]
    phase(f"{args.variant} weights",
          lambda: weights(env.sam_model(args.variant).model))
    phase("process", process)
    phase("compute_mask (a click)", click)
    phase(f"generate_masks (grid {AMG_GRID})", amg)
    phase("BiRefNet weights", lambda: weights(env.birefnet_model("general").model))
    phase("segment_objects", segment)

    pools = {}
    for key, exe in env.executables.items():
        graphs = exe.graphs
        pools[key] = (len(graphs), meter.pool_bytes(graphs) if graphs else None)
    final = meter.read()
    fp = Footprint(str(env.device), baseline, rows, pools, final,
                   max(peaks) if peaks else None,
                   env.canvas_pool.pinned_bytes() if env.canvas_pool else None,
                   env, box["seg"])
    report(fp)
    return fp


def report(fp: Footprint) -> None:
    print(f"device: {fp.device}; before the environment: allocated "
          f"{_mb(fp.baseline.allocated).strip()}, reserved "
          f"{_mb(fp.baseline.reserved).strip()}, driver used "
          f"{_mb(fp.baseline.driver).strip()}")
    print(f"{'phase':34s} {'allocated d':>15s} {'reserved d':>15s} "
          f"{'driver d':>15s} {'peak d':>15s} {'analytic':>15s}")
    for r in fp.rows:
        print(f"{r.name:34s} {_mb(r.allocated)} {_mb(r.reserved)} "
              f"{_mb(r.driver)} {_mb(r.peak)} {_mb(r.analytic)}"
              + (f"   ({r.note})" if r.note else ""), flush=True)
    print("\nexecutables (graphs: bytes of their private pools):")
    phase_of = {k: r for r in fp.rows for k in r.keys}
    for key, (n, nbytes) in fp.pools.items():
        if n and nbytes is None:
            r = phase_of.get(key)
            shown = (f"pool id in no snapshot segment; reserved d of "
                     f"'{r.name}', which captured it: "
                     f"{_mb(r.reserved).strip()}" if r else "n/a")
        else:
            shown = _mb(nbytes).strip()
        print(f"  {'/'.join(str(k) for k in key):40s} graphs {n}   {shown}")
    print(f"\nresident (memory_allocated after the pipeline): "
          f"{_mb(fp.final.allocated).strip()}")
    print(f"peak (max_memory_allocated over the phases): {_mb(fp.peak).strip()}")
    print(f"reserved (the allocator's, every graph pool included): "
          f"{_mb(fp.final.reserved).strip()}")
    print(f"driver used (mem_get_info: also the CUDA context and cuBLAS's "
          f"workspaces): {_mb(fp.final.driver).strip()}   [{REFERENCE_ROW}]")
    print(f"host: pinned canvas pool {_mb(fp.host_pinned).strip()} (not "
          f"device memory)", flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
