"""Probe: how fast a kernel gathers rows of a table held in shared memory
(K8, ``csrc/gather_probe.cu``), against torch's gathers from device memory.

    python3 -m dlimgedit_tpu_torch.tools.probe_smem_gather [--reps 8 16]

The port's counterpart of tools/probe_vmem_gather.py (whose Pallas kernel,
``run_gather``, gathers from a VMEM-resident table on a TPU). BiRefNet's
deformable convolution samples one table row per (pixel, tap); whether an
on-chip gather can feed such a kernel is the question. The probe's shapes
are the TPU tool's: a (4096, 128) bf16 table and (4096, 128) int32
indices, either one random row per table row replicated across the lanes
(the deformable pattern) or independent per lane, and

    out[r, l] = sum_{i < reps} float(table[(idx[r, l] + i) mod 4096, l]).

``smem_gather`` launches K8 on a CUDA tensor (each output lane reads only
its own column, so a block stages a 32-byte-wide slab of columns of every
row in shared memory and gathers there) and computes ``smem_gather_plain``
on a CPU tensor. ``main`` checks K8 against the plain version, times it
(CUDA events), and then times the TPU tool's second half through torch
indexing from device memory: the same 65536 logical rows x 8 iterations in
several row layouts of a 65536-row table (a library yardstick, printed
only). Needs CUDA.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from typing import Sequence

import torch

from ..errors import DlimgError
from ..ops.cuda_build import (DTYPE_CODES, KERNEL_DTYPES, LIBRARY, check_launch,
                               kernel_operand)

ROWS, LANES = 4096, 128
# Row chunks per slab: 16 chunks x 8 bf16 slabs = 128 blocks for the
# H100's 132 SMs (one 128 KB slab fills a block's shared memory).
ROW_CHUNKS = 16
MAX_ROWS = 7264  # 32-byte slab rows in a block's 227 KB of shared memory


def smem_gather_plain(table: torch.Tensor, idx: torch.Tensor,
                      reps: int) -> torch.Tensor:
    """out[r, l] = sum over i < reps of float(table[(idx[r, l] + i) mod n,
    l]), summed in order from zero in float32."""
    n = table.shape[0]
    out = torch.zeros(table.shape, dtype=torch.float32, device=table.device)
    for i in range(reps):
        rows = torch.remainder(idx.long() + i, n)
        out = out + torch.gather(table, 0, rows).float()
    return out


def smem_gather(table: torch.Tensor, idx: torch.Tensor,
                reps: int) -> torch.Tensor:
    """K8 on a CUDA tensor (one launch counted in ``smem_gather.launches``),
    ``smem_gather_plain`` on a CPU tensor. table: (rows, lanes) float32,
    bfloat16 or float16; idx: (rows, lanes) int32. Returns (rows, lanes) float32."""
    name = "smem_gather"
    if table.dim() != 2 or tuple(idx.shape) != tuple(table.shape):
        raise DlimgError(f"{name}: table and idx must be (rows, lanes) of one "
                         f"shape, got {tuple(table.shape)}, {tuple(idx.shape)}")
    if idx.dtype != torch.int32 or idx.device != table.device or reps < 0:
        raise DlimgError(f"{name}: idx must be int32 on the table's device "
                         f"and reps >= 0")
    if table.device.type == "cpu":
        return smem_gather_plain(table, idx, reps)
    if not table.is_cuda:
        raise DlimgError(f"{name}: unsupported device {table.device}")
    rows, lanes = table.shape
    if str(table.dtype) not in DTYPE_CODES or rows > MAX_ROWS:
        raise DlimgError(f"{name}: the CUDA kernel takes a {KERNEL_DTYPES} "
                         f"table of at most {MAX_ROWS} rows")
    table, idx = kernel_operand(table), kernel_operand(idx)
    out = torch.empty((rows, lanes), dtype=torch.float32, device=table.device)
    rc = LIBRARY.get().dlimg_gather_probe(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, lanes, reps,
        min(ROW_CHUNKS, rows), DTYPE_CODES[str(table.dtype)],
        torch.cuda.current_stream(table.device).cuda_stream)
    check_launch(name, rc)
    smem_gather.launches += 1
    return out


smem_gather.launches = 0


def probe_inputs(device, dtype=torch.bfloat16):
    """The probe's table and its two index layouts, from seed 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    table = (0.5 * torch.randn((ROWS, LANES), generator=gen, device=device)
             ).to(dtype)
    ridx = torch.randint(0, ROWS, (ROWS, 1), generator=gen, device=device,
                         dtype=torch.int32)
    layouts = {
        "row-replicated": ridx.expand(ROWS, LANES).contiguous(),
        "per-lane": torch.randint(0, ROWS, (ROWS, LANES), generator=gen,
                                  device=device, dtype=torch.int32),
    }
    return table, layouts


def _event_ms(fn, iters: int = 20) -> float:
    """Device time of one call: CUDA events around `iters` calls, after a
    warm-up, divided by `iters`."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _hbm_gathers(device) -> None:
    """The TPU tool's second half through torch indexing from device memory:
    65536 rows x 8 iterations of a shifted random row index, per layout."""
    big = 65536
    gen = torch.Generator(device=device).manual_seed(3)
    base = (0.5 * torch.randn((big, 256), generator=gen, device=device)
            ).to(torch.bfloat16)
    gidx = torch.randint(0, big, (big,), generator=gen, device=device)
    cases = (
        ("(N,256) bf16 rows", base, 512),
        ("(N,128) bf16 half-rows", base[:, :128].contiguous(), 256),
        ("(N,2,128) bf16 slabs", base.reshape(big, 2, 128), 512),
        ("(N,4,64) bf16 slabs", base.reshape(big, 4, 64), 512),
        ("(N,16,128) bf16 full tile",
         torch.cat([base] * 8, dim=-1).reshape(big, 16, 128), 4096),
        ("(N,256->2,128) int8 slabs",
         torch.clamp(torch.round(base.float() * 50), -127, 127).to(
             torch.int8).reshape(big, 2, 128), 256),
    )
    for label, tbl, useful in cases:
        def run(tbl=tbl):
            acc = torch.zeros((), dtype=torch.float32, device=device)
            for k in range(8):
                acc = acc + tbl[torch.remainder(gidx + k, big)].float().sum()
            return acc

        ms = _event_ms(run, iters=4)
        fetched = big * 8
        print(f"torch gather {label:28s}: {ms:8.3f} ms/call -> "
              f"{ms * 1e6 / fetched:6.2f} ns/row, "
              f"{fetched * useful / (ms * 1e-3) / 1e9:7.1f} GB/s useful",
              flush=True)


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, nargs="+", default=[8, 16],
                    help="gathers per output value (the TPU tool's 8 and 16)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise DlimgError("probe_smem_gather: needs a CUDA device")
    dev = torch.device("cuda", 0)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} ({gpu})", flush=True)
    table, layouts = probe_inputs(dev)
    for label, idx in layouts.items():
        for reps in args.reps:
            got = smem_gather(table, idx, reps)
            want = smem_gather_plain(table, idx, reps)
            if not torch.equal(got, want):
                err = (got - want).abs().max().item()
                raise DlimgError(f"probe_smem_gather: K8 differs from the "
                                 f"plain version ({label}, reps {reps}): "
                                 f"max|diff| {err}")
            ms = _event_ms(lambda: smem_gather(table, idx, reps))
            vals = ROWS * LANES * reps
            print(f"{label:15s} reps={reps:3d}: {ms:8.4f} ms/call -> "
                  f"{vals / (ms * 1e-3) / 1e9:8.2f} Gvalues/s "
                  f"({vals * 2 / (ms * 1e-3) / 1e9:7.1f} GB/s bf16-equiv); "
                  f"equal to the plain version", flush=True)
    _hbm_gathers(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
