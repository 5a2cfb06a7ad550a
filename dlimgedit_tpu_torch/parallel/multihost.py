"""Multi-process execution on ``torch.distributed`` (counterpart of
dlimgedit_tpu/parallel/multihost.py).

Several processes, each owning some devices, joined by one process group.
The layout follows the JAX package's: the tp axis stays inside one
process (a tensor-parallel row is one process's devices), and only dp
crosses processes; its one collective is the train step's gradient
all-reduce (train/step.py), and the inference paths have none.

Across processes the port uses ``all_reduce`` and ``broadcast`` only: gloo
takes CUDA tensors for those two alone, and a group of ranks sharing one
card must be gloo (NCCL refuses two ranks on one GPU). An all-gather, where
one is needed, is an ``all_reduce`` of a zeroed buffer in which each rank
fills its own slot (exact: x + 0 == x). The functions work on the default
group, whatever its backend.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..errors import DlimgError
from .mesh import (
    Mesh,
    NamedSharding,
    P,
    Sharded,
    _index,
    _object_array,
    cuda_devices,
    world,
)

__all__ = ["all_reduce_sum", "barrier", "global_mesh", "initialize",
           "local_rows", "process_local_batch", "replicate_params", "world"]


def initialize(coordinator_address: str, num_processes: int,
               process_id: int) -> None:
    """Join the process group (call once, before any collective).
    ``coordinator_address`` is "host:port" of process 0. The backend is
    NCCL when this process has CUDA devices, gloo otherwise."""
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def _collective_device() -> torch.device:
    """Where a new collective buffer lives: the current CUDA device under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every process of the default group, in place
    (through a CUDA buffer when NCCL is given a host tensor); a group of
    one runs it too. ``t`` unchanged without a group."""
    if not (dist.is_available() and dist.is_initialized()):
        return t
    if dist.get_backend() == "nccl" and t.device.type != "cuda":
        buf = t.to(_collective_device())
        dist.all_reduce(buf)
        t.copy_(buf)
    else:
        dist.all_reduce(t)
    return t


def barrier() -> None:
    """Every process waits here for the others (no-op without a group)."""
    if world()[0] > 1:
        all_reduce_sum(torch.zeros(1))


def _per_process(value: int) -> list:
    """``value`` of every process, by rank (an all-gather by all_reduce)."""
    size, rank = world()
    buf = torch.zeros(size, dtype=torch.int64)
    buf[rank] = value
    return all_reduce_sum(buf).tolist()


def global_mesh(dp: Optional[int] = None, tp: Optional[int] = None,
                devices=None) -> Mesh:
    """A (dp, tp) mesh over every process's devices, tp packed within a
    process. ``devices``: this process's (default its CUDA devices; none
    raises). Devices are ordered (process, local index) and reshaped so
    that each tp group is a contiguous run of ONE process's devices, while
    dp strides across processes; ``tp`` must divide the per-process count
    for that, which is asserted, not silently degraded."""
    local_devs = list(cuda_devices() if devices is None else devices)
    if not local_devs:
        raise DlimgError("global_mesh: this process has no CUDA device "
                         "(pass devices= for a mesh of others)")
    size = world()[0]
    counts = dict(enumerate(_per_process(len(local_devs))))
    local = min(counts.values())
    assert min(counts.values()) == max(counts.values()), (
        f"uneven devices per process: {counts}")
    n = local * size
    if tp is None:
        tp = (n // dp) if dp else (2 if local % 2 == 0 and n >= 4 else 1)
    if dp is None:
        dp = n // tp
    assert dp * tp == n, f"dp({dp}) * tp({tp}) != devices({n})"
    assert local % tp == 0, (
        f"tp={tp} would span processes (local device count {local}); "
        f"tensor-parallel rows must stay inside one process")
    devs = [torch.device(local_devs[j]) for _ in range(size)
            for j in range(local)]
    procs = [p for p in range(size) for _ in range(local)]
    return Mesh(_object_array(devs, (dp, tp)), ("dp", "tp"),
                processes=np.asarray(procs).reshape(dp, tp))


def process_local_batch(mesh: Mesh, local_data, global_batch: int
                        ) -> Sharded:
    """The global dp-sharded batch from this process's rows.
    ``local_data`` is the rows this process feeds (global_batch /
    num_processes leading entries, in global order); each of its devices
    gets its block, with no cross-process data movement."""
    local_data = torch.as_tensor(local_data)
    size, rank = world()
    per = global_batch // size
    if local_data.shape[0] != per:
        raise ValueError(f"process_local_batch: {local_data.shape[0]} local "
                         f"rows, expected {global_batch} / {size} = {per}")
    spec = P("dp", *([None] * (local_data.ndim - 1)))
    shape = (global_batch,) + tuple(local_data.shape[1:])
    shards = []
    for where in np.ndindex(mesh.devices.shape):
        if not mesh.is_local(where):
            continue
        index = _index(spec, mesh, where, shape)
        rows = index[0]
        if rows.start < rank * per or rows.stop > (rank + 1) * per:
            raise ValueError(f"mesh row {where[0]} needs rows {rows.start}:"
                             f"{rows.stop}, outside this process's "
                             f"{rank * per}:{(rank + 1) * per}")
        part = local_data[rows.start - rank * per:rows.stop - rank * per]
        shards.append((where, index, part.to(mesh.devices[where])))
    return Sharded(NamedSharding(mesh, spec), shape, shards)


def replicate_params(mesh: Mesh, params):
    """A model (or state dict) made identical in every process, rank 0's
    values broadcast in place (one broadcast per dtype), on this process's
    first mesh device. Returns it."""
    if isinstance(params, nn.Module):
        params.to(mesh.first_device)
        leaves = list(params.state_dict(keep_vars=True).values())
    else:
        params = {k: v.to(mesh.first_device) for k, v in params.items()}
        leaves = list(params.values())
    if world()[0] > 1:
        by_dtype: Dict[torch.dtype, list] = {}
        for t in leaves:
            by_dtype.setdefault(t.dtype, []).append(t)
        with torch.no_grad():
            for group in by_dtype.values():
                flat = torch.cat([t.detach().reshape(-1) for t in group])
                if dist.get_backend() == "nccl":
                    flat = flat.to(_collective_device())
                dist.broadcast(flat, src=0)
                for t, v in zip(group, torch.split(
                        flat, [t.numel() for t in group])):
                    t.copy_(v.view_as(t))
    return params


def local_rows(garr: Sharded) -> np.ndarray:
    """This process's rows of a dp-sharded array, in global order, on the
    host. The array must be sharded on the LEADING axis only (the batch
    convention, P("dp", None, ...)); with tp > 1 each dp block is held once
    per tp device and is taken once. Trailing-axis sharding raises
    (deduplication by leading index would silently keep one arbitrary
    slice of each row block)."""
    seen = {}
    for _, index, t in garr.shards:
        for d, idx in enumerate(index[1:], start=1):
            if (idx.start or 0) != 0 or (
                    idx.stop is not None and idx.stop != garr.shape[d]):
                raise ValueError(
                    f"local_rows needs leading-axis sharding only; axis {d} "
                    f"of a shard covers {idx}, not the full extent "
                    f"{garr.shape[d]}")
        seen.setdefault(index[0].start or 0, t)
    return np.concatenate([seen[k].detach().cpu().numpy()
                           for k in sorted(seen)], axis=0)
