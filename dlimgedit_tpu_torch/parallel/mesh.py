"""Device mesh, sharding rules and tensor-parallel execution (counterpart
of dlimgedit_tpu/parallel/mesh.py).

Axes, as in the JAX package:
  dp — data parallel over images / frames;
  tp — tensor parallel over the attention heads and MLP hidden dims
       (Megatron's column / row split of the big linears);
  sp — sequence parallel over the ViT's token windows (parallel/sp.py).

JAX states a sharding and XLA derives the program. PyTorch has neither, so
the port spells each schedule out:

  * ``Mesh`` is an ``np.ndarray`` of ``torch.device``s with named axes;
    ``mesh.shape`` is a dict, as JAX's ``Mesh.shape``. A device may repeat
    (``[cpu] * 8`` in the CPU tests, ``[cuda:0] * 4`` on one card): the
    schedules then run their shards one after another on that device, and
    ``t.to(device)`` returns ``t`` itself, so no shard is written in place.
  * ``NamedSharding(mesh, P(...))`` and ``put`` (JAX's ``device_put``) lay
    a tensor over a mesh as a ``Sharded``: this process's shards, each with
    its index into the global array. The port has no global-array type
    beyond that: the single-process entry points return whole tensors on
    the mesh's first device.
  * ``sam_param_sharding`` is JAX's rule leaf by leaf, over the port's
    state-dict paths (linear weights are (in, out) in both packages, so
    the specs name the same dimension). ``shard_params`` carries it out:
    every ``Linear`` the rule shards becomes a ``TPLinear`` over one mesh
    row. Column-parallel (qkv, fc1, lin1, q, k, v): each tp device holds
    its columns, and the output columns are joined on the row's first
    device. Row-parallel (proj, fc2, lin2, out): each device multiplies its
    slice of the input by its rows, the partial products are summed in
    float32 in device order on the first device, and the bias is added
    once. Autograd runs through the cross-device copies.
  * ``replica(model, devices, tp)`` is the model as one mesh row runs it:
    the model itself on its own device, else a copy on the row's first
    device (tensor-parallel over the row with ``tp``), made once per
    (model, row) and cached. A replica whose tensors sit on the model's
    device shares them; the others are copied again from the model when
    one of its leaves was written in place since (its version counter),
    so weights trained in place are seen by the next call.
"""

from __future__ import annotations

import copy
import itertools
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..models.common import Linear

__all__ = ["Mesh", "NamedSharding", "P", "Sharded", "TPLinear",
           "batch_sharding", "clear_replicas", "cuda_devices", "make_mesh",
           "put", "replica", "replicated", "sam_param_sharding",
           "shard_params", "world"]


def world() -> Tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) without
    one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def cuda_devices() -> List[torch.device]:
    """The CUDA devices this process sees (none without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _object_array(items: Sequence, shape) -> np.ndarray:
    arr = np.empty(len(items), dtype=object)
    arr[:] = list(items)
    return arr.reshape(shape)


class Mesh:
    """Devices with named axes. ``processes`` (same shape, or None: all
    this process's) names the process that owns each device; a device of
    another process is its local device there."""

    def __init__(self, devices: Union[np.ndarray, Sequence], axis_names,
                 processes: Optional[np.ndarray] = None):
        arr = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in arr.reshape(-1)]
        self.devices = _object_array(flat, arr.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        self.processes = (None if processes is None
                          else np.asarray(processes).reshape(arr.shape))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def is_local(self, index: Tuple[int, ...]) -> bool:
        return self.processes is None or int(self.processes[index]) == world()[1]

    def rows(self) -> List[Tuple[int, Tuple[torch.device, ...]]]:
        """(row index, its devices) along the first axis, for the rows
        this process owns (a row of a 1-D mesh is one device)."""
        out = []
        for r in range(self.devices.shape[0]):
            first = (r,) + (0,) * (self.devices.ndim - 1)
            if self.is_local(first):
                row = self.devices[r]
                out.append((r, tuple(row.reshape(-1)) if self.devices.ndim > 1
                            else (row,)))
        return out

    @property
    def first_device(self) -> torch.device:
        """The first device of this process in the mesh."""
        return self.rows()[0][1][0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.reshape(-1).tolist()})"


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None, devices=None) -> Mesh:
    """A (dp, tp) mesh over ``devices`` (default: every CUDA device; too
    few raises, there is no CPU fallback). An explicit list may repeat a
    device."""
    devices = list(cuda_devices() if devices is None else devices)
    n = n_devices or len(devices)
    if n == 0 or len(devices) < n:
        raise ValueError(f"make_mesh({n}): only {len(devices)} devices "
                         f"visible (pass devices= for a mesh of others)")
    if dp is None and tp is None:
        # dp first (encode throughput scales linearly); tp a factor of 2
        # when there is one, for the big encoders.
        tp = 2 if n % 2 == 0 and n >= 4 else 1
        dp = n // tp
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    assert dp * tp == n, f"dp({dp}) * tp({tp}) != devices({n})"
    return Mesh(_object_array(devices[:n], (dp, tp)), ("dp", "tp"))


# ---------------------------------------------------------------------------
# Shardings
# ---------------------------------------------------------------------------

class P(tuple):
    """A partition spec: per array dimension the mesh axis it is split
    over, or None (JAX's ``PartitionSpec``)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclass(frozen=True, eq=False)
class NamedSharding:
    mesh: Mesh
    spec: P


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the leading (batch / frame) axis over dp; replicate the rest."""
    return NamedSharding(mesh, P("dp", *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _index(spec: P, mesh: Mesh, where: Tuple[int, ...], shape
           ) -> Tuple[slice, ...]:
    """The block of a ``shape`` array that the device at ``where`` holds."""
    out = []
    for d, n in enumerate(shape):
        axis = spec[d] if d < len(spec) else None
        if axis is None:
            out.append(slice(0, n))
            continue
        parts = mesh.shape[axis]
        if n % parts:
            raise ValueError(f"dimension {d} of size {n} does not split "
                             f"evenly over mesh axis {axis!r} ({parts})")
        c = where[mesh.axis_names.index(axis)]
        out.append(slice(c * (n // parts), (c + 1) * (n // parts)))
    return tuple(out)


@dataclass(eq=False)
class Sharded:
    """A global array of ``shape`` laid over ``sharding``: the shards of
    this process, one per local device in mesh order, each as (device's
    mesh index, its index into the global array, tensor on the device)."""
    sharding: NamedSharding
    shape: Tuple[int, ...]
    shards: List[Tuple[Tuple[int, ...], Tuple[slice, ...], torch.Tensor]]

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    def row_parts(self) -> List[Tuple[int, object]]:
        """(row, its part) for this process's mesh rows: the shard on each
        row's first device or, for an entry whose dim 1 is split over the
        row's own axis (canvas rows over a ('dp', 'sp') mesh), the row's
        shards as a ``parallel/spatial.py::Bands``."""
        tail = (0,) * (self.mesh.devices.ndim - 1)
        spec = self.sharding.spec
        if self.mesh.devices.ndim == 1 or len(spec) < 2 or spec[1] is None:
            return [(where[0], t) for where, _, t in self.shards
                    if where[1:] == tail]
        from .spatial import Bands

        out = {}
        for where, index, t in self.shards:
            out.setdefault(where[0], []).append((index[1], where, t))
        parts = []
        for r, shards in out.items():
            shards.sort(key=lambda s: s[0].start)
            starts = tuple(s[0].start for s in shards) + (shards[-1][0].stop,)
            parts.append((r, Bands([t for _, _, t in shards], starts,
                                   tuple(self.mesh.devices[w]
                                         for _, w, _ in shards))))
        return parts


def put(x, sharding: NamedSharding) -> Sharded:
    """``x`` (the whole array, the same in every process) laid over the
    mesh: each local device gets its block (JAX's ``device_put``)."""
    x = torch.as_tensor(x)
    mesh = sharding.mesh
    shards = []
    for where in np.ndindex(mesh.devices.shape):
        if mesh.is_local(where):
            index = _index(sharding.spec, mesh, where, x.shape)
            shards.append((where, index, x[index].to(mesh.devices[where])))
    return Sharded(sharding, tuple(x.shape), shards)


# ---------------------------------------------------------------------------
# The tensor-parallel rule
# ---------------------------------------------------------------------------

def _spec_for_path(path: str, leaf) -> P:
    """The Megatron rule for a SAM leaf at ``path`` ("/"-joined):
    column-parallel (the output dim) for the qkv / MLP-in projections,
    row-parallel (the input dim) for attention-out / MLP-out; everything
    else (norms, biases, tables, convs) replicated."""
    if leaf.ndim != 2:
        return P()
    if any(k in path for k in ("qkv/w", "fc1/w", "lin1/w", "/q/w", "/k/w",
                               "/v/w")):
        return P(None, "tp")
    if any(k in path for k in ("proj/w", "fc2/w", "lin2/w", "/out/w")):
        return P("tp", None)
    return P()


def _leaves(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.state_dict(keep_vars=True))
    return dict(params)


def _tp_spec(path: str, leaf, tp: int) -> P:
    """The rule's spec, replicated where tp does not divide the dim."""
    spec = _spec_for_path(path.replace(".", "/"), leaf)
    for dim, axis in enumerate(spec):
        if axis == "tp" and leaf.shape[dim] % tp != 0:
            return P()
    return spec


def sam_param_sharding(params, mesh: Mesh) -> Dict[str, NamedSharding]:
    """NamedSharding per leaf (dotted state-dict path) of a SAM model or
    state dict under ``mesh``: tp weights sharded only when the dimension
    divides evenly, otherwise replicated."""
    tp = mesh.shape["tp"]
    return {k: NamedSharding(mesh, _tp_spec(k, v, tp))
            for k, v in _leaves(params).items()}


class TPLinear(nn.Module):
    """A ``Linear`` split over one mesh row's devices: ``w_shards[i]`` on
    ``devices[i]`` (a column block with ``dim`` 1, a row block with ``dim``
    0), the bias (if any) on the first device."""

    def __init__(self, lin: nn.Module, devices: Sequence[torch.device],
                 dim: int):
        super().__init__()
        self.devices = tuple(devices)
        self.dim = dim
        parts = torch.tensor_split(lin.w.detach(), len(self.devices), dim=dim)
        self.w_shards = nn.ParameterList(
            nn.Parameter(p.to(d), requires_grad=False)
            for p, d in zip(parts, self.devices))
        if hasattr(lin, "b"):
            self.b = nn.Parameter(lin.b.detach().to(self.devices[0]),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d0 = self.devices[0]
        if self.dim == 1:
            y = torch.cat([(x.to(d) @ w.to(x.dtype)).to(d0)
                           for d, w in zip(self.devices, self.w_shards)],
                          dim=-1)
        else:
            xs = torch.split(x, [w.shape[0] for w in self.w_shards], dim=-1)
            acc = None
            for d, xi, w in zip(self.devices, xs, self.w_shards):
                part = (xi.to(d) @ w.to(x.dtype)).to(d0).float()
                acc = part if acc is None else acc + part
            y = acc.to(x.dtype)
        if hasattr(self, "b"):
            y = y + self.b.to(x.dtype)
        return y


def shard_params(model: nn.Module, devices: Sequence[torch.device]
                 ) -> Dict[str, int]:
    """Swap, in place, every ``Linear`` of ``model`` that the rule shards
    for a ``TPLinear`` over ``devices`` (one mesh row). Returns the split
    dim per swapped module path."""
    tp = len(devices)
    dims = {}
    if tp == 1:
        return dims
    for path, mod in list(model.named_modules()):
        if type(mod) is not Linear:
            continue
        spec = _tp_spec(f"{path}.w", mod.w, tp)
        if "tp" in spec:
            dims[path] = spec.index("tp")
            model.set_submodule(path, TPLinear(mod, devices, dims[path]))
    return dims


# ---------------------------------------------------------------------------
# Per-row replicas
# ---------------------------------------------------------------------------

class _Replica:
    """One model as one mesh row runs it, with what keeps it in step."""

    def __init__(self, model: nn.Module, devices: Tuple[torch.device, ...],
                 tp: bool):
        self.master = model
        self.device = devices[0]
        home = next(itertools.chain(model.parameters(),
                                    model.buffers())).device
        if home == self.device and not (tp and len(devices) > 1):
            self.module, self.dims = model, {}
        else:
            memo = {}
            for t in itertools.chain(model.parameters(), model.buffers()):
                moved = t.detach().to(self.device)
                memo[id(t)] = (nn.Parameter(moved, requires_grad=False)
                               if isinstance(t, nn.Parameter) else moved)
            self.module = copy.deepcopy(model, memo)
            self.dims = (shard_params(self.module, devices) if tp else {})
        self._master_leaves = list(_leaves(model).values())
        self._pairs = self._copy_pairs()
        self._seen = self._versions()

    def _copy_pairs(self):
        """(source view of a master leaf, replica tensor) for every
        replica tensor that does not already share the master's memory."""
        if self.module is self.master:
            return []
        mine = _leaves(self.module)
        pairs = []
        for k, src in _leaves(self.master).items():
            path = k.rpartition(".")[0]
            if path in self.dims and k.endswith(".w"):
                n = len(self.module.get_submodule(path).w_shards)
                srcs = torch.tensor_split(src.detach(), n, dim=self.dims[path])
                dsts = [mine[f"{path}.w_shards.{i}"] for i in range(n)]
            else:
                srcs, dsts = [src.detach()], [mine[k]]
            for s, d in zip(srcs, dsts):
                if not (s.device == d.device and s.data_ptr() == d.data_ptr()):
                    pairs.append((s, d))
        return pairs

    def _versions(self):
        return tuple(t._version for t in self._master_leaves)

    def sync(self) -> None:
        """Copy the master's leaves in again if any was written since."""
        if not self._pairs:
            return
        seen = self._versions()
        if seen != self._seen:
            with torch.no_grad():
                for s, d in self._pairs:
                    d.copy_(s)
            self._seen = seen

    def gather(self, grads: Dict[str, torch.Tensor], device: torch.device
               ) -> Dict[str, torch.Tensor]:
        """The replica's gradients (by its leaf names) as the master's,
        on ``device``: a sharded weight's gradient joined from its
        shards' in device order."""
        out = {}
        for k in _leaves(self.master):
            path = k.rpartition(".")[0]
            if path in self.dims and k.endswith(".w"):
                n = len(self.module.get_submodule(path).w_shards)
                out[k] = torch.cat([grads[f"{path}.w_shards.{i}"].to(device)
                                    for i in range(n)], dim=self.dims[path])
            else:
                out[k] = grads[k].to(device)
        return out


_REPLICAS: Dict[Tuple, _Replica] = {}
_REPLICA_LOCK = threading.Lock()


def replica_entry(model: nn.Module, devices: Sequence[torch.device],
                  tp: bool = False) -> _Replica:
    """The cached replica of ``model`` for a mesh row (made at the row's
    first call), brought in step with the model."""
    key = (model, tuple(devices) if tp else (devices[0],), tp)
    with _REPLICA_LOCK:
        entry = _REPLICAS.get(key)
        if entry is None:
            entry = _REPLICAS[key] = _Replica(model, tuple(key[1]), tp)
        entry.sync()
    return entry


def replica(model: nn.Module, devices: Sequence[torch.device],
            tp: bool = False) -> nn.Module:
    """``model`` as the mesh row ``devices`` runs it (see the module
    docstring); with ``tp``, tensor-parallel over the row."""
    return replica_entry(model, devices, tp).module


def clear_replicas() -> None:
    """Drop every cached replica (they hold their models alive)."""
    with _REPLICA_LOCK:
        _REPLICAS.clear()
