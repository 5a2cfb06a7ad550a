"""Batched execution, on one device or over a (dp, tp) mesh (counterpart of
dlimgedit_tpu/parallel/batch.py):

  * ``encode_frames``: image embeddings of a batch of frames (video,
    bursts, and the teacher side of distillation);
  * ``segment_frames``: BiRefNet foreground logits of a batch of frames;
  * ``decode_prompt_batch``: many prompts against one embedding.

Without a mesh, ``encode_frames`` and ``segment_frames`` run on the
model's device. Each keeps one ``Executable`` (runtime/environment.py)
per (program, model, config, frames' shape and dtype) key in a
module-level cache, the counterpart of the JAX package's ``_JIT_CACHE``:
on a CUDA device a CUDA graph captured at the key's first call after an
eager warm-up, on the CPU the eager program. A graph reads the model's
weights from the storages they had at its capture, so weights updated in
place (a model being trained) are seen by the next call, and the cache
holds the model alive. The result is a copy that the next call does not
overwrite.

With a ``mesh`` (parallel/mesh.py) the batch is split into ``dp`` equal
parts, B % dp == 0 as in JAX, and each mesh row runs its part on its
replica of the model (``mesh.replica``): a row whose tp is 1 through the
executable of its (device, key), a tensor-parallel row (``encode_frames``
with tp > 1; ``segment_frames`` keeps the parameters replicated, as JAX)
eagerly, as its program crosses devices. The JAX package returns one
dp-sharded global array; the port has no global-array type, so the result
is the whole batch, in order, on the mesh's first device. Frames given
as a ``Sharded`` (``multihost.process_local_batch``) come back as a
``Sharded`` of this process's rows.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..errors import DlimgError
from ..models import sam as sam_lib
from ..models.common import full_precision
from ..runtime.environment import Executable
from ..utils.profiling import Profiler
from .mesh import Mesh, Sharded, replica

_GRAPH_CACHE: Dict[Tuple, Executable] = {}
_CACHE_LOCK = threading.Lock()

Frames = Union[torch.Tensor, Sharded]


def _run_cached(program: str, model: nn.Module, cfg, frames: torch.Tensor,
                fn) -> torch.Tensor:
    """``fn(model, frames)`` through the executable of its key, made at
    the key's first call."""
    device = next(model.parameters()).device
    key = (program, model, cfg, tuple(frames.shape), frames.dtype)
    with _CACHE_LOCK:
        exe = _GRAPH_CACHE.get(key)
        if exe is None:
            exe = _GRAPH_CACHE[key] = Executable(
                (program, type(model).__name__, tuple(frames.shape),
                 str(frames.dtype), str(device)),
                lambda x: fn(model, x), device, lambda out: out.clone(),
                Profiler())
    return exe(frames)


def _eager(model: nn.Module, frames: torch.Tensor, fn) -> torch.Tensor:
    with torch.inference_mode(), full_precision():
        return fn(model, frames)


def _over_mesh(program: str, model: nn.Module, cfg, frames: Frames,
               mesh: Mesh, fn, tp: bool) -> Frames:
    """Each local mesh row's part of ``frames`` through its replica."""
    if isinstance(frames, Sharded):
        mesh = frames.mesh
        parts = frames.row_parts()
    else:
        dp = mesh.devices.shape[0]
        B = frames.shape[0]
        if B % dp:
            raise DlimgError(f"{program}: the batch ({B}) must divide over "
                             f"the mesh's dp ({dp})")
        n = B // dp
        parts = [(r, frames[r * n:(r + 1) * n]) for r, _ in mesh.rows()]
    rows = dict(mesh.rows())
    outs = []
    for r, part in parts:
        devices = rows[r] if tp else rows[r][:1]
        rep = replica(model, devices, tp=len(devices) > 1)
        x = part.to(devices[0])
        if len(devices) > 1:
            outs.append((r, _eager(rep, x, fn)))
        else:
            outs.append((r, _run_cached(program, rep, cfg, x, fn)))
    if isinstance(frames, Sharded):
        return _like(frames, dict(outs))
    d0 = mesh.first_device
    return torch.cat([o.to(d0) for _, o in outs], dim=0)


def _like(frames: Sharded, outs: Dict[int, torch.Tensor]) -> Sharded:
    """A Sharded of the per-row results, laid out as ``frames``."""
    n = next(iter(outs.values())).shape[0]
    shards = []
    for where, index, _ in frames.shards:
        out = outs[where[0]]
        rows = slice(where[0] * n, (where[0] + 1) * n)
        full = tuple(slice(0, s) for s in out.shape[1:])
        shards.append((where, (rows,) + full,
                       out.to(frames.mesh.devices[where])))
    shape = (frames.shape[0],) + tuple(out.shape[1:])
    return Sharded(frames.sharding, shape, shards)


def _encode(model, cfg):
    return lambda m, x: sam_lib.encode_image(m, cfg, x)


def encode_frames(model: sam_lib.Sam, cfg: sam_lib.SamConfig,
                  frames: Frames, mesh: Optional[Mesh] = None) -> Frames:
    """frames: (B, S, S, 3) preprocessed pixels (in the dtype the encoder
    is to run in) -> (B, S/16, S/16, 256) embeddings: on the model's
    device without a mesh, else over the (dp, tp) mesh (see the module
    docstring). The kernel flags are those of ``cfg``'s encoder config."""
    fn = _encode(model, cfg)
    if mesh is None:
        return _run_cached("encode", model, cfg, frames, fn)
    return _over_mesh("encode", model, cfg, frames, mesh, fn,
                      tp=mesh.shape.get("tp", 1) > 1)


def segment_frames(model: nn.Module, cfg, frames: Frames,
                   mesh: Optional[Mesh] = None) -> Frames:
    """BiRefNet on a batch of frames: (B, S, S, 3) ImageNet-normalised
    pixels -> (B, S, S, 1) float32 foreground logits, on the model's
    device without a mesh, else over the mesh's dp rows with the
    parameters replicated (the batched counterpart of
    ``segment_objects``' forward)."""
    from ..models.birefnet import birefnet_apply

    def fn(m, x):
        return birefnet_apply(m, x, cfg)

    if mesh is None:
        return _run_cached("segment", model, cfg, frames, fn)
    return _over_mesh("segment", model, cfg, frames, mesh, fn, tp=False)


def decode_prompt_batch(model: sam_lib.Sam, cfg: sam_lib.SamConfig,
                        embedding: torch.Tensor, point_coords: torch.Tensor,
                        point_labels: torch.Tensor, multimask: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode N prompts against ONE embedding in one batched pass.

    embedding: (1, He, We, C); point_coords: (N, P, 2); point_labels:
    (N, P). Returns (masks (N, T, 4He, 4We), iou (N, T)), T = 4 with
    ``multimask``, else 1 (the single-mask selection). The embedding is
    broadcast (``expand``), not copied N times."""
    n = point_coords.shape[0]
    return sam_lib.decode_masks(model, cfg,
                                embedding.expand(n, *embedding.shape[1:]),
                                point_coords, point_labels, multimask=multimask)
