"""Batched execution on one device (counterpart of
dlimgedit_tpu/parallel/batch.py):

  * ``encode_frames``: image embeddings of a batch of frames (video,
    bursts, and the teacher side of distillation);
  * ``segment_frames``: BiRefNet foreground logits of a batch of frames;
  * ``decode_prompt_batch``: many prompts against one embedding.

``encode_frames`` and ``segment_frames`` keep one ``Executable``
(runtime/environment.py) per (program, model, config, frames' shape and
dtype) key in a module-level cache, the counterpart of the JAX package's
``_JIT_CACHE``: on a CUDA device a CUDA graph captured at the key's first
call after an eager warm-up, on the CPU the eager program. A graph reads
the model's weights from the storages they had at its capture, so weights
updated in place (a model being trained) are seen by the next call, and
the cache holds the model alive. The result is a copy that the next call
does not overwrite. A ``mesh`` of 2 or more devices needs the
multi-device tier, which is not ported yet, and raises.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch
from torch import nn

from ..errors import not_in_this_slice
from ..models import sam as sam_lib
from ..runtime.environment import Executable
from ..utils.profiling import Profiler

_GRAPH_CACHE: Dict[Tuple, Executable] = {}
_CACHE_LOCK = threading.Lock()


def _single_device(mesh, entry: str) -> None:
    """``mesh``: None, or the sequence of devices it spans."""
    if mesh is None:
        return
    n = len(mesh)
    if n >= 2:
        raise not_in_this_slice(f"{entry} over a mesh of {n} devices",
                                "multi-device parallel")


def _run_cached(program: str, model: nn.Module, cfg, frames: torch.Tensor,
                fn) -> torch.Tensor:
    """``fn(frames)`` through the executable of its key, made at the key's
    first call."""
    device = next(model.parameters()).device
    key = (program, model, cfg, tuple(frames.shape), frames.dtype)
    with _CACHE_LOCK:
        exe = _GRAPH_CACHE.get(key)
        if exe is None:
            exe = _GRAPH_CACHE[key] = Executable(
                (program, type(model).__name__, tuple(frames.shape),
                 str(frames.dtype)),
                fn, device, lambda out: out.clone(), Profiler())
    return exe(frames)


def encode_frames(model: sam_lib.Sam, cfg: sam_lib.SamConfig,
                  frames: torch.Tensor, mesh=None) -> torch.Tensor:
    """frames: (B, S, S, 3) preprocessed pixels (in the dtype the encoder
    is to run in) -> (B, S/16, S/16, 256) embeddings on the model's
    device. The kernel flags are those of ``cfg``'s encoder config."""
    _single_device(mesh, "encode_frames")
    return _run_cached("encode", model, cfg, frames,
                       lambda x: sam_lib.encode_image(model, cfg, x))


def segment_frames(model: nn.Module, cfg, frames: torch.Tensor,
                   mesh=None) -> torch.Tensor:
    """BiRefNet on a batch of frames: (B, S, S, 3) ImageNet-normalised
    pixels -> (B, S, S, 1) float32 foreground logits on the model's
    device (the batched counterpart of ``segment_objects``' forward)."""
    from ..models.birefnet import birefnet_apply

    _single_device(mesh, "segment_frames")
    return _run_cached("segment", model, cfg, frames,
                       lambda x: birefnet_apply(model, x, cfg))


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
