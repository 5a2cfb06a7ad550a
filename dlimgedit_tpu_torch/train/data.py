"""Training data: host-to-device prefetch and synthetic SAM batches
(counterpart of dlimgedit_tpu/train/data.py).

``prefetch_to_device`` keeps ``depth`` batches in flight: each leaf is
copied into pinned host memory and then to the device with
``non_blocking=True`` on a copy stream of its own, so the copy of batch
N + depth overlaps the compute of batch N. A batch is yielded after the
consumer's stream waits on its copy's event, and each device tensor is
marked as used by that stream (``record_stream``), so the caching
allocator does not hand its memory to the copy stream again while the
consumer may still read it. With a ``mesh`` each leaf is dp-sharded on
the way in (``parallel/mesh.py::put``): each mesh row of this process
gets its leading-axis part, so the same loader drives one card, a mesh
and several processes (each feeds its rows).
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ..errors import DlimgError
from ..parallel.mesh import batch_sharding, put

__all__ = ["prefetch_to_device", "sam_batch_iterator"]


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise DlimgError("prefetch_to_device: no CUDA device (pass "
                             "device='cpu' to keep the batches on the CPU)")
        return torch.device("cuda", 0)
    return torch.device(device)


def _default_placement(mesh) -> Callable[[Any], Any]:
    """Per-leaf placement under a mesh: the leading axis dp-sharded."""
    return lambda leaf: put(leaf, batch_sharding(mesh, np.ndim(leaf)))


def prefetch_to_device(batches: Iterable[Any], depth: int = 2,
                       device=None, mesh=None) -> Iterator[Any]:
    """Yield the batches (pytrees of dicts, lists and tuples of host
    arrays or tensors) as device tensors, keeping ``depth`` copies in
    flight beyond the one yielded. ``device`` None means ``cuda:0`` and
    raises without a CUDA device; ``"cpu"`` keeps them on the CPU. With
    ``mesh`` every leaf becomes a ``Sharded`` over it (``device`` unused)."""
    if depth < 1:
        raise DlimgError(f"prefetch_to_device: depth must be >= 1, got {depth}")
    dev = None if mesh is not None else _device(device)
    if mesh is not None:
        placement = _default_placement(mesh)

        def place(batch):
            return _tree_map(placement, batch), None
    elif dev.type != "cuda":
        def place(batch):
            return _tree_map(lambda a: torch.as_tensor(a).to(dev), batch), None
    else:
        copy_stream = torch.cuda.Stream(dev)

        def copy_in(a):
            host = torch.as_tensor(np.ascontiguousarray(a)
                                   if isinstance(a, np.ndarray) else a)
            if host.device.type == "cpu" and not host.is_pinned():
                host = host.pin_memory()
            return host.to(dev, non_blocking=True)

        def place(batch):
            copy_stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(copy_stream):
                out = _tree_map(copy_in, batch)
                done = torch.cuda.Event()
                done.record(copy_stream)
            return out, done

    def hand_over(entry):
        out, done = entry
        if done is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(done)
            for t in _leaves(out):
                t.record_stream(consumer)
        return out

    queue: collections.deque = collections.deque()
    it = iter(batches)
    for batch in it:
        queue.append(place(batch))
        if len(queue) == depth:
            break
    while queue:
        entry = queue.popleft()
        nxt = next(it, None)
        if nxt is not None:
            queue.append(place(nxt))
        yield hand_over(entry)


def sam_batch_iterator(rng: np.random.Generator, *, batch_size: int,
                       image_size: int, mask_size: int,
                       steps: Optional[int] = None) -> Iterator[dict]:
    """Synthetic SAM train batches (images, point prompts, target masks) in
    the schema of train/step.py, drawn as the JAX package draws them: one
    seed gives the same batches."""
    n = 0
    while steps is None or n < steps:
        yield {
            "images": rng.standard_normal(
                (batch_size, image_size, image_size, 3)).astype(np.float32),
            "point_coords": rng.uniform(
                0, image_size, (batch_size, 2, 2)).astype(np.float32),
            "point_labels": np.tile(np.array([[1.0, -1.0]], np.float32),
                                    (batch_size, 1)),
            "masks": (rng.random((batch_size, mask_size, mask_size)) > 0.5)
                     .astype(np.float32),
        }
        n += 1
