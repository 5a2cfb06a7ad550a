"""Training checkpoints and the serving export (counterpart of
dlimgedit_tpu/train/checkpoint.py, without orbax).

A checkpoint is one file ``directory/step_<N>``: ``torch.save`` of the
leaves (host copies, by dotted path), the optimizer state and the step,
written under a temporary name in the same directory and moved into place
with ``os.replace``, so a reader never sees half a file.
``export_serving_bundle`` writes the ``.npz`` bundle both packages load
(``convert/from_numpy.py::numpy_from_params``).

Under several processes (parallel/multihost.py) every process holds the
same state after a step, so rank 0 alone writes; every process restores
the same file (a directory all of them see), and both calls end at a
barrier, so a restore that follows a save reads the whole file.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..convert.from_numpy import numpy_from_params
from ..errors import DlimgError
from ..parallel.multihost import barrier, world
from ..utils.pytree_io import save_pytree
from .step import TrainConfig, learning_rate_schedule, leaves, to_device

__all__ = ["export_serving_bundle", "latest_step", "restore_train_state",
           "save_train_state"]

Params = Union[nn.Module, Dict[str, torch.Tensor]]


def _state(params: Params) -> Dict[str, torch.Tensor]:
    return leaves(params) if isinstance(params, nn.Module) else params


def save_train_state(directory, step: int, params: Params,
                     opt_state: Dict) -> None:
    """Write ``directory/step_<step>`` atomically (a model's leaves, or a
    state dict, and the optimizer state, as host tensors); rank 0 writes
    under several processes."""
    if world()[1] == 0:
        _write(Path(directory), step, params, opt_state)
    barrier()


def _write(d: Path, step: int, params: Params, opt_state: Dict) -> None:
    d.mkdir(parents=True, exist_ok=True)
    payload = {"params": to_device(_state(params), "cpu"),
               "opt_state": to_device(opt_state, "cpu"), "step": int(step)}
    fd, tmp = tempfile.mkstemp(prefix=f".step_{step}.", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, d / f"step_{step}")
    except BaseException:
        os.unlink(tmp)
        raise


def latest_step(directory) -> Optional[int]:
    d = Path(directory)
    if not d.is_dir():
        return None
    steps = [int(p.name.split("_", 1)[1]) for p in d.iterdir()
             if p.name.startswith("step_") and p.name.split("_", 1)[1].isdigit()]
    return max(steps) if steps else None


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def restore_train_state(directory, step: Optional[int] = None,
                        like: Optional[nn.Module] = None,
                        tcfg=None) -> Tuple[Any, Dict, int]:
    """(params, opt_state, step) of ``directory/step_<step>`` (default the
    latest). With ``like`` (a model of the saved structure) the leaves are
    loaded into it, strictly, and it is returned as ``params``, with the
    optimizer state on its device; otherwise ``params`` is the state dict
    on the host, and the optimizer state must have the leaf count of
    ``tcfg``'s (default ``TrainConfig()``) optimizer over those params: a
    checkpoint of another optimizer configuration raises."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = Path(directory) / f"step_{step}"
    payload = torch.load(path, map_location="cpu", weights_only=True)
    barrier()
    params, opt_state = payload["params"], payload["opt_state"]
    if like is not None:
        like.load_state_dict(params, strict=True)
        device = next(like.parameters()).device
        return like, to_device(opt_state, device), int(payload["step"])
    scheduled = callable(learning_rate_schedule(tcfg or TrainConfig()))
    want = 2 * len(params) + 1 + int(scheduled)
    have = _count_leaves(opt_state)
    if have != want:
        raise DlimgError(
            f"checkpoint opt_state has {have} leaves, the optimizer expects "
            f"{want}: was it saved with another optimizer configuration "
            f"(a schedule adds one)? Pass its config as tcfg")
    return params, opt_state, int(payload["step"])


def export_serving_bundle(params: Params, out_path) -> None:
    """Write trained parameters as the runtime's ``.npz`` bundle
    (``model_directory/segmentation/<name>.npz``), which both packages
    load."""
    os.makedirs(Path(out_path).parent, exist_ok=True)
    save_pytree(out_path, numpy_from_params(_state(params)))
