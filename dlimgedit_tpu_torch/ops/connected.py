"""Largest-connected-component selection on the device (counterpart of
dlimgedit_tpu/ops/connected.py), batched over a leading axis.

Hook + pointer-jump labelling: every foreground pixel is seeded with a
unique id (flat index + 1, so a label doubles as a pointer to a pixel);
each sweep HOOKS (the 4-neighbourhood max is scatter-maxed onto the pixel
each label points at) and then POINTER-JUMPS twice (labels <- labels[labels]).
It converges in O(log(H*W)) sweeps, capped at 64 as in the JAX package.

The JAX package tests for convergence after every sweep inside one
compiled loop. Here each test is a device-to-host read, so the test runs
after every group of ``_SWEEPS_PER_CHECK`` sweeps instead. The result is the
same: a sweep at the fixpoint changes nothing, and the cap (64) is a
multiple of the group size, so a run that hits the cap has done exactly 64
sweeps either way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_SWEEPS_PER_CHECK = 4


def _propagate_once(labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """labels, mask: (B, H, W) -> max over the pixel and its 4-neighbours,
    zero on the background."""
    up = F.pad(labels[:, :-1, :], (0, 0, 1, 0))
    down = F.pad(labels[:, 1:, :], (0, 0, 0, 1))
    left = F.pad(labels[:, :, :-1], (1, 0))
    right = F.pad(labels[:, :, 1:], (0, 1))
    m = torch.maximum(torch.maximum(up, down), torch.maximum(left, right))
    return torch.where(mask, torch.maximum(labels, m), 0)


def _sweep(labels: torch.Tensor, mask: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    B, H, W = labels.shape
    cand = _propagate_once(labels, mask).reshape(B, H * W)
    f = labels.reshape(B, H * W)
    # Hook: push the neighbourhood max onto the pixel this label points at
    # (background pixels scatter the harmless value 0 onto pixel 0).
    f = f.scatter_reduce(1, torch.clamp(f - 1, min=0), torch.where(fg, cand, 0),
                         reduce="amax", include_self=True)
    f = torch.where(fg, torch.maximum(f, cand), 0)
    # Jump twice: follow the pointer and adopt its (just-updated) label.
    for _ in range(2):
        j = torch.gather(f, 1, torch.clamp(f - 1, min=0))
        f = torch.where(fg, torch.maximum(f, j), 0)
    return f.reshape(B, H, W)


def _label_components(mask: torch.Tensor, max_iters: int = 64) -> torch.Tensor:
    """mask: (B, H, W) bool -> labels (B, H, W) int64, every pixel of a
    4-connected component holding the component's max pixel id."""
    B, H, W = mask.shape
    ids = torch.arange(1, H * W + 1, device=mask.device).reshape(1, H, W)
    labels = torch.where(mask, ids, 0)
    fg = mask.reshape(B, H * W)
    done = 0
    while done < max_iters:
        prev = labels
        for _ in range(min(_SWEEPS_PER_CHECK, max_iters - done)):
            labels = _sweep(labels, mask, fg)
        done += _SWEEPS_PER_CHECK
        if not bool((labels != prev).any()):
            break
    return labels


def largest_component_mask(mask: torch.Tensor, max_iters: int = 64
                           ) -> torch.Tensor:
    """mask: (B, H, W) bool -> bool mask of each item's largest 4-connected
    component (ties: the component with the smallest max id wins, as
    argmax takes the first)."""
    B, H, W = mask.shape
    labels = _label_components(mask, max_iters)
    sizes = torch.zeros((B, H * W + 1), dtype=torch.int64, device=mask.device)
    sizes.scatter_add_(1, labels.reshape(B, H * W),
                       mask.reshape(B, H * W).to(torch.int64))
    sizes[:, 0] = 0  # background
    biggest = torch.argmax(sizes, dim=1)
    return (labels == biggest[:, None, None]) & mask
