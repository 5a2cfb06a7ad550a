"""Carry a JAX parameter tree across to the port.

``params_from_numpy`` takes the nested dict/list of numpy arrays that
``utils.pytree_io.load_pytree`` returns (or ``np.asarray`` of a JAX
``init_sam`` tree) and returns the port's ``state_dict``: keys are the tree
paths joined with dots (``encoder.stages.1.blocks.0.attn.qkv.w``), every
4-D leaf goes from the tree's HWIO to the port's OIHW, and every other leaf
keeps its shape (linear weights stay (in, out)). One ``.npz`` bundle thus
serves both packages.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..utils.pytree_io import flatten_tree


def params_from_numpy(tree, device="cpu",
                      dtype: Optional[torch.dtype] = torch.float32
                      ) -> Dict[str, torch.Tensor]:
    """Nested numpy tree -> flat state dict on `device`. Floating leaves are
    cast to `dtype` (None keeps theirs); integer leaves keep theirs."""
    state = {}
    for path, arr in flatten_tree(tree).items():
        arr = np.asarray(arr)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        t = torch.tensor(arr)  # a copy: the tree may hold read-only arrays
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        state[path.replace("/", ".")] = t.to(device)
    return state
