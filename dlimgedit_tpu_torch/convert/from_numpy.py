"""Carry a JAX parameter tree across to the port.

``params_from_numpy`` takes the nested dict/list of numpy arrays that
``utils.pytree_io.load_pytree`` returns (or ``np.asarray`` of a JAX
``init_sam`` tree) and returns the port's ``state_dict``: keys are the tree
paths joined with dots (``encoder.stages.1.blocks.0.attn.qkv.w``). A
convolution kernel (a 4-D leaf named ``w``) goes from the tree's HWIO to
the port's OIHW; every other leaf keeps its shape and layout (linear
weights stay (in, out), the ViT's ``pos_embed`` stays (1, g, g, C)). One
``.npz`` bundle thus serves both packages.
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
        if arr.ndim == 4 and path.split("/")[-1] == "w":
            arr = arr.transpose(3, 2, 0, 1)  # conv kernel: HWIO -> OIHW
        t = torch.tensor(arr)  # a copy: the tree may hold read-only arrays
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        state[path.replace("/", ".")] = t.to(device)
    return state
