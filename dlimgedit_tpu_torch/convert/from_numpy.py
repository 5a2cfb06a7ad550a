"""Carry a JAX parameter tree across to the port.

``params_from_numpy`` takes the nested dict/list of numpy arrays that
``utils.pytree_io.load_pytree`` returns (or ``np.asarray`` of a JAX
``init_sam`` tree) and returns the port's ``state_dict``: keys are the tree
paths joined with dots (``encoder.stages.1.blocks.0.attn.qkv.w``). A
convolution kernel (a 4-D leaf named ``w``) goes from the tree's HWIO to
the port's OIHW; every other leaf keeps its shape and layout (linear
weights stay (in, out), the ViT's ``pos_embed`` stays (1, g, g, C)). One
``.npz`` bundle thus serves both packages.

A tree that JAX's ``quantize_encoder`` has quantised carries int8 ``w_q``
or ``w_q8`` leaves and float32 ``w_scale`` leaves in place of a linear's
``w``: both keep their dtype. ``load_into`` swaps the matching ``Linear``s
of the model for ``QuantLinear``s before it loads, so such a tree loads
``strict=True``.

``numpy_from_params`` is the inverse: a state dict (or a module's) back to
the nested numpy tree, OIHW convolution kernels back to HWIO, int8 and
``w_scale`` leaves in their dtype, so a trained model exports the
``.npz`` that both packages load.

A bias that the JAX package reads only when the tree holds it (a linear's
``b``, a BiRefNet conv's ``b``: the modules with ``bias_optional``) may
be absent from the tree: ``load_into`` then removes it from the module,
which adds no bias, as JAX. Every other leaf is required.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..models.common import QuantLinear
from ..utils.pytree_io import flatten_tree, unflatten_tree

_INT8_WEIGHTS = ("w_q", "w_q8")


def params_from_numpy(tree, device="cpu",
                      dtype: Optional[torch.dtype] = torch.float32
                      ) -> Dict[str, torch.Tensor]:
    """Nested numpy tree -> flat state dict on `device`. Floating leaves are
    cast to `dtype` (None keeps theirs), except the int8 scales
    (``w_scale``), which stay float32; integer leaves keep theirs."""
    state = {}
    for path, arr in flatten_tree(tree).items():
        arr = np.asarray(arr)
        name = path.split("/")[-1]
        if arr.ndim == 4 and name == "w":
            arr = arr.transpose(3, 2, 0, 1)  # conv kernel: HWIO -> OIHW
        t = torch.tensor(arr)  # a copy: the tree may hold read-only arrays
        if name == "w_scale":
            t = t.float()
        elif dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        state[path.replace("/", ".")] = t.to(device)
    return state


def load_into(model: nn.Module, tree, dtype: Optional[torch.dtype] = torch.float32
              ) -> nn.Module:
    """Load a numpy tree into ``model`` with ``strict=True``: each linear
    that the tree holds quantised (``<path>.w_q`` or ``<path>.w_q8``)
    becomes a ``QuantLinear`` first, and an optional bias the tree leaves
    out is removed from its module. Returns ``model``."""
    state = params_from_numpy(tree, dtype=dtype)
    for path, mod in model.named_modules():
        if (getattr(mod, "bias_optional", False) and hasattr(mod, "b")
                and (f"{path}.b" if path else "b") not in state):
            del mod.b
    for key, t in state.items():
        path, _, name = key.rpartition(".")
        if name in _INT8_WEIGHTS:
            model.set_submodule(path, QuantLinear(
                torch.empty_like(t), torch.empty(t.shape[1]),
                torch.empty(t.shape[1]) if f"{path}.b" in state else None,
                act_int8=name == "w_q8"))
    model.load_state_dict(state, strict=True)
    return model


def numpy_from_params(params: Union[nn.Module, Dict[str, torch.Tensor]]):
    """A state dict (or a module's ``state_dict``) -> the nested numpy tree
    of ``params_from_numpy``'s input, on the host: 4-D leaves named ``w``
    go from OIHW back to HWIO; float32, float16, float64 and integer
    leaves keep their dtype, other floating leaves (bfloat16, which numpy
    lacks) become float32."""
    state = params.state_dict() if isinstance(params, nn.Module) else params
    flat = {}
    for key, t in state.items():
        t = t.detach().cpu()
        if t.is_floating_point() and t.dtype not in (
                torch.float32, torch.float16, torch.float64):
            t = t.float()
        arr = t.numpy()
        if arr.ndim == 4 and key.rsplit(".", 1)[-1] == "w":
            arr = arr.transpose(2, 3, 1, 0)  # conv kernel: OIHW -> HWIO
        flat[key.replace(".", "/")] = np.ascontiguousarray(arr)
    return unflatten_tree(flat)
