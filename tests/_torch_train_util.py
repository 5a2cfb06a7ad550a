"""Shared helpers of the port's train-tier and frames tests
(tests/test_torch_train_*.py, test_torch_distill.py, test_torch_checkpoint.py,
test_torch_frames.py): JAX trees carried into the port, JAX's slim
BiRefNet, seeded batches, and the gradient comparison."""

import jax
import numpy as np
import torch

from dlimgedit_tpu.models import birefnet as jbn
from dlimgedit_tpu.models.swin import SwinConfig as JSwinConfig
from dlimgedit_tpu.utils.pytree_io import flatten_tree
from dlimgedit_tpu_torch.convert.from_numpy import (
    numpy_from_params,
    params_from_numpy,
)
from dlimgedit_tpu_torch.models import birefnet as bn
from dlimgedit_tpu_torch.models.swin import SwinConfig

# Gradient tolerance: relative L2 per leaf. A leaf whose JAX gradient is
# zero up to rounding (the attention k-projection biases, which the
# softmax cancels: norms ~1e-10) is held against a floor of GRAD_FLOOR
# times the largest leaf's gradient norm instead of its own norm.
GRAD_REL = 1e-4
GRAD_FLOOR = 1e-4


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def load(module: torch.nn.Module, tree) -> torch.nn.Module:
    module.load_state_dict(params_from_numpy(np_tree(tree)), strict=True)
    return module


def sam_batch(B: int, size: int, mask_size: int, seed: int) -> dict:
    """JAX's tests/test_train_step.py::_setup batch."""
    rng = np.random.default_rng(seed)
    return {
        "images": rng.standard_normal((B, size, size, 3)).astype(np.float32),
        "point_coords": rng.uniform(0, size, (B, 2, 2)).astype(np.float32),
        "point_labels": np.tile(np.array([[1.0, -1.0]], np.float32), (B, 1)),
        "masks": (rng.random((B, mask_size, mask_size)) > 0.5
                  ).astype(np.float32),
    }


def flat_port(state) -> dict:
    """A port state dict (or module) as JAX's flat paths and layouts."""
    return flatten_tree(numpy_from_params(state))


def assert_grads_close(got: dict, want_tree, rel: float = GRAD_REL) -> float:
    """Every leaf of the port's gradient (a state dict) within relative L2
    ``rel`` of JAX's (a tree), the same leaves on both sides. Returns the
    largest relative error seen."""
    got_f, want_f = flat_port(got), flatten_tree(np_tree(want_tree))
    assert set(got_f) == set(want_f), set(got_f) ^ set(want_f)
    scale = max(np.linalg.norm(w) for w in want_f.values())
    worst = 0.0
    for k, want in want_f.items():
        assert got_f[k].dtype == np.float32, k
        err = np.linalg.norm(got_f[k] - want)
        ref = max(np.linalg.norm(want), GRAD_FLOOR * scale)
        worst = max(worst, err / ref)
        assert err <= rel * ref, f"{k}: relative L2 {err / ref:.3e} > {rel}"
    return worst


def rel_close(a, b, rel: float = 1e-5) -> None:
    a, b = float(a), float(b)
    assert abs(a - b) <= rel * max(abs(b), 1e-30), (a, b)


def _nonzero(tree, seed):
    """models/birefnet.py::nonzero_init over a JAX tree (offsets, modulators,
    biases, LayerNorms and rel-pos tables seeded nonzero)."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        arr = np.asarray(node)
        new = bn.nonzero_init(path, arr.shape, rng)
        return arr if new is None else new.astype(arr.dtype)

    return walk(tree, ())


def slim_birefnet():
    """JAX's tests/test_train_birefnet.py::_setup config in both packages,
    JAX's seed-0 tree with nonzero offsets, and the port's model."""
    kw = dict(img_size=64, dec_inter_channels=8, aspp_channelster=12,
              gdt_channels=4, aspp_kernel_sizes=(1, 3))
    sw = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2),
              window=4)
    jcfg = jbn.BiRefNetConfig(swin_cfg=JSwinConfig(**sw), **kw)
    cfg = bn.BiRefNetConfig(swin_cfg=SwinConfig(**sw), **kw)
    jparams = _nonzero(np_tree(jbn.init_birefnet(jax.random.PRNGKey(0), jcfg)),
                       seed=3)
    return jcfg, jparams, cfg, load(bn.BiRefNet(cfg), jparams)
