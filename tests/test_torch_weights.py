"""One .npz bundle serves both packages: a JAX `init_sam` tree written with
the JAX package's save_pytree, read by the port's load_pytree and
params_from_numpy, equals the JAX tree leaf for leaf (4-D leaves
transposed HWIO -> OIHW), and fills the port's Sam module exactly."""

import jax
import numpy as np
import pytest
import torch

from dlimgedit_tpu.models import sam as jax_sam
from dlimgedit_tpu.utils.pytree_io import flatten_tree as jax_flatten_tree
from dlimgedit_tpu.utils.pytree_io import save_pytree as jax_save_pytree
from dlimgedit_tpu_torch.convert.from_numpy import params_from_numpy
from dlimgedit_tpu_torch.models import sam
from dlimgedit_tpu_torch.utils.pytree_io import flatten_tree, load_pytree

torch.set_num_threads(2)

IMAGE_SIZE = 64


@pytest.fixture(scope="module")
def jax_tree():
    cfg = jax_sam.make_config("mobile_sam", IMAGE_SIZE)
    return jax.tree_util.tree_map(
        np.asarray, jax_sam.init_sam(jax.random.PRNGKey(0), cfg))


@pytest.fixture(scope="module")
def bundle(jax_tree, tmp_path_factory):
    path = tmp_path_factory.mktemp("bundle") / "mobile_sam.npz"
    jax_save_pytree(path, jax_tree)
    return path


def test_bundle_round_trip_leaf_for_leaf(jax_tree, bundle):
    want = jax_flatten_tree(jax_tree)
    state = params_from_numpy(load_pytree(bundle))
    assert sorted(state) == sorted(k.replace("/", ".") for k in want)
    for key, arr in want.items():
        got = state[key.replace("/", ".")].numpy()
        if arr.ndim == 4:
            got = got.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, arr, err_msg=key)


def test_bundle_fills_the_port_module(bundle):
    model = sam.Sam(sam.make_config("mobile_sam", IMAGE_SIZE))
    model.load_state_dict(params_from_numpy(load_pytree(bundle)), strict=True)
    w = model.encoder.stages[1].blocks[0].attn.qkv.w
    assert w.shape == (128, 384)  # linear weights stay (in, out)
    assert model.encoder.patch_embed.conv1.w.shape == (32, 3, 3, 3)  # OIHW


def test_port_init_has_the_jax_tree_structure(jax_tree):
    """The port's own random init: same keys and shapes as the JAX tree
    (different numbers: torch.Generator, not jax.random)."""
    model = sam.init_sam(torch.Generator().manual_seed(0),
                         sam.make_config("mobile_sam", IMAGE_SIZE))
    state = model.state_dict()
    want = params_from_numpy(jax_tree)
    assert list(state) == list(want) or sorted(state) == sorted(want)
    for key, t in want.items():
        assert state[key].shape == t.shape, key


def test_port_pytree_io_matches_jax_format(jax_tree):
    assert sorted(flatten_tree(jax_tree)) == sorted(jax_flatten_tree(jax_tree))


def test_dtype_cast_keeps_integer_leaves():
    tree = {"a": {"w": np.ones((2, 3), np.float64)}, "idx": np.arange(3)}
    state = params_from_numpy(tree, dtype=torch.bfloat16)
    assert state["a.w"].dtype == torch.bfloat16
    assert state["idx"].dtype == torch.int64


def test_a_linear_without_its_bias_loads_and_matches_jax(jax_tree):
    """JAX's ``linear`` adds "b" only when the tree holds it
    (models/common.py): a SAM tree whose linears lack it loads into the
    port and encodes as JAX does (atol 1e-4, the encoder parity
    tolerance); a missing weight still raises."""
    import copy

    import jax.numpy as jnp

    from dlimgedit_tpu_torch.convert.from_numpy import load_into

    tree = copy.deepcopy(jax_tree)
    block = tree["encoder"]["stages"][1]["blocks"][0]
    del block["attn"]["proj"]["b"], block["mlp"]["fc1"]["b"]
    del tree["decoder"]["transformer"]["final_attn"]["out"]["b"]
    cfg = sam.make_config("mobile_sam", IMAGE_SIZE)
    model = load_into(sam.Sam(cfg), tree)
    assert not hasattr(model.encoder.stages[1].blocks[0].attn.proj, "b")
    x = np.random.default_rng(0).standard_normal(
        (1, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    jcfg = jax_sam.make_config("mobile_sam", IMAGE_SIZE)
    want = np.asarray(jax.jit(lambda p, im: jax_sam.encode_image(p, jcfg, im))(
        jax.tree_util.tree_map(jnp.asarray, tree), x))
    with torch.inference_mode():
        got = sam.encode_image(model, cfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    del tree["encoder"]["stages"][1]["blocks"][0]["mlp"]["fc2"]["w"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_into(sam.Sam(cfg), tree)
