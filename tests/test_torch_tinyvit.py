"""The port's TinyViT against the JAX package's, full width (the default
TinyViTConfig) at image sizes 64 and 128, in float32. JAX runs its Pallas
kernels in interpret mode (use_flash_attention, use_fused_norm,
fused_interpret); the port runs with the same flags, which on the CPU route
to the kernels' plain versions. Attention biases and qkv biases are made
nonzero, as in tests/test_flash_attention.py, so that the bias table order
and the zero-padded tokens of edge windows (LN(0) = bias, keys) count.
Tolerance atol 1e-4, rtol 1e-4: float32 summation order over ~20 layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlimgedit_tpu.models import tinyvit as jax_tinyvit
from dlimgedit_tpu_torch.convert.from_numpy import params_from_numpy
from dlimgedit_tpu_torch.models import tinyvit

torch.set_num_threads(2)


def _jax_params(img_size: int):
    params = jax_tinyvit.init_tiny_vit(
        jax.random.PRNGKey(0), jax_tinyvit.TinyViTConfig(img_size=img_size))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(7)
    for stage in params["stages"][1:]:
        for b in stage["blocks"]:
            ab = b["attn"]["attention_biases"]
            b["attn"]["attention_biases"] = (
                0.5 * rng.standard_normal(ab.shape)).astype(np.float32)
            qb = b["attn"]["qkv"]["b"]
            b["attn"]["qkv"]["b"] = (0.3 * rng.standard_normal(qb.shape)
                                     ).astype(np.float32)
    return params


@pytest.mark.parametrize("img_size", [64, 128])
def test_tinyvit_matches_jax_kernel_path(img_size):
    params = _jax_params(img_size)
    x = np.random.default_rng(3).standard_normal(
        (1, img_size, img_size, 3)).astype(np.float32)
    jcfg = jax_tinyvit.TinyViTConfig(img_size=img_size, use_flash_attention=True,
                                     use_fused_norm=True, fused_interpret=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want = np.asarray(jax_tinyvit.tiny_vit_apply(jparams, jnp.asarray(x), jcfg))

    cfg = tinyvit.TinyViTConfig(img_size=img_size, use_flash_attention=True,
                                use_fused_norm=True)
    model = tinyvit.TinyViT(cfg)
    model.load_state_dict(params_from_numpy(params), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
        # Flags off: the same plain functions, so the same numbers.
        plain_cfg = dataclasses.replace(cfg, use_flash_attention=False,
                                        use_fused_norm=False)
        plain = model(torch.from_numpy(x), plain_cfg).numpy()
    assert got.shape == (1, img_size // 16, img_size // 16, 256)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(plain, got)


def test_attention_bias_idxs_matches_jax():
    for window in (7, 14):
        got, n_got = tinyvit.attention_bias_idxs(window)
        want, n_want = jax_tinyvit.attention_bias_idxs(window)
        assert n_got == n_want
        np.testing.assert_array_equal(got, want)


def test_window_partition_round_trip_pads_with_zeros():
    x = torch.arange(2 * 9 * 10 * 3, dtype=torch.float32).reshape(2, 9, 10, 3) + 1
    wx, meta = tinyvit._window_partition(x, 7)
    assert wx.shape == (2 * 2 * 2, 49, 3)
    assert int((wx == 0).all(dim=-1).sum()) == 2 * (14 * 14 - 9 * 10)
    back = tinyvit._window_unpartition(wx, 7, meta, 9, 10, 3)
    torch.testing.assert_close(back, x, atol=0, rtol=0)
