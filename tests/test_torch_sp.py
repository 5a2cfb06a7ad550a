"""The port's sequence-parallel ViT encoder (dlimgedit_tpu_torch/parallel/sp.py)
against the JAX package's single-device ``sam_vit_apply`` on the CPU,
float32 (JAX's tests/test_sp.py is the model): the port's seeded encoder
with nonzero rel-pos tables, ``pos_embed``, qkv and LayerNorm biases,
carried to JAX
by ``numpy_from_params``, numpy-seeded images, atol 1e-5 and rtol 1e-5
(JAX's tolerance), 2e-5 for ``encode_image_sp``.

Geometry cases, JAX's three and its window_size=0 case:
  * grid 8 in windows of 4 over sp 4: no padding, an even split;
  * grid 9 (image 144): grid padding to 12 and dummy windows (9 over 4);
  * batch 2 over sp 8;
  * window_size 0: one grid-sized window per image.
Also: the replicated global-block form with the kernels' plain versions
(``use_flash_attention``; every shard runs each global block), a mesh of
distinct device objects, and both rejections (too few devices, TinyViT).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dlimgedit_tpu.models import sam as jsam
from dlimgedit_tpu.models import vit_sam as jvit
from dlimgedit_tpu_torch.convert.from_numpy import numpy_from_params
from dlimgedit_tpu_torch.models import sam, vit_sam
from dlimgedit_tpu_torch.parallel import sp as psp

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _cfgs(img_size, window=4, depth=4, globals_=(1, 3)):
    kw = dict(img_size=img_size, patch_size=16, embed_dim=64, depth=depth,
              num_heads=2, window_size=window, global_attn_indexes=globals_)
    return jvit.SamViTConfig(**kw), vit_sam.SamViTConfig(**kw)


def _seed_extras(model, seed):
    """Nonzero rel-pos tables, pos_embed, qkv biases and LayerNorm biases
    (the init zeroes them, which would hide the rel-pos and pad-key paths:
    with a zero LayerNorm bias a zero pad token stays zero after the
    LayerNorm, masked or not)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("rel_pos_h", "rel_pos_w", "pos_embed", "qkv.b",
                              "norm1.bias", "norm2.bias")):
                p.copy_(torch.from_numpy(
                    0.1 * rng.standard_normal(p.shape).astype(np.float32)))


def _encoder(cfg, seed):
    model = vit_sam.SamViT(cfg, torch.Generator().manual_seed(seed))
    _seed_extras(model, seed)
    return model


def _dense_jax(jcfg, model, x):
    return np.asarray(jax.jit(lambda p, im: jvit.sam_vit_apply(p, im, jcfg))(
        numpy_from_params(model), x))


def _sp(model, x, cfg, mesh):
    with torch.no_grad():
        return psp.sam_vit_apply_sp(model, torch.from_numpy(x), cfg,
                                    mesh).numpy()


@pytest.mark.parametrize("img_size,window,sp,B,depth,globals_", [
    (128, 4, 4, 1, 4, (1, 3)),  # 4 windows, an even split
    (144, 4, 4, 1, 4, (1, 3)),  # grid 9 -> 12: pad + dummy windows
    (128, 4, 8, 2, 4, (1, 3)),  # 8 windows over sp 8, batch 2
    (128, 0, 2, 1, 2, (1,)),    # window_size 0: one grid-sized window
], ids=["even", "pad_and_dummy", "batch2_sp8", "window0"])
def test_sp_parity(img_size, window, sp, B, depth, globals_):
    jcfg, cfg = _cfgs(img_size, window, depth, globals_)
    model = _encoder(cfg, 0)
    x = np.random.default_rng(0).standard_normal(
        (B, img_size, img_size, 3)).astype(np.float32)
    want = _dense_jax(jcfg, model, x)
    got = _sp(model, x, cfg, psp.make_sp_mesh(sp, devices=[CPU] * sp))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_sp_geometry_pads_and_masks():
    _, cfg = _cfgs(144)
    G, ws, pad, pG, n_side, n_win, n_tot = psp._geometry(cfg, 1, 4)
    assert (G, ws, pad, pG, n_side, n_win, n_tot) == (9, 4, 3, 12, 3, 9, 12)
    mask = psp._token_mask(cfg, 1, 4, torch.float32)
    assert mask.shape == (12, 4, 4, 1)
    assert mask.sum() == 81 and mask[9:].sum() == 0  # 3 dummy windows
    x = torch.randn(1, 9, 9, 5)
    wins = psp._partition(x, ws, pad, n_tot - n_win)
    grid = psp._unpartition(wins, 1, G, ws, pad)
    assert torch.equal(grid, x)
    assert grid.is_contiguous()  # the kernels on the card take no strides


@pytest.mark.parametrize("devices", ["repeated", "distinct"])
def test_sp_replicated_global_blocks_with_the_kernels_plain_versions(
        monkeypatch, devices):
    """``use_flash_attention`` takes JAX's replicated form: every shard
    runs each global block through ``_vit_block_carry`` (K1, K3, K4 on the
    card; their plain versions here)."""
    jcfg, cfg = _cfgs(144)
    cfg = dataclasses.replace(cfg, use_flash_attention=True)
    model = _encoder(cfg, 3)
    x = np.random.default_rng(3).standard_normal(
        (1, 144, 144, 3)).astype(np.float32)
    calls = []
    carry = psp._vit_block_carry
    monkeypatch.setattr(psp, "_vit_block_carry",
                        lambda *a: calls.append(1) or carry(*a))
    mesh = psp.make_sp_mesh(4, devices=[CPU] * 4 if devices == "repeated"
                            else [torch.device("cpu") for _ in range(4)])
    got = _sp(model, x, cfg, mesh)
    assert len(calls) == 4 * len(cfg.global_attn_indexes)
    np.testing.assert_allclose(got, _dense_jax(jcfg, model, x), atol=1e-5,
                               rtol=1e-5)


def test_encode_image_sp_matches_encode_image():
    """vit_b's config at 128 at test width: window 14 > grid 8, so every
    windowed block is one padded window (JAX's case)."""
    narrow = dict(embed_dim=64, depth=4, num_heads=2)
    jcfg = jsam.make_config("vit_b", 128)
    jcfg = dataclasses.replace(jcfg, encoder_vit=dataclasses.replace(
        jcfg.encoder_vit, **narrow))
    cfg = sam.make_config("vit_b", 128)
    cfg = dataclasses.replace(cfg, encoder_vit=dataclasses.replace(
        cfg.encoder_vit, **narrow))
    model = sam.init_sam(torch.Generator().manual_seed(1), cfg)
    _seed_extras(model.encoder, 1)
    x = np.random.default_rng(1).standard_normal(
        (1, 128, 128, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, im: jsam.encode_image(p, jcfg, im))(
        numpy_from_params(model), x))
    got = psp.encode_image_sp(model, cfg, torch.from_numpy(x),
                              mesh=psp.make_sp_mesh(2, devices=[CPU] * 2))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


def test_make_sp_mesh_rejects_too_few_devices(monkeypatch):
    with pytest.raises(ValueError, match="devices visible"):
        psp.make_sp_mesh(1024, devices=[CPU] * 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="devices visible"):
        psp.make_sp_mesh(2)  # no CPU fallback


def test_encode_image_sp_rejects_tinyvit():
    cfg = sam.make_config("mobile_sam", 64)
    with pytest.raises(ValueError, match="ViT encoder"):
        psp.encode_image_sp(None, cfg, torch.zeros(1, 64, 64, 3),
                            mesh=psp.make_sp_mesh(2, devices=[CPU] * 2))
