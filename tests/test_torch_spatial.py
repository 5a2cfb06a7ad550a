"""The port's canvas-row sharding (dlimgedit_tpu_torch/parallel/spatial.py)
against the JAX package on the CPU, float32; JAX's tests/test_spatial.py
and the TinyViT case of tests/test_scaleout.py are the models. Meshes are
explicit device lists (``[cpu] * n``); JAX's side runs as its own tests run
it: dense ``birefnet_apply`` / ``encode_image`` under ``jax.jit`` and
``birefnet_apply_spatial`` over the 8 virtual CPU devices of
tests/conftest.py. Trees: JAX's slim seed-0 BiRefNet with nonzero offsets
(``_torch_train_util.slim_birefnet``), the port's seeded MobileSAM with
nonzero biases carried to JAX by ``numpy_from_params``; inputs from numpy
seeds.

Tolerances:
  * ``birefnet_apply_spatial`` over 8 bands (B = 1: the stride-32 level's
    2 rows leave 6 bands empty) and ``segment_image_spatial`` over 4 (B =
    2) against JAX's dense ``birefnet_apply``, and over 8 against JAX's
    ``birefnet_apply_spatial``: atol 5e-5, rtol 1e-5 (JAX's own limit);
    the int8 deform gathers against the port's dense int8 path, likewise;
  * a shifted Swin block whose wrap window spans the first and the last of
    3 bands (H = W = 18, padded to 20, window 4, shift 2) against JAX's
    ``_swin_block``: atol 1e-5;
  * ``deform_conv2d`` on an output-row window: the dense call's rows
    within 1e-6, JAX's within 1e-5;
  * the TinyViT bands over 2, 3 and 8 bands at ``sam_image_size=128``
    (windows 7 / 14 / 7 over 16 / 8 / 8 rows straddle the band edges)
    against JAX's ``encode_image``: atol 2e-4, rtol 1e-4 (JAX's
    tests/test_scaleout.py limit).
The layout is genuinely row-partitioned (the analog of JAX's HLO check):
each band holds only its rows, a 3x3 conv fetches exactly its 1-row halo
per edge, a straddling TinyViT or Swin window only the window's rows, and
a whole forward gathers a full-resolution tensor only for the patches and
the result.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_util import slim_birefnet
from dlimgedit_tpu.models import sam as jsam
from dlimgedit_tpu.models import swin as jswin
from dlimgedit_tpu.ops import deform as jdeform
from dlimgedit_tpu.parallel import spatial as jspatial
from dlimgedit_tpu_torch.convert.from_numpy import numpy_from_params
from dlimgedit_tpu_torch.models import birefnet as bn
from dlimgedit_tpu_torch.models import sam, swin, tinyvit
from dlimgedit_tpu_torch.ops import deform
from dlimgedit_tpu_torch.parallel import mesh as pmesh
from dlimgedit_tpu_torch.parallel import spatial

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _mesh(n):
    return spatial.make_spatial_mesh(n, devices=[CPU] * n)


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def slim():
    """(JAX config, JAX tree, port config, port model, x (2, 64, 64, 3),
    JAX's dense logits of x)."""
    jcfg, jparams, cfg, model = slim_birefnet()
    x = _x((2, 64, 64, 3), 0)
    want = np.asarray(jax.jit(lambda p, v: jbn_apply(p, v, jcfg))(
        jparams, jnp.asarray(x)))
    return jcfg, jparams, cfg, model.eval(), x, want


def jbn_apply(params, x, cfg):
    from dlimgedit_tpu.models.birefnet import birefnet_apply

    return birefnet_apply(params, x, cfg)


@pytest.mark.parametrize("sp,B", [(8, 1), (4, 2)])
def test_birefnet_bands_match_jax(slim, sp, B):
    _, _, cfg, model, x, want = slim
    with torch.no_grad():
        if B == 1:
            got = spatial.birefnet_apply_spatial(
                model, torch.from_numpy(x[:1]), cfg, _mesh(sp))
        else:
            got = spatial.segment_image_spatial(model, cfg, torch.from_numpy(x),
                                                _mesh(sp))
    assert got.dtype == torch.float32 and got.shape == (B, 64, 64, 1)
    np.testing.assert_allclose(got.numpy(), want[:B], atol=5e-5, rtol=1e-5)


def test_birefnet_bands_match_jax_spatial(slim):
    jcfg, jparams, cfg, model, x, _ = slim
    jmesh = jspatial.make_spatial_mesh(8, devices=jax.devices("cpu"))
    want = np.asarray(jspatial.birefnet_apply_spatial(
        jparams, jnp.asarray(x[:1]), jcfg, jmesh))
    with torch.no_grad():
        got = spatial.birefnet_apply_spatial(model, torch.from_numpy(x[:1]),
                                             cfg, _mesh(8))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-5)


def test_int8_deform_bands_match_the_dense_int8_path(slim):
    """The bands sample the whole input's corner stack, so its int8 scale
    is the dense one (a per-band stack would quantise differently)."""
    _, _, cfg, model, x, _ = slim
    cfg = dataclasses.replace(cfg, deform_int8_gather=True)
    xt = torch.from_numpy(x[:1])
    with torch.no_grad():
        want = bn.birefnet_apply(model, xt, cfg)
        got = spatial.birefnet_apply_spatial(model, xt, cfg, _mesh(8))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# The layout and the fetches
# ---------------------------------------------------------------------------

@pytest.fixture
def fetches(monkeypatch):
    """Every ``rows`` call of the band programs, as (H of the tensor, lo,
    hi, period)."""
    seen = []
    inner = spatial.rows

    def recording(t, lo, hi, device, period=None):
        seen.append((t.H, lo, hi, period))
        return inner(t, lo, hi, device, period)

    monkeypatch.setattr(spatial, "rows", recording)
    return seen


def test_rows_fetch_zeros_outside_and_wrap_with_a_period():
    x = torch.arange(2 * 6 * 2 * 1, dtype=torch.float32).reshape(2, 6, 2, 1)
    t = spatial.shard_rows(x, [CPU] * 4)
    assert t.starts == (0, 2, 4, 6, 6) and t.parts[3] is None
    assert [p.shape[1] for p in t.parts[:3]] == [2, 2, 2]
    zero = torch.zeros((2, 1, 2, 1))
    torch.testing.assert_close(spatial.rows(t, -1, 7, CPU),
                               torch.cat([zero, x, zero], dim=1))
    # Period 8: rows 6 and 7 are the zero pad, then row 0 again.
    torch.testing.assert_close(
        spatial.rows(t, 5, 10, CPU, period=8),
        torch.cat([x[:, 5:6], zero, zero, x[:, 0:2]], dim=1))
    assert spatial.rows(t, 1, 3, CPU).is_contiguous()


def test_each_band_holds_only_its_rows_and_a_conv_fetches_its_halo(fetches):
    x = torch.from_numpy(_x((2, 64, 64, 3), 1))
    t = spatial.shard_rows(x, [CPU] * 8)
    assert [tuple(p.shape) for p in t.parts] == [(2, 8, 64, 3)] * 8
    assert all(p.is_contiguous() for p in t.parts)
    w = torch.from_numpy(_x((5, 3, 3, 3), 2))
    y = spatial.conv_rows(t, 3, lambda i, v, pad: bn.conv2d(v, w, padding=pad))
    assert fetches == [(64, 8 * i - 1, 8 * i + 9, None) for i in range(8)]
    torch.testing.assert_close(spatial.gather(y, CPU),
                               bn.conv2d(x, w, padding=1))


def test_a_straddling_window_fetches_only_its_rows(fetches):
    """TinyViT: 16 rows, windows of 7 (padded to 21), 3 bands of 6 rows:
    band 1 [6, 12) meets windows [0, 7) and [7, 14). Swin shifted by 2:
    18 rows, windows of 4 (padded to 20), band 0 [0, 6) in rolled rows
    [-2, 4), the wrap window's original rows 18, 19 (the zero pad), 0, 1,
    fetched cyclically."""
    t = spatial.shard_rows(torch.zeros((1, 16, 4, 1)), [CPU] * 3)
    spatial.window_rows(t, 7, lambda i, v, a: v)
    assert fetches == [(16, 0, 7, 21), (16, 0, 14, 21), (16, 7, 21, 21)]
    fetches.clear()
    t = spatial.shard_rows(torch.zeros((1, 18, 4, 1)), [CPU] * 3)
    spatial.window_rows(t, 4, lambda i, v, a: v, shift=2)
    assert fetches == [(18, -2, 6, 20), (18, 6, 14, 20), (18, 10, 18, 20)]


def test_a_forward_gathers_the_full_resolution_only_for_patches_and_result(
        slim, fetches):
    """A regression to "gather everything and run dense" fails here: at
    full resolution every fetch but two (the input for the patches, the
    logits) reads at most a band and its halo."""
    _, _, cfg, model, x, _ = slim
    with torch.no_grad():
        spatial.birefnet_apply_spatial(model, torch.from_numpy(x[:1]), cfg,
                                       _mesh(8))
    full = [(lo, hi) for H, lo, hi, _ in fetches if H == 64]
    whole = [f for f in full if f == (0, 64)]
    assert len(whole) == 2
    assert len(full) > 8 and all(hi - lo <= 10 for lo, hi in full
                                 if (lo, hi) != (0, 64))


# ---------------------------------------------------------------------------
# Layer rules against JAX
# ---------------------------------------------------------------------------

def test_shifted_swin_block_across_bands_matches_jax():
    dim, heads, window, shift = 16, 2, 4, 2
    block = swin.SwinBlock(dim, heads, window, 4.0,
                           torch.Generator().manual_seed(0))
    bn.seed_nonzero_init(block, seed=5)  # rel-pos table, biases, norms
    x = _x((2, 18, 18, dim), 6)
    want = np.asarray(jswin._swin_block(
        jax.tree_util.tree_map(jnp.asarray, numpy_from_params(block)),
        jnp.asarray(x), heads, window, shift, 1e-5))
    t = spatial.shard_rows(torch.from_numpy(x), [CPU] * 3)
    with torch.no_grad():
        got = spatial._swin_block_bands(spatial.PerBand([block] * 3), t, heads,
                                        window, shift, 1e-5)
    assert got.starts == (0, 6, 12, 18)
    np.testing.assert_allclose(spatial.gather(got, CPU).numpy(), want,
                               atol=1e-5)


@pytest.mark.parametrize("ks", [3, 7])
def test_deform_conv2d_on_an_output_row_window(ks):
    H, W, C, O = 9, 11, 6, 5
    x = _x((2, H, W, C), ks)
    offset = _x((2, H, W, 2 * ks * ks), ks + 1, scale=3.0)
    mask = np.random.default_rng(ks + 2).uniform(
        0, 2, (2, H, W, ks * ks)).astype(np.float32)
    w = _x((ks, ks, C, O), ks + 3, scale=0.3)  # HWIO
    b = _x((O,), ks + 4)
    want = np.asarray(jdeform.deform_conv2d(
        jnp.asarray(x), jnp.asarray(offset), jnp.asarray(mask), jnp.asarray(w),
        jnp.asarray(b), padding=ks // 2))
    args = (torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(b))
    dense = deform.deform_conv2d(torch.from_numpy(x), torch.from_numpy(offset),
                                 torch.from_numpy(mask), *args,
                                 padding=ks // 2)
    lo, hi = 3, 7
    got = deform.deform_conv2d(torch.from_numpy(x),
                               torch.from_numpy(offset[:, lo:hi]),
                               torch.from_numpy(mask[:, lo:hi]), *args,
                               padding=ks // 2, rows=(lo, hi))
    assert got.shape == (2, hi - lo, W, O)
    np.testing.assert_allclose(got.numpy(), dense[:, lo:hi].numpy(), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want[:, lo:hi], atol=1e-5)


@pytest.fixture(scope="module")
def mobile_sam_128():
    """The port's seeded MobileSAM at 128 with nonzero attention biases,
    LayerNorm and folded-BN biases, and JAX's embedding of one image."""
    cfg = sam.make_config("mobile_sam", 128)
    model = sam.init_sam(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for name, p in model.encoder.named_parameters():
            if name.endswith(("attention_biases", "bias", ".b")):
                p.copy_(torch.from_numpy(
                    0.2 * rng.standard_normal(p.shape).astype(np.float32)))
    jcfg = jsam.make_config("mobile_sam", 128)
    x = _x((1, 128, 128, 3), 8)
    want = np.asarray(jax.jit(lambda p, v: jsam.encode_image(p, jcfg, v))(
        numpy_from_params(model), jnp.asarray(x)))
    return cfg, model.eval(), x, want


@pytest.mark.parametrize("sp", [2, 3, 8])
def test_tinyvit_bands_match_jax(mobile_sam_128, sp):
    cfg, model, x, want = mobile_sam_128
    with torch.no_grad():
        got = spatial.tinyvit_apply_spatial(model.encoder, torch.from_numpy(x),
                                            cfg.encoder_tiny, _mesh(sp))
    assert got.shape == (1, 8, 8, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)


def test_a_spatial_mesh_needs_one_sp_axis_and_enough_devices():
    with pytest.raises(ValueError, match="devices visible"):
        spatial.make_spatial_mesh(2, devices=[CPU])
    model = tinyvit.TinyViT(tinyvit.TinyViTConfig(img_size=64))
    with pytest.raises(ValueError, match="'sp'"):
        spatial.tinyvit_apply_spatial(
            model, torch.zeros((1, 64, 64, 3)), model.cfg,
            pmesh.make_mesh(2, dp=2, devices=[CPU] * 2))
