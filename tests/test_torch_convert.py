"""The port's checkpoint converters (dlimgedit_tpu_torch/convert/mobile_sam.py,
hf_sam.py, birefnet.py) against the JAX package's, on the CPU.

Each converter gets the same synthetic state dict, as plain numpy arrays
and as torch tensors: MobileSAM at full width (tests/test_convert_official.py),
BiRefNet at the slim width (tests/test_birefnet_parity.py), ViT-B, -L and
-H official state dicts at a narrow width and an HF SamModel state dict,
both built from init trees by tests/_torch_official_sd.py. The port's tree
must equal JAX's path for path, dtype for dtype and leaf for leaf, bit for
bit (``np.array_equal``). Also: the narrow ViT and HF dicts convert back to
their source tree exactly; the port's TinyViT on the converted weights
matches the torch oracle of tests/test_tinyvit_parity.py at its tolerance,
and a permuted bias table fails it; the CLIs write an ``.npz`` that JAX's
``load_pytree`` reads as JAX's tree and a port ``Environment`` serves.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import dlimgedit_tpu_torch as pdl
from dlimgedit_tpu.convert import birefnet as jbc
from dlimgedit_tpu.convert import hf_sam as jhf
from dlimgedit_tpu.convert import mobile_sam as jms
from dlimgedit_tpu.models import sam as jax_sam
from dlimgedit_tpu.models import swin as jswin
from dlimgedit_tpu.models.birefnet import BiRefNetConfig as JBiRefNetConfig
from dlimgedit_tpu.models.birefnet import init_birefnet as jax_init_birefnet
from dlimgedit_tpu.models.tinyvit import TinyViTConfig as JTinyViTConfig
from dlimgedit_tpu.models.vit_sam import SamViTConfig as JSamViTConfig
from dlimgedit_tpu.utils.pytree_io import flatten_tree as jax_flatten
from dlimgedit_tpu.utils.pytree_io import load_pytree as jax_load_pytree
from dlimgedit_tpu_torch.convert import birefnet as pbc
from dlimgedit_tpu_torch.convert import hf_sam as phf
from dlimgedit_tpu_torch.convert import mobile_sam as pms
from dlimgedit_tpu_torch.convert.from_numpy import load_into, numpy_from_params
from dlimgedit_tpu_torch.models import tinyvit
from dlimgedit_tpu_torch.utils.pytree_io import flatten_tree, load_pytree

from _torch_official_sd import as_tensors, hf_sam_state_dict, official_sam_state_dict
from test_birefnet_parity import synth_birefnet_sd
from test_convert_official import synth_mobile_sam_state_dict
from test_tinyvit_parity import IMG, _rescale, tiny_vit_oracle

torch.set_num_threads(2)

VIT_DEPTHS = {"vit_b": 12, "vit_l": 24, "vit_h": 32}


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _assert_trees_equal(got, want):
    """Path for path, dtype for dtype, leaf for leaf bit for bit."""
    g, w = flatten_tree(got), jax_flatten(want)
    assert set(g) == set(w), (sorted(set(w) - set(g))[:5],
                              sorted(set(g) - set(w))[:5])
    for k in w:
        assert g[k].dtype == w[k].dtype, (k, g[k].dtype, w[k].dtype)
        assert g[k].shape == w[k].shape, (k, g[k].shape, w[k].shape)
        assert np.array_equal(g[k], w[k]), k


def _both_forms(sd):
    return {"numpy": sd, "torch": as_tensors(sd)}


# ---------------------------------------------------------------------------
# MobileSAM (full width) and the SAM ViTs (narrow)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mobile_sam_sd():
    return synth_mobile_sam_state_dict(np.random.default_rng(0))


@pytest.mark.parametrize("form", ["numpy", "torch"])
def test_mobile_sam_tree_equals_jax(mobile_sam_sd, form):
    sd = _both_forms(mobile_sam_sd)[form]
    _assert_trees_equal(pms.convert_checkpoint(sd, "mobile_sam"),
                        jms.convert_checkpoint(sd, "mobile_sam"))


def test_mobile_sam_pieces_equal_jax(mobile_sam_sd):
    sd = mobile_sam_sd
    for name in ("convert_tiny_vit", "convert_prompt_encoder_official",
                 "convert_mask_decoder_official"):
        _assert_trees_equal(getattr(pms, name)(sd), getattr(jms, name)(sd))
    assert pms.BN_EPS == jms.BN_EPS


def test_optional_linear_bias_is_left_out(mobile_sam_sd):
    """A linear whose checkpoint lacks its bias converts without one, as
    JAX's (the loader then drops it from the module)."""
    sd = dict(mobile_sam_sd)
    del sd["image_encoder.layers.1.blocks.0.attn.qkv.bias"]
    del sd["mask_decoder.transformer.layers.0.self_attn.q_proj.bias"]
    got = pms.convert_checkpoint(sd, "mobile_sam")
    _assert_trees_equal(got, jms.convert_checkpoint(sd, "mobile_sam"))
    assert "b" not in got["encoder"]["stages"][1]["blocks"][0]["attn"]["qkv"]


def _narrow_vit_tree(variant: str, seed: int):
    """JAX's init tree of a narrow SAM ViT at the variant's depth, with
    nonzero rel-pos tables and pos_embed (the init zeroes them)."""
    depth = VIT_DEPTHS[variant]
    enc = JSamViTConfig(img_size=64, embed_dim=32, depth=depth, num_heads=2,
                        window_size=14,
                        global_attn_indexes=tuple(range(depth // 4 - 1, depth,
                                                        depth // 4)))
    cfg = dataclasses.replace(jax_sam.make_config(variant, 64),
                              encoder_vit=enc)
    tree = _np_tree(jax_sam.init_sam(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    e = tree["encoder"]
    e["pos_embed"] = rng.standard_normal(e["pos_embed"].shape).astype(np.float32)
    for b in e["blocks"]:
        for k in ("rel_pos_h", "rel_pos_w"):
            b[k] = rng.standard_normal(b[k].shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def vit_b_tree():
    return _narrow_vit_tree("vit_b", 1)


@pytest.mark.parametrize("variant", ["vit_b", "vit_l", "vit_h"])
def test_sam_vit_tree_equals_jax_and_the_source(variant, vit_b_tree):
    """A narrow official ViT state dict at the variant's depth converts to
    JAX's tree, which is the tree the dict was built from, exactly."""
    tree = vit_b_tree if variant == "vit_b" else _narrow_vit_tree(variant, 2)
    for sd in _both_forms(official_sam_state_dict(tree, variant)).values():
        got = pms.convert_checkpoint(sd, variant)
        _assert_trees_equal(got, jms.convert_checkpoint(sd, variant))
        _assert_trees_equal(got, tree)


# ---------------------------------------------------------------------------
# HF SamModel
# ---------------------------------------------------------------------------

class _FakeSamModel:
    """What ``convert_sam_model`` reads of a transformers SamModel."""

    def __init__(self, sd):
        self._sd = as_tensors(sd)

    def state_dict(self):
        return self._sd


def test_hf_sam_tree_equals_jax_and_the_source(vit_b_tree):
    """An HF-named state dict built from JAX's init tree converts back to
    that tree exactly, in both packages, through ``convert_sam_model`` and
    through each piece."""
    sd = hf_sam_state_dict(vit_b_tree)
    model = _FakeSamModel(sd)
    got = phf.convert_sam_model(model)
    _assert_trees_equal(got, jhf.convert_sam_model(model))
    _assert_trees_equal(got, vit_b_tree)
    for name in ("convert_vision_encoder", "convert_prompt_encoder",
                 "convert_mask_decoder"):
        _assert_trees_equal(getattr(phf, name)(sd), getattr(jhf, name)(sd))


# ---------------------------------------------------------------------------
# BiRefNet (slim width)
# ---------------------------------------------------------------------------

def _slim_birefnet_sd(seed: int):
    swin = jswin.SwinConfig(embed_dim=16, depths=(1, 1, 1, 1),
                            num_heads=(2, 2, 2, 2), window=4)
    cfg = JBiRefNetConfig(img_size=64, swin_cfg=swin, dec_inter_channels=8,
                          aspp_channelster=12, gdt_channels=4,
                          aspp_kernel_sizes=(1, 3))
    return synth_birefnet_sd(np.random.default_rng(seed), swin, cfg), cfg


@pytest.mark.parametrize("form", ["numpy", "torch"])
def test_birefnet_tree_equals_jax(form):
    sd, cfg = _slim_birefnet_sd(5)
    sd = _both_forms(sd)[form]
    got = pbc.convert_checkpoint(sd)
    _assert_trees_equal(got, jbc.convert_checkpoint(sd))
    # The training heads are dropped: the tree has init_birefnet's paths.
    want = jax_flatten(_np_tree(jax_init_birefnet(jax.random.PRNGKey(0), cfg)))
    assert set(flatten_tree(got)) == set(want)


def test_birefnet_optional_biases_and_identity_norms():
    """Convs without a bias, a stage without its output norm: both
    converters leave out or fill in the same leaves."""
    sd, _ = _slim_birefnet_sd(6)
    for k in ("decoder.conv_out1.0.bias", "decoder.lateral_block2.conv.bias",
              "decoder.decoder_block1.conv_out.bias", "bb.norm2.weight",
              "bb.norm2.bias"):
        del sd[k]
    got = pbc.convert_checkpoint(sd)
    _assert_trees_equal(got, jbc.convert_checkpoint(sd))
    assert "b" not in got["decoder"]["head"]
    assert "b" not in got["decoder"]["lat2"]
    np.testing.assert_array_equal(got["backbone"]["stages"][2]["out_norm"]["scale"],
                                  1.0)


# ---------------------------------------------------------------------------
# The port's TinyViT on converted weights against the torch oracle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def oracle_case():
    """tests/test_tinyvit_parity.py's case: (state dict, input NHWC, the
    oracle's output NHWC)."""
    rng = np.random.default_rng(7)
    sd = _rescale(synth_mobile_sam_state_dict(rng))
    x = rng.standard_normal((1, IMG, IMG, 3)).astype(np.float32)
    with torch.no_grad():
        want = tiny_vit_oracle(sd, torch.from_numpy(x).permute(0, 3, 1, 2),
                               JTinyViTConfig(img_size=IMG))
    return sd, x, want.permute(0, 2, 3, 1).numpy()


def _port_tinyvit(sd, x):
    model = load_into(tinyvit.TinyViT(tinyvit.TinyViTConfig(img_size=IMG)),
                      pms.convert_checkpoint(sd, "mobile_sam")["encoder"])
    with torch.inference_mode():
        return model.eval()(torch.from_numpy(x)).numpy()


def test_converted_tinyvit_matches_the_torch_oracle(oracle_case):
    sd, x, want = oracle_case
    got = _port_tinyvit(sd, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)


def test_converted_tinyvit_catches_a_bias_order_bug(oracle_case):
    """A permuted bias-offset table must fail the oracle: the comparison
    has teeth for a wrong offset enumeration."""
    sd, x, want = oracle_case
    bad = dict(sd)
    for k in bad:
        if k.endswith("attention_biases"):
            v = bad[k]
            bad[k] = v[:, np.roll(np.arange(v.shape[1]), 1)]
    assert not np.allclose(_port_tinyvit(bad, x), want, atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# The command lines
# ---------------------------------------------------------------------------

def test_mobile_sam_cli_bundle_is_read_by_jax_and_served(tmp_path, mobile_sam_sd):
    src = tmp_path / "mobile_sam.pt"
    torch.save(as_tensors(mobile_sam_sd), src)
    dst = tmp_path / "segmentation" / "mobile_sam.npz"
    dst.parent.mkdir()
    assert pms.main([str(src), str(dst)]) == 0
    tree = jms.convert_checkpoint(mobile_sam_sd, "mobile_sam")
    _assert_trees_equal(jax_load_pytree(dst), tree)
    _assert_trees_equal(load_pytree(dst), tree)

    env = pdl.Environment(pdl.Options(
        backend=pdl.Backend.cpu, model_directory=str(tmp_path),
        compute_dtype="float32", sam_image_size=64))
    _assert_trees_equal(numpy_from_params(env.sam_model().model), tree)
    img = pdl.Image(pdl.Extent(80, 48), pdl.Channels.rgb,
                    np.random.default_rng(3).integers(0, 256, (48, 80, 3),
                                                      dtype=np.uint8))
    seg = pdl.Segmentation.process(img, env)
    assert np.isfinite(seg.embedding.numpy()).all()
    mask = seg.compute_mask(pdl.Point(40, 24))
    assert mask.pixels.shape == (48, 80, 1) and mask.pixels.dtype == np.uint8


def test_vit_cli_takes_the_variant(tmp_path, vit_b_tree):
    src = tmp_path / "sam_vit_b.pth"
    torch.save(as_tensors(official_sam_state_dict(vit_b_tree, "vit_b")), src)
    dst = tmp_path / "sam_vit_b.npz"
    assert pms.main([str(src), str(dst), "vit_b"]) == 0
    _assert_trees_equal(load_pytree(dst), vit_b_tree)


def test_birefnet_cli_bundle_is_read_by_jax(tmp_path):
    sd, _ = _slim_birefnet_sd(7)
    src = tmp_path / "BiRefNet.pth"
    torch.save(as_tensors(sd), src)
    dst = tmp_path / "birefnet_general.npz"
    assert pbc.main([str(src), str(dst)]) == 0
    _assert_trees_equal(jax_load_pytree(dst), jbc.convert_checkpoint(sd))


def test_cli_falls_back_to_the_full_unpickler_with_a_warning(
        tmp_path, mobile_sam_sd, capsys):
    """A checkpoint that is not tensors only (here: numpy arrays, which
    the weights-only loader refuses) loads through the full unpickler,
    with JAX's warning on stderr."""
    src = tmp_path / "pickled.pt"
    torch.save(dict(mobile_sam_sd), src)
    dst = tmp_path / "out.npz"
    assert pms.main([str(src), str(dst)]) == 0
    assert "falling back to the full unpickler" in capsys.readouterr().err
    _assert_trees_equal(load_pytree(dst),
                        jms.convert_checkpoint(mobile_sam_sd, "mobile_sam"))


def test_cli_without_arguments_prints_its_usage(capsys):
    assert pms.main(["only-one"]) == 1
    assert pbc.main(["only-one"]) == 1
    out = capsys.readouterr().out
    assert "python -m dlimgedit_tpu_torch.convert.mobile_sam" in out
    assert "python -m dlimgedit_tpu_torch.convert.birefnet" in out

