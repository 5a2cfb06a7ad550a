"""The port's SAM ViT encoder and its slice against the JAX package, on the
CPU in float32, all inputs from numpy seeds:

  * ``sam_vit_apply`` at narrow widths (embed 128 and 160 with 2 heads:
    hd 64 and 80), depth 2 with one windowed (14) and one global block, at
    image sizes 256 and 384, with nonzero rel-pos tables, ``pos_embed`` and
    qkv bias: the kernel path (JAX's Pallas kernels in interpret mode, the
    port's kernel wrappers, which on the CPU compute their plain versions)
    and the dense path. At 256 every block is windowed in the kernel
    sense (N <= 256: K5, with the pad-query skip on the 14-windows of the
    16-grid); at 384 the global block takes K4 (N = 576). Tolerance atol
    1e-4, rtol 1e-4: float32 summation order through two blocks and the
    neck;
  * the weight carry: a JAX ViT-B tree (full width, image size 64) read by
    ``params_from_numpy`` fills the port's ``Sam`` with strict=True,
    ``pos_embed`` keeps its (1, g, g, C) layout, and both encoders agree;
  * ``fused_window_blocks``: ``sam_vit_apply`` with the windowed blocks on
    the strip path (K6's plain version; JAX's strip kernel in interpret
    mode) at JAX's own test geometry (image 48, window 2, grid 3 -> 4) and
    at the narrow widths above, with ``use_flash_attention`` on and off;
  * ``Segmentation`` end to end with an injected narrow ``vit_b`` bundle,
    and again with its windowed block on the strip path: the embedding
    within atol 1e-4, masks byte for byte, a flipped pixel allowed only
    where JAX's logit is within 1e-4 of zero.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlimgedit_tpu as jdl
import dlimgedit_tpu_torch as pdl
from dlimgedit_tpu.models import sam as jax_sam
from dlimgedit_tpu.models import vit_sam as jax_vit
from dlimgedit_tpu.ops.connected import largest_component_mask as jax_lcc
from dlimgedit_tpu.ops.postprocess import upsample_mask_logits as jax_upsample
from dlimgedit_tpu.ops.preprocess import pick_bucket
from dlimgedit_tpu.runtime.environment import SamModelBundle as JaxBundle
from dlimgedit_tpu_torch.convert.from_numpy import params_from_numpy
from dlimgedit_tpu_torch.models import sam, vit_sam
from dlimgedit_tpu_torch.runtime.environment import SamModelBundle

torch.set_num_threads(2)

NEAR_ZERO = 1e-4


def _narrow(mod, embed: int, img_size: int):
    return mod.SamViTConfig(img_size=img_size, embed_dim=embed, depth=2,
                            num_heads=2, window_size=14,
                            global_attn_indexes=(1,))


def _randomise(encoder: dict, seed: int) -> dict:
    """Nonzero rel-pos tables, pos_embed and qkv bias (JAX's init zeroes
    them), so the rel-pos indexing, the embedding layout and the pad keys
    of edge windows (k = v = qkv bias) all count."""
    rng = np.random.default_rng(seed)

    def fill(a, std):
        return (std * rng.standard_normal(a.shape)).astype(np.float32)

    encoder["pos_embed"] = fill(encoder["pos_embed"], 0.5)
    for b in encoder["blocks"]:
        b["rel_pos_h"] = fill(b["rel_pos_h"], 0.3)
        b["rel_pos_w"] = fill(b["rel_pos_w"], 0.3)
        b["qkv"]["b"] = fill(b["qkv"]["b"], 0.3)
    return encoder


def _jax_tree(cfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jax_sam.init_sam(jax.random.PRNGKey(seed), cfg))


@pytest.mark.parametrize("path", ["kernel", "dense"])
@pytest.mark.parametrize("embed,img_size", [(128, 256), (160, 384)])
def test_sam_vit_matches_jax(embed, img_size, path):
    jcfg = _narrow(jax_vit, embed, img_size)
    params = _randomise(jax.tree_util.tree_map(
        np.asarray, jax_vit.init_sam_vit(jax.random.PRNGKey(0), jcfg)), 7)
    x = np.random.default_rng(3).standard_normal(
        (1, img_size, img_size, 3)).astype(np.float32)
    kernels = path == "kernel"
    jcfg = dataclasses.replace(jcfg, use_flash_attention=kernels,
                               flash_interpret=kernels)
    want = np.asarray(jax_vit.sam_vit_apply(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), jcfg))

    cfg = dataclasses.replace(_narrow(vit_sam, embed, img_size),
                              use_flash_attention=kernels)
    model = vit_sam.SamViT(cfg)
    model.load_state_dict(params_from_numpy(params), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, img_size // 16, img_size // 16, 256)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def _fused_geometry(mod, geometry: str):
    if geometry == "ws2_img48":  # JAX's test_vit_fused_window_blocks_matches_dense
        return mod.SamViTConfig(img_size=48, patch_size=16, embed_dim=32,
                                depth=2, num_heads=2, window_size=2,
                                global_attn_indexes=(), neck_dim=32)
    embed, img_size = {"ws14_embed128_img256": (128, 256),
                       "ws14_embed160_img384": (160, 384)}[geometry]
    return _narrow(mod, embed, img_size)


@pytest.mark.parametrize("flash", ["flash_on", "flash_off"])
@pytest.mark.parametrize("geometry", ["ws2_img48", "ws14_embed128_img256",
                                      "ws14_embed160_img384"])
def test_sam_vit_fused_window_blocks_matches_jax(geometry, flash):
    """``fused_window_blocks``: the windowed blocks through
    ``windowed_attention_fused`` (K6's plain version here, JAX's strip
    kernel in interpret mode), the global blocks through K4 or the dense
    path as ``use_flash_attention`` says. Grid 3 pads to 4 (ws 2), 16 to 28
    and 24 to 28 (ws 14): pad tokens carry k = v = the qkv bias."""
    kernels = flash == "flash_on"
    jcfg = dataclasses.replace(_fused_geometry(jax_vit, geometry),
                               fused_window_blocks=True,
                               use_flash_attention=kernels,
                               flash_interpret=True)
    params = _randomise(jax.tree_util.tree_map(
        np.asarray, jax_vit.init_sam_vit(jax.random.PRNGKey(0), jcfg)), 5)
    size = jcfg.img_size
    x = np.random.default_rng(6).standard_normal(
        (1, size, size, 3)).astype(np.float32)
    want = np.asarray(jax_vit.sam_vit_apply(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), jcfg))

    cfg = dataclasses.replace(_fused_geometry(vit_sam, geometry),
                              fused_window_blocks=True,
                              use_flash_attention=kernels)
    model = vit_sam.SamViT(cfg)
    model.load_state_dict(params_from_numpy(params), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, size // 16, size // 16,
                                       cfg.neck_dim)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("path", ["kernel", "dense", "fused_window"])
def test_vit_forward_copies_no_index_from_the_host(path, monkeypatch):
    """The rel-pos gather index is a buffer of each block, made with the
    model: after a warm call, a forward runs with ``torch.from_numpy``
    raising (a per-call index built with numpy and copied to the device
    would call it)."""
    cfg = dataclasses.replace(_narrow(vit_sam, 128, 256),
                              use_flash_attention=path == "kernel",
                              fused_window_blocks=path == "fused_window")
    model = vit_sam.SamViT(cfg)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 256, 256, 3)).astype(np.float32))
    with torch.inference_mode():
        want = model(x)

        def refuse(*args, **kwargs):
            raise AssertionError("torch.from_numpy in a ViT forward")

        monkeypatch.setattr(torch, "from_numpy", refuse)
        got = model(x)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert not any(k.endswith("rel_pos_idx") for k in model.state_dict())


@pytest.mark.parametrize("size", [7, 14, 64])
def test_rel_pos_index_buffers_gather_like_jax(size):
    """A block's index buffer (window 7 or 14, or the global grid 64)
    gathers a raw table as JAX ``gather_rel_pos`` does."""
    window = 0 if size == 64 else size
    cfg = vit_sam.SamViTConfig(img_size=16 * size, embed_dim=128, depth=1,
                               num_heads=2, window_size=window or 14,
                               global_attn_indexes=(0,) if window == 0 else ())
    block = vit_sam.Block(cfg, window, torch.Generator().manual_seed(0))
    assert tuple(block.rel_pos_idx.shape) == (size, size)
    table = np.random.default_rng(size).standard_normal(
        (2 * size - 1, 64)).astype(np.float32)
    want = np.asarray(jax_vit.gather_rel_pos(jnp.asarray(table), size))
    got = vit_sam.gather_rel_pos(torch.from_numpy(table), size,
                                 block.rel_pos_idx)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", ["vit_b", "vit_l", "vit_h"])
def test_vit_presets_match_jax(variant):
    got = sam.make_config(variant, 512)
    want = jax_sam.make_config(variant, 512)
    assert got.variant == want.variant and got.encoder_tiny is None
    for f in dataclasses.fields(got.encoder_vit):
        assert getattr(got.encoder_vit, f.name) == getattr(want.encoder_vit,
                                                           f.name), f.name
    assert got.prompt.image_embedding_size == 32


def test_vit_b_weights_carry_across():
    """A JAX ViT-B tree at full width fills the port's Sam exactly
    (strict=True); pos_embed keeps its layout; both encoders agree."""
    jcfg = jax_sam.make_config("vit_b", image_size=64)
    tree = _jax_tree(jcfg)
    _randomise(tree["encoder"], 11)
    state = params_from_numpy(tree)
    pos = tree["encoder"]["pos_embed"]
    assert pos.shape == (1, 4, 4, 768)
    np.testing.assert_array_equal(state["encoder.pos_embed"].numpy(), pos)
    w = tree["encoder"]["patch_embed"]["w"]  # HWIO (16, 16, 3, 768)
    np.testing.assert_array_equal(state["encoder.patch_embed.w"].numpy(),
                                  w.transpose(3, 2, 0, 1))
    cfg = sam.make_config("vit_b", image_size=64)
    model = sam.Sam(cfg)
    model.load_state_dict(state, strict=True)

    x = np.random.default_rng(4).standard_normal((1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax_sam.encode_image(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jnp.asarray(x)))
    with torch.inference_mode():
        got = sam.encode_image(model.eval(), cfg, torch.from_numpy(x)).numpy()
    assert got.shape == (1, 4, 4, 256)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# Segmentation end to end with a narrow vit_b bundle
# ---------------------------------------------------------------------------

IMAGE_SIZE = 256


def _opts(mod):
    return mod.Options(backend=mod.Backend.cpu, allow_random_weights=True,
                       compute_dtype="float32", sam_variant="vit_b",
                       sam_image_size=IMAGE_SIZE, largest_region_object=True,
                       model_directory="no-such-directory")


def _injected_envs(fused: bool):
    """JAX and port Environments holding one narrow vit_b bundle (the
    default decoder, a 2-block encoder of width 128); with ``fused`` its
    windowed block takes the ``fused_window_blocks`` path."""
    jenc = _narrow(jax_vit, 128, IMAGE_SIZE)
    penc = _narrow(vit_sam, 128, IMAGE_SIZE)
    if fused:
        jenc = dataclasses.replace(jenc, fused_window_blocks=True,
                                   flash_interpret=True)
        penc = dataclasses.replace(penc, fused_window_blocks=True)
    jcfg = dataclasses.replace(jax_sam.make_config("vit_b", IMAGE_SIZE),
                               encoder_vit=jenc)
    tree = _jax_tree(jcfg, seed=1)
    _randomise(tree["encoder"], 13)
    je = jdl.Environment(_opts(jdl))
    jb = JaxBundle(jcfg, jax.tree_util.tree_map(jnp.asarray, tree), je.device,
                   jnp.float32)
    assert je._sam_models["vit_b"].get_or_create(lambda: jb) is jb

    cfg = dataclasses.replace(sam.make_config("vit_b", IMAGE_SIZE),
                              encoder_vit=penc)
    model = sam.Sam(cfg)
    model.load_state_dict(params_from_numpy(tree), strict=True)
    pe = pdl.Environment(_opts(pdl))
    pb = SamModelBundle(cfg, model, torch.float32)
    assert pe._sam_models["vit_b"].get_or_create(lambda: pb) is pb
    return je, pe


def _process_both(envs):
    px = np.random.default_rng(42).integers(0, 256, (200, 300, 4), dtype=np.uint8)
    js = jdl.Segmentation.process(
        jdl.Image(jdl.Extent(300, 200), jdl.Channels.rgba, px), envs[0])
    ps = pdl.Segmentation.process(
        pdl.Image(pdl.Extent(300, 200), pdl.Channels.rgba, px), envs[1])
    return js, ps


@pytest.fixture(scope="module")
def envs():
    return _injected_envs(fused=False)


@pytest.fixture(scope="module")
def segs(envs):
    return _process_both(envs)


@pytest.fixture(scope="module")
def fused_envs():
    return _injected_envs(fused=True)


@pytest.fixture(scope="module")
def fused_segs(fused_envs):
    return _process_both(fused_envs)


def _jax_logits(je, js, prompt, multimask=False, lcc=False) -> np.ndarray:
    """JAX's upsampled mask logits at the original extent, (T, H, W)."""
    bundle = je.sam_model("vit_b")
    cfg = bundle.cfg
    is_region = isinstance(prompt, jdl.Region)
    points, labels = js._prompt_arrays(None if is_region else prompt,
                                       prompt if is_region else None)
    masks, _ = jax_sam.decode_masks(bundle.params, cfg, js.embedding,
                                    jnp.asarray(points), jnp.asarray(labels),
                                    multimask=multimask)
    if multimask:
        masks = masks[:, 1:4]
    if lcc:
        masks = jnp.where(jax.vmap(jax.vmap(jax_lcc))(masks > 0), masks, -10.0)
    h, w = js.extent.height, js.extent.width
    logits = jax_upsample(masks, pick_bucket(js.extent), cfg.image_size, h, w,
                          js._crop[0], js._crop[1])
    return np.asarray(logits[0])[:, :h, :w]


def _assert_mask_matches(got: np.ndarray, want: np.ndarray, logits):
    assert got.shape == want.shape and got.dtype == np.uint8
    flips = got[..., 0] != want[..., 0]
    if flips.any():
        near = np.abs(logits()[flips]) <= NEAR_ZERO
        assert near.all(), (f"{int(flips.sum())} pixels flipped, "
                            f"{int((~near).sum())} where JAX's logit is not "
                            f"within {NEAR_ZERO} of zero")


def test_vit_embedding_matches_jax(segs):
    js, ps = segs
    want = np.asarray(js.embedding)
    assert ps.embedding.shape == want.shape == (1, 16, 16, 256)
    np.testing.assert_allclose(ps.embedding.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["point", "region", "multimask", "batch"])
def test_vit_masks_match_jax(envs, segs, kind):
    je = envs[0]
    js, ps = segs
    if kind == "point":
        _assert_mask_matches(
            ps.compute_mask(pdl.Point(150, 100)).pixels,
            js.compute_mask(jdl.Point(150, 100)).pixels,
            lambda: _jax_logits(je, js, jdl.Point(150, 100))[0])
    elif kind == "region":
        jr = jdl.Region(jdl.Point(40, 30), jdl.Point(250, 170))
        got = ps.compute_mask(pdl.Region(pdl.Point(40, 30),
                                         pdl.Point(250, 170))).pixels
        _assert_mask_matches(got, js.compute_mask(jr).pixels,
                             lambda: _jax_logits(je, js, jr, lcc=True)[0])
    elif kind == "multimask":
        got = ps.compute_masks(pdl.Point(80, 60))
        want = js.compute_masks(jdl.Point(80, 60))
        assert len(got) == 3
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_mask_matches(
                g.image.pixels, w.image.pixels,
                lambda i=i: _jax_logits(je, js, jdl.Point(80, 60),
                                        multimask=True)[i])
            assert abs(g.accuracy - w.accuracy) <= 1e-4
    else:
        jp = [jdl.Point(20, 20), jdl.Region(jdl.Point(10, 10),
                                            jdl.Point(200, 150))]
        pp = [pdl.Point(20, 20), pdl.Region(pdl.Point(10, 10),
                                            pdl.Point(200, 150))]
        got, want = ps.compute_mask_batch(pp), js.compute_mask_batch(jp)
        assert len(got) == 2
        for g, w, prompt in zip(got, want, jp):
            _assert_mask_matches(
                g.image.pixels, w.image.pixels,
                lambda prompt=prompt: _jax_logits(
                    je, js, prompt, lcc=isinstance(prompt, jdl.Region))[0])
            assert abs(g.accuracy - w.accuracy) <= 1e-4


def test_fused_window_vit_embedding_matches_jax(fused_segs):
    js, ps = fused_segs
    want = np.asarray(js.embedding)
    assert ps.embedding.shape == want.shape == (1, 16, 16, 256)
    np.testing.assert_allclose(ps.embedding.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["point", "region", "multimask"])
def test_fused_window_vit_masks_match_jax(fused_envs, fused_segs, kind):
    """Masks of the fused-window bundle byte for byte, a flipped pixel
    allowed only where JAX's logit is within 1e-4 of zero."""
    je = fused_envs[0]
    js, ps = fused_segs
    if kind == "point":
        _assert_mask_matches(
            ps.compute_mask(pdl.Point(150, 100)).pixels,
            js.compute_mask(jdl.Point(150, 100)).pixels,
            lambda: _jax_logits(je, js, jdl.Point(150, 100))[0])
    elif kind == "region":
        jr = jdl.Region(jdl.Point(40, 30), jdl.Point(250, 170))
        got = ps.compute_mask(pdl.Region(pdl.Point(40, 30),
                                         pdl.Point(250, 170))).pixels
        _assert_mask_matches(got, js.compute_mask(jr).pixels,
                             lambda: _jax_logits(je, js, jr, lcc=True)[0])
    else:
        got = ps.compute_masks(pdl.Point(80, 60))
        want = js.compute_masks(jdl.Point(80, 60))
        assert len(got) == 3
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_mask_matches(
                g.image.pixels, w.image.pixels,
                lambda i=i: _jax_logits(je, js, jdl.Point(80, 60),
                                        multimask=True)[i])


def test_unknown_variant_is_refused():
    opts = _opts(pdl)
    opts.sam_variant = "vit_q"
    with pytest.raises(pdl.DlimgError, match="Unknown SAM variant"):
        pdl.Environment(opts)
