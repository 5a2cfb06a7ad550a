"""The port's BiRefNet slice against the JAX package, on the CPU, in float32,
all inputs from numpy seeds and every weight a JAX tree carried across by
``params_from_numpy``:

  * the Swin relative-position index and shift masks, equal exactly
    (windows 4 and 7, padded grids), a plain and a shifted Swin block at
    sizes the window does not divide, patch merging at odd sizes: atol
    1e-5;
  * ``deform_conv2d`` at kernel sizes 1, 3 and 7, offsets reaching past
    the image edge, with and without bias, and the int8 corner stack;
    the corner-stack sampling against the four-gather form: atol 1e-4
    (the JAX suite's deform tolerance, tests/test_birefnet_parity.py);
  * ``resize_align_corners``, ``_get_patches`` (exact), ``_head_fold``,
    one ASPP and one decoder block with seeded nonzero offset and
    modulator convs and biases: atol 1e-4;
  * ``birefnet_apply`` on the slim configuration of
    runtime/birefnet.py::slim_config with nonzero offset, modulator and
    bias weights: atol 1e-4, rtol 1e-4;
  * the golden gate: ``segment_objects`` reproduces
    tests/goldens/mask_birefnet.npy within 1 quantum (the call of
    tests/test_goldens.py::test_golden_birefnet: slim, resolution 64,
    float32, JAX's seed-0 ``init_birefnet`` tree placed in the port's
    environment as its general bundle);
  * the host's box-filter ``resize_mask`` (through the filter's nonzero
    taps) within 1 quantum of JAX's;
  * a tree without the biases JAX treats as optional (a decoder block's
    and the head fold's ``conv_out``, the head, a deform conv) loads and
    matches JAX within the forward's tolerance; a missing weight raises;
  * kind escalation, the bundle preference order, the sha256 pin,
    ``ModelNotFoundError``, the int8 option, and the TF32 repair (the
    port's float32 convolutions run at full precision whatever the
    caller's flags, which are left as they were; a second thread that
    reads and writes the flags during a call).
"""

import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlimgedit_tpu_torch as pdl
from dlimgedit_tpu.models import birefnet as jbn
from dlimgedit_tpu.models import swin as jswin
from dlimgedit_tpu.ops import deform as jdeform
from dlimgedit_tpu_torch.convert.from_numpy import params_from_numpy
from dlimgedit_tpu_torch.models import birefnet as bn
from dlimgedit_tpu_torch.models import swin
from dlimgedit_tpu_torch.models.common import full_precision
from dlimgedit_tpu_torch.ops import deform
from dlimgedit_tpu_torch.ops.postprocess import sigmoid_to_u8
from dlimgedit_tpu_torch.runtime import birefnet as rbn

torch.set_num_threads(2)

GOLDEN = Path(__file__).parent / "goldens" / "mask_birefnet.npy"


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _load(module, tree):
    module.load_state_dict(params_from_numpy(tree), strict=True)
    return module


def _randomise(tree, seed: int, offset_std: float = 2.0):
    """``models/birefnet.py::nonzero_init`` over a JAX tree: seeded nonzero
    offset and modulator convs (offset biases of `offset_std` pixels reach
    past the edge of small maps), biases, rel-pos tables and LayerNorms."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        a = np.asarray(node)
        v = bn.nonzero_init(path, a.shape, rng, offset_weight_std=0.1,
                            offset_bias_std=offset_std)
        return a if v is None else v

    return walk(tree, ())


def _slim_jax_cfg(resolution: int) -> jbn.BiRefNetConfig:
    return jbn.BiRefNetConfig(
        img_size=resolution,
        swin_cfg=jswin.SwinConfig(embed_dim=16, depths=(1, 1, 1, 1),
                                  num_heads=(2, 2, 2, 2), window=4),
        dec_inter_channels=8, aspp_channelster=12, gdt_channels=4,
        aspp_kernel_sizes=(1, 3))


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# Swin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,pH,pW,shift", [(4, 8, 12, 2), (7, 14, 21, 3),
                                                (7, 70, 56, 3), (4, 4, 4, 2)])
def test_swin_index_and_shift_mask_equal_jax(window, pH, pW, shift):
    idx = swin._rel_pos_index(window, torch.device("cpu"))
    np.testing.assert_array_equal(idx.numpy(), jswin._rel_pos_index(window))
    mask = swin._shift_attn_mask(pH, pW, window, shift, torch.device("cpu"))
    want = jswin._shift_attn_mask(pH, pW, window, shift)
    assert mask.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy(), want)


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("H,W", [(10, 13), (7, 7)])
def test_swin_block_matches_jax(H, W, shift):
    dim, heads, window = 32, 2, 7
    tree = _randomise(_tree(jswin._init_block(jax.random.PRNGKey(1), dim, heads,
                                              window, 4.0, jnp.float32)), 5)
    x = _x((1, H, W, dim), 2)
    want = np.asarray(jswin._swin_block(_jnp(tree), jnp.asarray(x), heads,
                                        window, shift, 1e-5))
    block = _load(swin.SwinBlock(dim, heads, window, 4.0,
                                 torch.Generator().manual_seed(0)), tree)
    got = swin._swin_block(block, torch.from_numpy(x), heads, window, shift,
                           1e-5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("H,W", [(7, 9), (8, 5), (6, 6)])
def test_patch_merge_matches_jax(H, W):
    dim = 12
    jtree = _randomise(_tree(jswin.init_swin(
        jax.random.PRNGKey(0), jswin.SwinConfig(embed_dim=dim, depths=(1, 1, 1, 1),
                                                num_heads=(1, 1, 1, 1), window=4))
    ["stages"][0]["downsample"]), 3)
    x = _x((2, H, W, dim), 4)
    want = np.asarray(jswin._patch_merge(_jnp(jtree), jnp.asarray(x), 1e-5))
    merge = _load(swin._PatchMerge(dim, torch.Generator().manual_seed(0)), jtree)
    got = swin._patch_merge(merge, torch.from_numpy(x), 1e-5).numpy()
    assert got.shape == (2, (H + 1) // 2, (W + 1) // 2, 2 * dim)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Deformable convolution
# ---------------------------------------------------------------------------

def _deform_inputs(ks, seed, H=9, W=11, C=6, O=5):
    K = ks * ks
    x = _x((1, H, W, C), seed)
    offset = _x((1, H, W, 2 * K), seed + 1, scale=3.0)  # past the edges
    mask = np.random.default_rng(seed + 2).uniform(0, 2, (1, H, W, K)
                                                    ).astype(np.float32)
    w = _x((ks, ks, C, O), seed + 3, scale=0.3)  # HWIO
    b = _x((O,), seed + 4)
    return x, offset, mask, w, b


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("ks", [1, 3, 7])
def test_deform_conv2d_matches_jax(ks, with_bias, int8):
    x, offset, mask, w, b = _deform_inputs(ks, 10 * ks)
    assert (offset.min() < -3) and (offset.max() > 3)
    pad = ks // 2
    want = np.asarray(jdeform.deform_conv2d(
        jnp.asarray(x), jnp.asarray(offset), jnp.asarray(mask), jnp.asarray(w),
        jnp.asarray(b) if with_bias else None, padding=pad, int8_gather=int8))
    got = deform.deform_conv2d(
        torch.from_numpy(x), torch.from_numpy(offset), torch.from_numpy(mask),
        torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(b) if with_bias else None, padding=pad,
        int8_gather=int8).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_deform_int8_stack_and_stacked_sampling_match_jax():
    """The int8 corner stack equals JAX's bit for bit (scale on the device);
    the one-gather sampling equals the four-gather form (atol 1e-5) and
    JAX's, with positions far off the image on every side."""
    x = _x((2, 5, 7, 3), 1)
    for int8 in (False, True):
        stack, dims, scale = deform._corner_stack(torch.from_numpy(x), int8)
        jstack, jdims, jscale = jdeform._corner_stack(jnp.asarray(x), int8)
        assert dims == jdims
        np.testing.assert_array_equal(stack.numpy(), np.asarray(jstack))
        if int8:
            assert scale.dim() == 0
            np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    rng = np.random.default_rng(2)
    py = rng.uniform(-3, 8, (2, 6, 4)).astype(np.float32)
    px = rng.uniform(-3, 10, (2, 6, 4)).astype(np.float32)
    info = deform._corner_stack(torch.from_numpy(x))
    got = deform._bilinear_sample_stacked(info, torch.from_numpy(py),
                                          torch.from_numpy(px), 3, torch.float32)
    ref = deform._bilinear_sample(torch.from_numpy(x), torch.from_numpy(py),
                                  torch.from_numpy(px))
    want = jdeform._bilinear_sample(jnp.asarray(x), jnp.asarray(py),
                                    jnp.asarray(px))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), atol=1e-5)


def test_deform_int8_gather_bounded_deviation():
    """The int8 corner stack deviates from the exact conv by < 2% of the
    output range (the JAX suite's bound for Options.birefnet_int8_deform)."""
    x, offset, mask, w, b = _deform_inputs(3, 0, H=14, W=15, C=24, O=20)
    args = [torch.from_numpy(a) for a in (x, offset, mask)]
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    exact = deform.deform_conv2d(*args, wt, torch.from_numpy(b), padding=1)
    q = deform.deform_conv2d(*args, wt, torch.from_numpy(b), padding=1,
                             int8_gather=True)
    dev = ((exact - q).abs().max() / exact.abs().max()).item()
    assert 0 < dev < 0.02, dev


# ---------------------------------------------------------------------------
# Decoder pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((5, 7), (11, 3)), ((1, 4), (3, 1)),
                                     ((16, 16), (64, 48))])
def test_resize_align_corners_matches_jax(src, dst):
    x = _x((2, *src, 3), 6)
    want = np.asarray(jbn.resize_align_corners(jnp.asarray(x), dst))
    np.testing.assert_array_equal(
        bn._ac_matrix(dst[0], src[0], torch.device("cpu")).numpy(),
        jbn._ac_matrix(dst[0], src[0]))
    got = bn.resize_align_corners(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_get_patches_matches_jax():
    x = _x((1, 16, 16, 3), 7)
    for tile in (2, 4, 8):
        np.testing.assert_array_equal(
            bn._get_patches(torch.from_numpy(x), tile).numpy(),
            np.asarray(jbn._get_patches(jnp.asarray(x), tile)))


@pytest.fixture(scope="module")
def slim():
    """JAX's slim tree (seed 0) with nonzero offsets, modulators and
    biases, the port's model carrying it, and both forwards on one
    seeded normalised image at resolution 64."""
    jcfg = _slim_jax_cfg(64)
    tree = _randomise(_tree(jbn.init_birefnet(jax.random.PRNGKey(0), jcfg)), 11)
    cfg = rbn.slim_config(64, False)
    model = _load(bn.BiRefNet(cfg), tree)
    x = _x((1, 64, 64, 3), 12)
    want = np.asarray(jbn.birefnet_apply(_jnp(tree), jnp.asarray(x), jcfg))
    with torch.inference_mode():
        got = bn.birefnet_apply(model, torch.from_numpy(x), cfg).numpy()
    return dict(jcfg=jcfg, tree=tree, cfg=cfg, model=model, x=x, want=want,
                got=got)


def test_params_from_numpy_carries_the_birefnet_tree(slim):
    """Every leaf of the JAX tree reaches the port's model: 4-D leaves named
    w as OIHW, everything else (qkv.w, reduction.w, rel_bias) as is."""
    from dlimgedit_tpu_torch.utils.pytree_io import flatten_tree

    state = slim["model"].state_dict()
    flat = flatten_tree(slim["tree"])
    assert set(state) == {k.replace("/", ".") for k in flat}
    for path, a in flat.items():
        want = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a
        np.testing.assert_array_equal(state[path.replace("/", ".")].numpy(), want)
    block = "backbone.stages.0.blocks.0."
    assert state[block + "qkv.w"].shape == (16, 48)
    assert state[block + "rel_bias"].shape == (49, 2)
    assert state["backbone.stages.0.downsample.reduction.w"].shape == (64, 32)


def test_head_fold_matches_jax(slim):
    tree = slim["tree"]["decoder"]
    p = _x((1, 16, 16, slim["cfg"].channels[3] // 2), 13)
    x = slim["x"]
    want = np.asarray(jbn._head_fold(_jnp(tree), jnp.asarray(p), jnp.asarray(x),
                                     (64, 64)))
    got = bn._head_fold(slim["model"].decoder, torch.from_numpy(p),
                        torch.from_numpy(x), (64, 64)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("part", ["aspp", "dec_blk"])
def test_aspp_and_dec_block_match_jax(slim, part):
    jcfg, cfg = slim["jcfg"], slim["cfg"]
    jtree = slim["tree"]["decoder"]["dec2"]
    blk = slim["model"].decoder.dec2
    if part == "aspp":
        x = _x((1, 8, 8, cfg.dec_inter_channels), 14)
        want = jbn._apply_aspp(_jnp(jtree["aspp"]), jnp.asarray(x), jcfg)
        got = bn._apply_aspp(blk.aspp, torch.from_numpy(x), cfg)
    else:
        x = _x((1, 8, 8, blk.conv_in.w.shape[1]), 15)
        want = jbn._apply_dec_blk(_jnp(jtree), jnp.asarray(x), jcfg)
        got = bn._apply_dec_blk(blk, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_birefnet_apply_matches_jax(slim):
    """The whole slim forward, nonzero offsets and modulators: every
    decoder level's deform samples off the grid and past its edges."""
    got, want = slim["got"], slim["want"]
    assert got.shape == want.shape == (1, 64, 64, 1)
    assert want.std() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    u8 = sigmoid_to_u8(torch.from_numpy(got)).numpy().astype(np.int32)
    ju8 = np.floor(np.asarray(jax.nn.sigmoid(want)) * 255).astype(np.int32)
    assert np.abs(u8 - ju8).max() <= 1


def test_a_tree_without_optional_biases_loads_and_matches_jax(slim):
    """JAX reads a conv's "b" only where the tree holds it (``_conv``, the
    deform conv, the head fold's ``conv_out`` and ``head``), and its
    converter leaves it out of a checkpoint without one: such a tree
    loads into the port (``load_into``) and gives JAX's logits, within
    this file's forward tolerance. A missing weight, and the ASPP
    projection's bias (which JAX reads unconditionally), still raise."""
    import copy

    from dlimgedit_tpu_torch.convert.from_numpy import load_into

    tree = copy.deepcopy(slim["tree"])
    dec = tree["decoder"]
    for node in (dec["dec2"]["conv_out"], dec["ipt_blk1"]["conv_out"],
                 dec["head"], dec["dec3"]["aspp"]["aspp1"]["conv"]):
        del node["b"]
    model = load_into(bn.BiRefNet(slim["cfg"]), tree)
    assert not hasattr(model.decoder.head, "b")
    assert hasattr(model.decoder.dec1.conv_out, "b")
    want = np.asarray(jbn.birefnet_apply(_jnp(tree), jnp.asarray(slim["x"]),
                                         slim["jcfg"]))
    assert np.abs(want - slim["want"]).max() > 1e-3  # the biases mattered
    with torch.inference_mode():
        got = bn.birefnet_apply(model, torch.from_numpy(slim["x"]),
                                slim["cfg"]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    for drop in (("dec2", "conv_out", "w"), ("dec2", "aspp", "proj", "b")):
        bad = copy.deepcopy(slim["tree"])
        node = bad["decoder"]
        for k in drop[:-1]:
            node = node[k]
        del node[drop[-1]]
        with pytest.raises(RuntimeError, match="Missing key"):
            load_into(bn.BiRefNet(slim["cfg"]), bad)


def test_birefnet_forward_copies_nothing_from_the_host(slim, monkeypatch):
    """The index, masks and resize matrices are made with device ops (their
    caches emptied first), so a forward builds no tensor from host data."""
    for cached in (swin._rel_pos_index, swin._shift_attn_mask, bn._ac_matrix):
        cached.cache_clear()

    def refuse(*a, **k):
        raise AssertionError("a forward made a tensor from host data")

    monkeypatch.setattr(torch, "from_numpy", refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    with torch.inference_mode():
        x = torch.zeros((1, 64, 64, 3)) + 0.5
        out = bn.birefnet_apply(slim["model"], x, slim["cfg"])
    assert out.shape == (1, 64, 64, 1)


@pytest.mark.parametrize("S,w,h", [(64, 96, 64), (64, 33, 70), (256, 300, 200),
                                   (128, 1, 1), (100, 2, 3000)])
def test_resize_mask_matches_jax(S, w, h):
    """The host box-filter resize back to the extent, through the filter's
    nonzero taps, within 1 grey level of the JAX package's dense products
    (the BiRefNet mask's contract: the sums' order may move an exact .5)."""
    from dlimgedit_tpu.image.resize import resize_mask as jax_resize_mask
    from dlimgedit_tpu.types import Channels as JC, Extent as JE, ImageView as JV
    from dlimgedit_tpu_torch.image.resize import resize_mask

    m = np.random.default_rng(S + w).integers(0, 256, (S, S), dtype=np.uint8)
    got = resize_mask(pdl.ImageView.from_array(m, pdl.Channels.mask),
                      pdl.Extent(w, h))
    want = jax_resize_mask(JV.from_array(m, JC.mask), JE(w, h))
    assert got.dtype == np.uint8 and got.shape == (h, w)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


# ---------------------------------------------------------------------------
# The slice through segment_objects
# ---------------------------------------------------------------------------

@pytest.fixture
def slim_env(monkeypatch):
    monkeypatch.setenv("DLIMG_BIREFNET_TEST_SLIM", "1")
    monkeypatch.setenv("DLIMG_BIREFNET_RESOLUTION", "64")
    return pdl.Environment(pdl.Options(backend=pdl.Backend.cpu,
                                       allow_random_weights=True,
                                       compute_dtype="float32"))


def _golden_image():
    rng = np.random.default_rng(42)
    return pdl.Image(pdl.Extent(96, 64), pdl.Channels.rgba,
                     rng.integers(0, 256, (64, 96, 4), dtype=np.uint8))


def test_segment_objects_reproduces_the_golden(slim_env):
    """tests/test_goldens.py::test_golden_birefnet's call on the port: JAX's
    seed-0 slim tree as the general bundle, within 1 quantum."""
    cfg = rbn.slim_config(64, False)
    tree = _tree(jbn.init_birefnet(jax.random.PRNGKey(0), _slim_jax_cfg(64)))
    model = _load(bn.BiRefNet(cfg), tree)
    slim_env._birefnet_models["general"].get_or_create(
        lambda: rbn.BiRefNetBundle(cfg, model, torch.float32, 64))
    mask = pdl.segment_objects(_golden_image(), slim_env)
    assert mask.channels == pdl.Channels.mask
    got = np.asarray(mask.pixels).squeeze()
    want = np.load(GOLDEN)
    assert got.shape == want.shape == (64, 96)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, (diff.max(), int((diff > 0).sum()))
    assert list(slim_env.executables) == [("birefnet", "general", 256)]


def test_segment_objects_escalates_kind_above_1536(slim_env):
    img = pdl.Image(pdl.Extent(1600, 40), pdl.Channels.rgb,
                    np.random.default_rng(1).integers(0, 256, (40, 1600, 3),
                                                      dtype=np.uint8))
    mask = pdl.segment_objects(img, slim_env)
    assert mask.pixels.shape == (40, 1600, 1)
    assert mask.pixels.dtype == np.uint8
    assert list(slim_env.executables) == [("birefnet", "high_res", 2048)]
    assert slim_env._birefnet_models["high_res"].created
    assert not slim_env._birefnet_models["general"].created
    with pytest.raises(pdl.DlimgError, match="kind"):
        slim_env.birefnet_model("huge")


@pytest.mark.parametrize("kind,first,second", [
    ("general", "birefnet_general.npz", "birefnet_hr.npz"),
    ("high_res", "birefnet_hr.npz", "birefnet_general.npz")])
def test_bundle_preference_order(tmp_path, monkeypatch, kind, first, second):
    """A kind's own bundle first, the other kind's as fallback (the
    loader is stopped at the path it picked)."""
    seg = tmp_path / "segmentation"
    seg.mkdir()
    env = pdl.Environment(pdl.Options(backend=pdl.Backend.cpu,
                                      model_directory=str(tmp_path)))
    picked = []

    def record(path):
        picked.append(path.name)
        raise RuntimeError("stop")

    monkeypatch.setattr(env, "_verified_load", record)
    (seg / second).write_bytes(b"")
    with pytest.raises(RuntimeError, match="stop"):
        rbn.load_birefnet(env, kind)
    (seg / first).write_bytes(b"")
    with pytest.raises(RuntimeError, match="stop"):
        rbn.load_birefnet(env, kind)
    assert picked == [second, first]


def test_sha256_pin_and_missing_model(tmp_path):
    seg = tmp_path / "segmentation"
    seg.mkdir()
    env = pdl.Environment(pdl.Options(backend=pdl.Backend.cpu,
                                      model_directory=str(tmp_path)))
    with pytest.raises(pdl.ModelNotFoundError, match="BiRefNet"):
        env.birefnet_model("general")
    bundle = seg / "birefnet_general.npz"
    np.savez(bundle, x=np.zeros(3, np.float32))
    (seg / "birefnet_general.npz.sha256").write_text("0" * 64 + "\n")
    with pytest.raises(pdl.DlimgError, match="integrity"):
        pdl.Environment(pdl.Options(backend=pdl.Backend.cpu,
                                    model_directory=str(tmp_path))
                        ).birefnet_model("general")


def test_int8_deform_option_reaches_the_config(monkeypatch):
    monkeypatch.setenv("DLIMG_BIREFNET_TEST_SLIM", "1")
    monkeypatch.setenv("DLIMG_BIREFNET_RESOLUTION", "64")
    for on in (False, True):
        env = pdl.Environment(pdl.Options(
            backend=pdl.Backend.cpu, allow_random_weights=True,
            compute_dtype="float32", birefnet_int8_deform=on))
        bundle = env.birefnet_model("general")
        assert bundle.cfg.deform_int8_gather is on
        assert bundle.cfg.img_size == bundle.resolution == 64
        assert bundle.cfg.swin.embed_dim == 16


def _precision_flags():
    b = torch.backends
    return (b.cudnn.conv.fp32_precision, b.cuda.matmul.fp32_precision,
            b.mkldnn.matmul.fp32_precision, b.mkldnn.conv.fp32_precision)


def test_float32_convolutions_run_at_full_precision(slim_env, monkeypatch):
    """With the caller's TF32 flags on (cuDNN's default, and the matmul
    ones set), every convolution of a segment_objects call runs with them
    off, and the caller's flags are as they were afterwards."""
    torch.backends.cudnn.allow_tf32 = True
    monkeypatch.setattr(torch.backends.cuda.matmul, "fp32_precision", "tf32")
    monkeypatch.setattr(torch.backends.mkldnn.matmul, "fp32_precision", "bf16")
    before = _precision_flags()
    assert before == ("tf32", "tf32", "bf16", "none")
    seen = []
    conv2d = torch.nn.functional.conv2d

    def recording(*a, **k):
        seen.append(_precision_flags())
        return conv2d(*a, **k)

    monkeypatch.setattr(torch.nn.functional, "conv2d", recording)
    pdl.segment_objects(_golden_image(), slim_env)
    assert len(seen) > 40
    assert set(seen) == {("ieee",) * 4}
    assert _precision_flags() == before
    with full_precision():
        with full_precision():
            assert _precision_flags() == ("ieee",) * 4
        assert _precision_flags() == ("ieee",) * 4
    assert _precision_flags() == before


def test_precision_scope_and_a_second_thread(slim_env, monkeypatch):
    """The scope's flags are process-wide. While a segment_objects call is
    inside it, a second thread reads the legacy flags (False, without
    PyTorch's mixed-flags error) and sets cuBLAS's TF32 on: that write
    stands after the call, and every flag it did not write is the
    caller's again."""
    b = torch.backends
    saved = (b.cuda.matmul.fp32_precision, b.mkldnn.matmul.fp32_precision,
             torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    before = _precision_flags()
    inside, written, seen = threading.Event(), threading.Event(), {}
    conv2d = torch.nn.functional.conv2d

    def first_conv_waits(*a, **k):
        if not inside.is_set():
            inside.set()
            assert written.wait(60)
        return conv2d(*a, **k)

    def other_thread():
        try:
            assert inside.wait(60)
            seen["read"] = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
                            torch.get_float32_matmul_precision())
            b.cuda.matmul.allow_tf32 = True
        except Exception as e:  # reported below
            seen["error"] = e
        finally:
            written.set()

    monkeypatch.setattr(torch.nn.functional, "conv2d", first_conv_waits)
    t = threading.Thread(target=other_thread)
    t.start()
    try:
        pdl.segment_objects(_golden_image(), slim_env)
        t.join(60)
        assert "error" not in seen, seen
        assert seen["read"] == (False, False, "highest")
        assert b.cuda.matmul.allow_tf32 is True
        assert b.cudnn.allow_tf32 is True
        assert _precision_flags() == ("tf32",) * 2 + before[2:]
        assert b.cudnn.rnn.fp32_precision == "tf32"
    finally:
        t.join(60)
        torch.set_float32_matmul_precision(saved[2])
        b.cuda.matmul.fp32_precision, b.mkldnn.matmul.fp32_precision = saved[:2]
