"""The port's int8 quantisation (ops/quant.py, models/common.py QuantLinear
and cast_tree, the Environment's quantised bundles) against the JAX
package's, on the CPU, all inputs from numpy seeds:

  * ``quantize_weight``, ``quantize_activations_int8`` and ``int8_linear``
    bit for bit, in float32 and bf16, at a TinyViT width (320 -> 960) and
    a ViT width (768 -> 3072); the weight-only ``linear`` within atol 1e-4
    in float32 (the float32 product's summation order);
  * ``quantize_encoder`` swaps exactly the modules JAX's walk quantises
    (MobileSAM and a narrow ViT-B; ``reproj`` and ``proj_out`` stay);
  * ``w_scale`` stays float32 in a bf16 bundle, scales are those of the
    float32 weights, and a JAX-quantised tree loads ``strict=True``;
  * the slice end to end: ``Environment(quantize_encoder=...,
    quantize_activations=...)`` on ``Backend.cpu`` for MobileSAM (from a
    model directory) and a narrow ViT-B (an injected bundle), against
    JAX's Environment. Under w8 the embedding within atol 1e-4, masks
    byte for byte (a flip only where JAX's logit is within 1e-4 of 0).

Under w8a8 the comparison of whole embeddings is made so. Both packages'
activation quanta are recorded at every quantised linear (JAX's through
an ordered ``jax.debug.callback`` in its jitted program). A quantum may
differ only at a rounding tie: the two float32 paths (LayerNorms,
attention, convs) give inputs a few ulps apart, so where ``x / scale``
lies within ``TIE`` (1e-3) of a .5 the two round to neighbouring
integers. Each differing quantum must be such a tie flip, |dq| = 1, and
the flips must stay rare (at most 1e-3 of the quanta). One flip moves
one product term by a whole quantum, and the layers after it amplify
that (with random weights a single flip at 256 px spreads to a quarter
of the later quanta), so the port continues from JAX's quanta: each of
its linears uses the recorded JAX quanta and scales after counting its
own flips. The bound those flips imply is then that of the float32 noise
alone: the embedding within atol 1e-4, masks as under w8. With no flip at
all the port's own quanta are JAX's, and its unaltered embedding is held
to the same bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import dlimgedit_tpu as jdl
import dlimgedit_tpu_torch as pdl
from dlimgedit_tpu.models import sam as jax_sam
from dlimgedit_tpu.models import vit_sam as jax_vit
from dlimgedit_tpu.models.common import linear as jax_linear
from dlimgedit_tpu.ops import quant as jq
from dlimgedit_tpu.ops.postprocess import upsample_mask_logits as jax_upsample
from dlimgedit_tpu.ops.preprocess import pick_bucket
from dlimgedit_tpu.runtime.environment import SamModelBundle as JaxBundle
from dlimgedit_tpu.utils.pytree_io import flatten_tree, save_pytree
from dlimgedit_tpu_torch.convert.from_numpy import load_into, params_from_numpy
from dlimgedit_tpu_torch.models import sam, vit_sam
from dlimgedit_tpu_torch.models.common import Linear, QuantLinear, cast_tree, linear
from dlimgedit_tpu_torch.ops import quant as pq
from dlimgedit_tpu_torch.runtime.environment import SamModelBundle

torch.set_num_threads(2)

NEAR_ZERO = 1e-4
TIE = 1e-3
MAX_FLIP_SHARE = 1e-3
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
WIDTHS = [(320, 960), (768, 3072)]


def _linear_inputs(K, N, seed, spread=True):
    """w, b, x; with ``spread`` the rows of x span a 40x range of
    magnitudes and one is zero (the 1e-8 floor of its scale)."""
    rng = np.random.default_rng(seed)
    w = (0.05 * rng.standard_normal((K, N))).astype(np.float32)
    b = (0.1 * rng.standard_normal(N)).astype(np.float32)
    x = rng.standard_normal((3, 67, K)).astype(np.float32)
    if spread:
        x[1, 5] = 0.0
        x[2] *= 40.0
    return w, b, x


def _both(a: np.ndarray, dtype: str):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    return np.asarray(a.astype(jnp.float32) if jnp.issubdtype(
        a.dtype, jnp.floating) else a)


def _assert_bits(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.array_equal(got, want), f"{int((got != want).sum())} elements differ"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K,N", WIDTHS)
def test_quantize_weight_bit_equal_to_jax(K, N, dtype):
    w, _, _ = _linear_inputs(K, N, 0)
    tw, jw = _both(w, dtype)
    (pw_q, ps), (jw_q, js) = pq.quantize_weight(tw), jq.quantize_weight(jw)
    assert pw_q.dtype == torch.int8 and ps.dtype == torch.float32
    _assert_bits(pw_q, jw_q)
    _assert_bits(ps, js)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K,N", WIDTHS)
def test_quantize_activations_bit_equal_to_jax(K, N, dtype):
    _, _, x = _linear_inputs(K, N, 1)
    tx, jx = _both(x, dtype)
    (pq_x, ps), (jq_x, js) = (pq.quantize_rows_int8(tx),
                              jq.quantize_activations_int8(jx))
    assert pq_x.dtype == torch.int8 and ps.shape == (3, 67, 1)
    _assert_bits(pq_x, jq_x)
    _assert_bits(ps, js)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K,N", WIDTHS)
def test_int8_linear_bit_equal_to_jax(K, N, dtype):
    w, b, x = _linear_inputs(K, N, 2)
    jw_q, js = jq.quantize_weight(jnp.asarray(w))
    tb, jb = _both(b, dtype)
    tx, jx = _both(x, dtype)
    lin = QuantLinear(torch.from_numpy(np.array(jw_q)),
                      torch.from_numpy(np.array(js)), tb, act_int8=True)
    want = jq.int8_linear({"w_q8": jw_q, "w_scale": js, "b": jb}, jx)
    got = linear(lin, tx)
    assert got.dtype == tx.dtype and got.is_contiguous()
    _assert_bits(got, want)
    # Without a bias: the epilogue alone.
    del lin.b
    _assert_bits(linear(lin, tx), jq.int8_linear({"w_q8": jw_q, "w_scale": js}, jx))


@pytest.mark.parametrize("K,N", WIDTHS)
def test_weight_only_linear_matches_jax(K, N):
    w, b, x = _linear_inputs(K, N, 3, spread=False)
    jw_q, js = jq.quantize_weight(jnp.asarray(w))
    lin = QuantLinear(torch.from_numpy(np.array(jw_q)),
                      torch.from_numpy(np.array(js)), torch.from_numpy(b))
    want = jax_linear({"w_q": jw_q, "w_scale": js, "b": jnp.asarray(b)},
                      jnp.asarray(x))
    got = linear(lin, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    # Dequantised once in float32, rounded once to the dtype.
    deq = pq.dequantize_weight(lin.w_q, lin.w_scale, torch.bfloat16)
    _assert_bits(deq, jq.dequantize_weight(jw_q, js, jnp.bfloat16))


@pytest.mark.parametrize("M", [1, 4, 16])
def test_padded_int8_product_equals_the_unpadded_one(M):
    """The card pads fewer than 17 rows with zero rows for cuBLASLt's int8
    product and slices back (``int8_mm``); rows are independent, so the
    padded product is the unpadded one bit for bit."""
    gen = torch.Generator().manual_seed(M)
    q = torch.randint(-127, 128, (M, 64), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (64, 48), generator=gen, dtype=torch.int8)
    padded = pq.pad_rows(q)
    assert padded.shape == (pq.INT8_MM_MIN_ROWS, 64)
    assert not padded[M:].any()
    got = torch._int_mm(padded, w)[:M]
    assert torch.equal(got, torch._int_mm(q, w))
    assert torch.equal(got, pq.int8_mm(q, w, 48))
    assert pq.pad_rows(padded) is padded


def _narrow(mod, img_size=256):
    return mod.SamViTConfig(img_size=img_size, embed_dim=128, depth=2,
                            num_heads=2, window_size=14,
                            global_attn_indexes=(1,))


def _configs(variant, size):
    jcfg, pcfg = jax_sam.make_config(variant, size), sam.make_config(variant, size)
    if variant == "vit_b":
        jcfg = dataclasses.replace(jcfg, encoder_vit=_narrow(jax_vit, size))
        pcfg = dataclasses.replace(pcfg, encoder_vit=_narrow(vit_sam, size))
    return jcfg, pcfg


def _jax_tree(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jax_sam.init_sam(jax.random.PRNGKey(seed), jcfg))


@pytest.mark.parametrize("variant", ["mobile_sam", "vit_b"])
def test_quantize_encoder_swaps_what_jax_swaps(variant):
    jcfg, pcfg = _configs(variant, 256)
    tree = _jax_tree(jcfg)
    jenc = flatten_tree(jq.quantize_encoder(tree["encoder"]))
    model = load_into(sam.Sam(pcfg), tree)
    pq.quantize_encoder(model.encoder)
    swapped = {p for p, m in model.encoder.named_modules()
               if isinstance(m, QuantLinear)}
    assert swapped == {k[:-len("/w_q")].replace("/", ".")
                       for k in jenc if k.endswith("/w_q")}
    assert len(swapped) == (40 if variant == "mobile_sam" else 8)
    assert not any(isinstance(m, Linear) and p.rsplit(".", 1)[-1] in pq.QUANT_KEYS
                   for p, m in model.encoder.named_modules())
    state = model.encoder.state_dict()
    want = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jq.quantize_encoder(tree["encoder"])))
    assert state.keys() == want.keys()
    for key, t in want.items():
        _assert_bits(state[key], t)
    assert pq.quant_mode(model.encoder) == "w8"
    assert pq.quantized_bytes(model.encoder) == sum(a.nbytes for a in jenc.values())


def test_quantize_path_matching_is_exact():
    g = torch.Generator().manual_seed(0)
    tree = nn.Module()
    for name in ("proj", "reproj", "proj_out"):
        setattr(tree, name, Linear(8, 8, g))
    pq.quantize_encoder(tree, act_int8=True)
    assert isinstance(tree.proj, QuantLinear) and hasattr(tree.proj, "w_q8")
    assert isinstance(tree.reproj, Linear) and isinstance(tree.proj_out, Linear)
    jtree = jq.quantize_encoder({n: {"w": jnp.ones((8, 8))}
                                 for n in ("proj", "reproj", "proj_out")},
                                act_int8=True)
    assert [n for n, v in jtree.items() if "w_q" in v] == []
    assert [n for n, v in jtree.items() if "w_q8" not in v] == ["reproj",
                                                               "proj_out"]


def test_bf16_bundle_keeps_float32_scales(tmp_path):
    """Quantised before the cast: w_scale is float32 and equals the scale of
    the float32 weights; int8 weights stay int8; biases, norms and convs
    follow bf16, the decoder stays float32."""
    jcfg, pcfg = _configs("mobile_sam", 64)
    tree = _jax_tree(jcfg)
    bundle = SamModelBundle(pcfg, load_into(sam.Sam(pcfg), tree),
                            torch.bfloat16, quantize_activations=True)
    assert bundle.quant == "w8a8"
    jenc = flatten_tree(jq.quantize_encoder(tree["encoder"], act_int8=True))
    state = bundle.model.encoder.state_dict()
    for key, t in state.items():
        name = key.rsplit(".", 1)[-1]
        want = {"w_scale": torch.float32, "w_q8": torch.int8}.get(
            name, torch.bfloat16 if t.is_floating_point() else t.dtype)
        assert t.dtype == want, key
        if name in ("w_scale", "w_q8"):
            _assert_bits(t, jenc[key.replace(".", "/")])
    assert bundle.model.decoder.state_dict()["iou_head.layers.0.w"].dtype \
        == torch.float32
    # The scales carry more than bf16's precision: a bf16 cast would move them.
    scale = state["stages.1.blocks.0.attn.qkv.w_scale"]
    assert not torch.equal(scale, scale.to(torch.bfloat16).float())
    # cast_tree alone: floating leaves follow the dtype, w_scale does not.
    enc = cast_tree(nn.ModuleDict({"q": QuantLinear(
        torch.zeros((8, 8), dtype=torch.int8), torch.ones(8), torch.ones(8))}),
        torch.bfloat16)
    assert (enc.q.w_scale.dtype, enc.q.b.dtype, enc.q.w_q.dtype) == (
        torch.float32, torch.bfloat16, torch.int8)


@pytest.mark.parametrize("act_int8", [False, True])
def test_jax_quantized_tree_loads_strict(tmp_path, act_int8):
    """A tree JAX quantised (int8 w_q / w_q8 and float32 w_scale leaves),
    written to an .npz, loads strict=True into the port and through an
    Environment with the quantisation options off; its embedding equals
    the port's own quantisation of the float tree."""
    jcfg, pcfg = _configs("mobile_sam", 64)
    tree = _jax_tree(jcfg)
    qtree = dict(tree)
    qtree["encoder"] = jax.tree_util.tree_map(
        np.asarray, jq.quantize_encoder(tree["encoder"], act_int8=act_int8))
    (tmp_path / "segmentation").mkdir()
    save_pytree(tmp_path / "segmentation" / "mobile_sam.npz", qtree)
    opts = dict(backend=pdl.Backend.cpu, compute_dtype="float32",
                sam_image_size=64)
    env = pdl.Environment(pdl.Options(model_directory=str(tmp_path), **opts))
    bundle = env.sam_model("mobile_sam")
    assert bundle.quant == ("w8a8" if act_int8 else "w8")
    key = "stages.2.blocks.3.mlp.fc2." + ("w_q8" if act_int8 else "w_q")
    assert bundle.model.encoder.state_dict()[key].dtype == torch.int8
    ref_dir = tmp_path / "float"
    (ref_dir / "segmentation").mkdir(parents=True)
    save_pytree(ref_dir / "segmentation" / "mobile_sam.npz", tree)
    ref = pdl.Environment(pdl.Options(
        model_directory=str(ref_dir), quantize_encoder=True,
        quantize_activations=act_int8, **opts))
    img = _image(96, 64, 5, pdl)
    a = pdl.Segmentation.process(img, env).embedding
    b = pdl.Segmentation.process(img, ref).embedding
    assert torch.equal(a, b)


def _image(w, h, seed, mod):
    px = np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)
    return mod.Image(mod.Extent(w, h), mod.Channels.rgba, px)


class _Recorder:
    """Records JAX's activation quanta per quantised linear, in program
    order, from inside its jitted program."""

    def __init__(self):
        self.calls = []
        self._orig = jq.quantize_activations_int8

    def __call__(self, x):
        q, s = self._orig(x)
        jax.debug.callback(
            lambda xx, qq, ss: self.calls.append(
                (np.asarray(xx, np.float32), np.asarray(qq), np.asarray(ss))),
            x.astype(jnp.float32), q, s, ordered=True)
        return q, s


class _FollowJax:
    """The port's P2 wrapper, patched: count its own tie flips against the
    recorded JAX quanta of the same linear, then go on with JAX's."""

    def __init__(self, recorded):
        self.recorded = recorded
        self.calls = 0
        self.flips = 0
        self.quanta = 0
        self._orig = pq.quantize_rows_int8

    def __call__(self, x):
        q, s = self._orig(x)
        jx, jq_x, js = self.recorded[self.calls]
        self.calls += 1
        jq_x = jq_x.reshape(q.shape)
        diff = q.numpy() != jq_x
        if diff.any():
            t = (jx.reshape(q.shape) / js.reshape(-1, 1))[diff]
            assert np.abs(np.abs(t - np.floor(t)) - 0.5).max() <= TIE, (
                "a quantum differs away from a rounding tie")
            assert np.abs(q.numpy()[diff].astype(int) - jq_x[diff]).max() == 1
        self.flips += int(diff.sum())
        self.quanta += diff.size
        return torch.from_numpy(jq_x.copy()), torch.from_numpy(
            js.reshape(s.shape).copy())


def _environments(variant, mode, model_dir):
    """JAX's and the port's CPU Environments for one quantisation mode:
    MobileSAM at 64 from ``model_dir``; the narrow ViT-B at 256 as an
    injected bundle, quantised and cast by each package's bundle."""
    opts = dict(compute_dtype="float32", sam_variant=variant,
                largest_region_object=True, quantize_encoder=mode != "none",
                quantize_activations=mode == "w8a8")
    if variant == "mobile_sam":
        opts.update(sam_image_size=64, model_directory=str(model_dir))
        return tuple(m.Environment(m.Options(backend=m.Backend.cpu, **opts))
                     for m in (jdl, pdl))
    opts.update(sam_image_size=256, model_directory="no-such-directory",
                allow_random_weights=True)
    je, pe = (m.Environment(m.Options(backend=m.Backend.cpu, **opts))
              for m in (jdl, pdl))
    jcfg, pcfg = _configs("vit_b", 256)
    tree = _jax_tree(jcfg, seed=1)
    rng = np.random.default_rng(13)
    for b in tree["encoder"]["blocks"]:
        for k in ("rel_pos_h", "rel_pos_w"):
            b[k] = (0.3 * rng.standard_normal(b[k].shape)).astype(np.float32)
        b["qkv"]["b"] = (0.3 * rng.standard_normal(b["qkv"]["b"].shape)
                         ).astype(np.float32)
    jb = JaxBundle(jcfg, jax.tree_util.tree_map(jnp.asarray, tree), je.device,
                   jnp.float32, quantize=mode != "none",
                   quantize_activations=mode == "w8a8")
    assert je._sam_models["vit_b"].get_or_create(lambda: jb) is jb
    pb = SamModelBundle(pcfg, load_into(sam.Sam(pcfg), tree), torch.float32,
                        quantize=mode != "none",
                        quantize_activations=mode == "w8a8")
    assert pe._sam_models["vit_b"].get_or_create(lambda: pb) is pb
    return je, pe


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    (d / "segmentation").mkdir()
    save_pytree(d / "segmentation" / "mobile_sam.npz",
                _jax_tree(jax_sam.make_config("mobile_sam", 64)))
    return d


def _jax_logits(je, js, variant, prompt) -> np.ndarray:
    bundle = je.sam_model(variant)
    is_region = isinstance(prompt, jdl.Region)
    points, labels = js._prompt_arrays(None if is_region else prompt,
                                       prompt if is_region else None)
    masks, _ = jax_sam.decode_masks(bundle.params, bundle.cfg, js.embedding,
                                    jnp.asarray(points), jnp.asarray(labels))
    h, w = js.extent.height, js.extent.width
    logits = jax_upsample(masks, pick_bucket(js.extent), bundle.cfg.image_size,
                          h, w, js._crop[0], js._crop[1])
    return np.asarray(logits[0, 0])[:h, :w]


def _assert_masks_match(je, js, ps, variant):
    w, h = js.extent.width, js.extent.height
    for prompt in (pdl.Point(w * 5 // 16, h * 5 // 16),
                   pdl.Region(pdl.Point(w // 8, h // 8),
                              pdl.Point(w * 5 // 6, h * 7 // 8))):
        jprompt = (jdl.Point(prompt.x, prompt.y) if isinstance(prompt, pdl.Point)
                   else jdl.Region(jdl.Point(prompt.top_left.x, prompt.top_left.y),
                                   jdl.Point(prompt.bottom_right.x,
                                             prompt.bottom_right.y)))
        want = js.compute_mask(jprompt, largest_component=False).pixels
        got = ps.compute_mask(prompt, largest_component=False).pixels
        assert got.shape == want.shape and got.dtype == np.uint8
        flips = got[..., 0] != want[..., 0]
        if flips.any():
            logits = _jax_logits(je, js, variant, jprompt)
            assert (np.abs(logits[flips]) <= NEAR_ZERO).all(), (
                f"{int(flips.sum())} mask pixels flipped away from a zero logit")


SIZES = {"mobile_sam": (96, 64), "vit_b": (300, 200)}


@pytest.mark.parametrize("variant", ["mobile_sam", "vit_b"])
def test_w8_environment_matches_jax(model_dir, variant):
    je, pe = _environments(variant, "w8", model_dir)
    assert pe.sam_model(variant).quant == "w8"
    w, h = SIZES[variant]
    js = jdl.Segmentation.process(_image(w, h, 42, jdl), je)
    ps = pdl.Segmentation.process(_image(w, h, 42, pdl), pe)
    np.testing.assert_allclose(ps.embedding.numpy(), np.asarray(js.embedding),
                               atol=1e-4, rtol=0)
    _assert_masks_match(je, js, ps, variant)


@pytest.mark.parametrize("variant", ["mobile_sam", "vit_b"])
def test_w8a8_environment_matches_jax_up_to_tie_flips(model_dir, variant,
                                                      monkeypatch):
    """See the module docstring: every differing activation quantum is a
    tie flip, at most 1e-3 of them; continuing from JAX's quanta the
    embedding is within atol 1e-4 and the masks match as under w8."""
    je, pe = _environments(variant, "w8a8", model_dir)
    w, h = SIZES[variant]
    recorder = _Recorder()
    monkeypatch.setattr(jq, "quantize_activations_int8", recorder)
    js = jdl.Segmentation.process(_image(w, h, 42, jdl), je)
    jax.effects_barrier()
    monkeypatch.undo()
    blocks = 10 if variant == "mobile_sam" else 2
    assert len(recorder.calls) == 4 * blocks
    own = pdl.Segmentation.process(_image(w, h, 42, pdl), pe).embedding
    follow = _FollowJax(recorder.calls)
    monkeypatch.setattr(pq, "quantize_rows_int8", follow)
    ps = pdl.Segmentation.process(_image(w, h, 42, pdl), pe)
    assert follow.calls == 4 * blocks
    assert follow.flips <= MAX_FLIP_SHARE * follow.quanta, (
        follow.flips, follow.quanta)
    want = np.asarray(js.embedding)
    np.testing.assert_allclose(ps.embedding.numpy(), want, atol=1e-4, rtol=0)
    if follow.flips == 0:
        np.testing.assert_allclose(own.numpy(), want, atol=1e-4, rtol=0)
    _assert_masks_match(je, js, ps, variant)


def test_quantize_activations_alone_implies_int8_weights(model_dir):
    env = pdl.Environment(pdl.Options(
        backend=pdl.Backend.cpu, model_directory=str(model_dir),
        sam_image_size=64, quantize_activations=True))
    qkv = env.sam_model("mobile_sam").model.encoder.stages[1].blocks[0].attn.qkv
    assert isinstance(qkv, QuantLinear) and qkv.w_q8.dtype == torch.int8
    assert qkv.w_scale.dtype == torch.float32 and qkv.b.dtype == torch.bfloat16


def test_executable_keys_tell_quantised_from_float(model_dir):
    """One Environment whose mobile_sam bundle is swapped from float to w8
    to w8a8: each gets an embed executable of its own."""
    opts = dict(backend=pdl.Backend.cpu, model_directory=str(model_dir),
                sam_image_size=64, compute_dtype="float32")
    env = pdl.Environment(pdl.Options(**opts))
    img = _image(96, 64, 3, pdl)
    embs = [pdl.Segmentation.process(img, env).embedding]
    for mode in ("w8", "w8a8"):
        other = pdl.Environment(pdl.Options(
            quantize_encoder=True, quantize_activations=mode == "w8a8", **opts))
        bundle = other.sam_model("mobile_sam")
        env._sam_models["mobile_sam"] = type(env._sam_models["mobile_sam"])()
        assert env._sam_models["mobile_sam"].get_or_create(lambda: bundle) is bundle
        embs.append(pdl.Segmentation.process(img, env).embedding)
    assert sorted(k for k in env.executables if k[0] == "embed") == [
        ("embed", "mobile_sam", 256, m) for m in ("none", "w8", "w8a8")]
    assert not torch.equal(embs[0], embs[1]) and not torch.equal(embs[1], embs[2])
