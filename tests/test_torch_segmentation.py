"""The slice as a whole: the port's Environment / Segmentation against the
JAX package's, on the CPU, in float32, from ONE weight bundle (the JAX
seed-0 `init_sam` tree written to a model directory), on the golden image
of tests/test_goldens.py (sam_image_size=64, largest_region_object=True).

The embedding must agree within atol 1e-4. Masks must equal JAX's byte for
byte; a flipped pixel is allowed only where JAX's upsampled logit there is
within 1e-4 of zero (a threshold decision the float32 noise can move).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlimgedit_tpu as jdl
import dlimgedit_tpu_torch as pdl
from dlimgedit_tpu.models import sam as jax_sam
from dlimgedit_tpu.ops.connected import largest_component_mask as jax_lcc
from dlimgedit_tpu.ops.postprocess import upsample_mask_logits as jax_upsample
from dlimgedit_tpu.ops.preprocess import pick_bucket
from dlimgedit_tpu.utils.pytree_io import save_pytree

torch.set_num_threads(2)

IMAGE_SIZE = 64
NEAR_ZERO = 1e-4


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    (d / "segmentation").mkdir()
    params = jax_sam.init_sam(jax.random.PRNGKey(0),
                              jax_sam.make_config("mobile_sam", IMAGE_SIZE))
    save_pytree(d / "segmentation" / "mobile_sam.npz",
                jax.tree_util.tree_map(np.asarray, params))
    return d


def _opts(mod, model_dir):
    return mod.Options(backend=mod.Backend.cpu, model_directory=str(model_dir),
                       compute_dtype="float32", sam_image_size=IMAGE_SIZE,
                       largest_region_object=True)


@pytest.fixture(scope="module")
def envs(model_dir):
    return (jdl.Environment(_opts(jdl, model_dir)),
            pdl.Environment(_opts(pdl, model_dir)))


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(42).integers(0, 256, (64, 96, 4), dtype=np.uint8)


@pytest.fixture(scope="module")
def segs(envs, pixels):
    je, pe = envs
    js = jdl.Segmentation.process(
        jdl.Image(jdl.Extent(96, 64), jdl.Channels.rgba, pixels), je)
    ps = pdl.Segmentation.process(
        pdl.Image(pdl.Extent(96, 64), pdl.Channels.rgba, pixels), pe)
    return js, ps


def _jax_logits(je, js, prompt, multimask=False, lcc=False) -> np.ndarray:
    """JAX's upsampled mask logits at the original extent, (T, H, W): the
    decode program of dlimgedit_tpu/runtime/segmentation.py before its
    threshold."""
    bundle = je.sam_model()
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
        keep = jax.vmap(jax.vmap(jax_lcc))(masks > 0)
        masks = jnp.where(keep, masks, -10.0)
    h, w = js.extent.height, js.extent.width
    logits = jax_upsample(masks, pick_bucket(js.extent), cfg.image_size, h, w,
                          js._crop[0], js._crop[1])
    return np.asarray(logits[0])[:, :h, :w]


def _assert_mask_matches(got: np.ndarray, want: np.ndarray, logits_fn):
    assert got.shape == want.shape and got.dtype == np.uint8
    flips = got[..., 0] != want[..., 0]
    if not flips.any():
        return
    near = np.abs(logits_fn()[flips]) <= NEAR_ZERO
    assert near.all(), (
        f"{int(flips.sum())} pixels flipped, {int((~near).sum())} of them where "
        f"JAX's logit is not within {NEAR_ZERO} of zero")


def test_embedding_matches_jax(segs):
    js, ps = segs
    want = np.asarray(js.embedding)
    got = ps.embedding.numpy()
    assert got.shape == want.shape == (1, 4, 4, 256)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_point_mask_matches_jax(envs, segs):
    js, ps = segs
    _assert_mask_matches(ps.compute_mask(pdl.Point(30, 20)).pixels,
                         js.compute_mask(jdl.Point(30, 20)).pixels,
                         lambda: _jax_logits(envs[0], js, jdl.Point(30, 20))[0])


def test_region_mask_matches_jax(envs, segs):
    js, ps = segs
    jr = jdl.Region(jdl.Point(8, 8), jdl.Point(80, 56))
    got = ps.compute_mask(pdl.Region(pdl.Point(8, 8), pdl.Point(80, 56))).pixels
    _assert_mask_matches(got, js.compute_mask(jr).pixels,
                         lambda: _jax_logits(envs[0], js, jr, lcc=True)[0])


def test_multimask_matches_jax(envs, segs):
    js, ps = segs
    want = js.compute_masks(jdl.Point(48, 32))
    got = ps.compute_masks(pdl.Point(48, 32))
    assert len(got) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_mask_matches(
            g.image.pixels, w.image.pixels,
            lambda i=i: _jax_logits(envs[0], js, jdl.Point(48, 32),
                                    multimask=True)[i])
        assert abs(g.accuracy - w.accuracy) <= 1e-4


def test_batch_masks_match_jax(envs, segs):
    js, ps = segs
    jp = [jdl.Point(20, 20), jdl.Region(jdl.Point(4, 4), jdl.Point(60, 40)),
          jdl.Point(70, 50)]
    pp = [pdl.Point(20, 20), pdl.Region(pdl.Point(4, 4), pdl.Point(60, 40)),
          pdl.Point(70, 50)]
    want = js.compute_mask_batch(jp)
    got = ps.compute_mask_batch(pp)
    assert len(got) == 3
    for g, w, prompt in zip(got, want, jp):
        _assert_mask_matches(
            g.image.pixels, w.image.pixels,
            lambda prompt=prompt: _jax_logits(
                envs[0], js, prompt,
                lcc=isinstance(prompt, jdl.Region))[0])
        assert abs(g.accuracy - w.accuracy) <= 1e-4


def test_second_bucket_matches_jax(envs):
    """A 300x200 RGB image: canvas bucket 512, another resample geometry."""
    je, pe = envs
    px = np.random.default_rng(7).integers(0, 256, (200, 300, 3), dtype=np.uint8)
    js = jdl.Segmentation.process(jdl.Image(jdl.Extent(300, 200), jdl.Channels.rgb, px), je)
    ps = pdl.Segmentation.process(pdl.Image(pdl.Extent(300, 200), pdl.Channels.rgb, px), pe)
    np.testing.assert_allclose(ps.embedding.numpy(), np.asarray(js.embedding),
                               atol=1e-4, rtol=0)
    _assert_mask_matches(ps.compute_mask(pdl.Point(150, 100)).pixels,
                         js.compute_mask(jdl.Point(150, 100)).pixels,
                         lambda: _jax_logits(je, js, jdl.Point(150, 100))[0])


def test_host_preprocess_mode_matches_jax(model_dir, pixels):
    opts = {m: _opts(m, model_dir) for m in (jdl, pdl)}
    for o in opts.values():
        o.preprocess_mode = "host"
    js = jdl.Segmentation.process(jdl.Image(jdl.Extent(96, 64), jdl.Channels.rgba, pixels),
                                  jdl.Environment(opts[jdl]))
    ps = pdl.Segmentation.process(pdl.Image(pdl.Extent(96, 64), pdl.Channels.rgba, pixels),
                                  pdl.Environment(opts[pdl]))
    np.testing.assert_allclose(ps.embedding.numpy(), np.asarray(js.embedding),
                               atol=1e-4, rtol=0)


def test_sha256_pin_is_enforced(model_dir, tmp_path):
    d = tmp_path / "pinned"
    (d / "segmentation").mkdir(parents=True)
    bundle = d / "segmentation" / "mobile_sam.npz"
    bundle.write_bytes((model_dir / "segmentation" / "mobile_sam.npz").read_bytes())
    (d / "segmentation" / "mobile_sam.npz.sha256").write_text("0" * 64 + "\n")
    env = pdl.Environment(_opts(pdl, d))
    with pytest.raises(pdl.DlimgError, match="integrity"):
        env.sam_model()


@pytest.mark.parametrize("field,value,slice_name", [
    ("compilation_cache_dir", "cache", "CUDA graph"),
])
def test_unported_options_are_rejected(field, value, slice_name):
    opts = pdl.Options(backend=pdl.Backend.cpu, allow_random_weights=True)
    setattr(opts, field, value)
    with pytest.raises(pdl.DlimgError, match=slice_name):
        pdl.Environment(opts)


def test_gpu_backend_is_the_default_and_never_falls_back(monkeypatch):
    assert pdl.Options().backend == pdl.Backend.gpu
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for variant in ("mobile_sam", "vit_b"):
        with pytest.raises(pdl.DlimgError, match="no CUDA device"):
            pdl.Environment(pdl.Options(allow_random_weights=True,
                                        sam_variant=variant))
    assert not pdl.is_supported(pdl.Backend.gpu)
    assert pdl.is_supported(pdl.Backend.cpu)


def test_random_weights_are_seeded():
    """allow_random_weights uses the port's own seeded init: two
    Environments hold the same weights (not JAX's numbers)."""
    opts = pdl.Options(backend=pdl.Backend.cpu, allow_random_weights=True,
                       compute_dtype="float32", sam_image_size=IMAGE_SIZE,
                       model_directory="no-such-directory")
    a, b = (pdl.Environment(opts).sam_model().model.state_dict()
            for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("devices", [0, 4])
def test_scaleout_devices_on_one_device_serves_as_one(model_dir, pixels,
                                                      segs, devices):
    """``scaleout_devices`` 0 (every device of the backend) or N (at most
    that many) leaves one device here, so the Environment takes the
    single-device path, as JAX's does (tests/test_scaleout.py): the same
    embedding and mask as ``scaleout_devices=1``, bit for bit."""
    opts = _opts(pdl, model_dir)
    opts.scaleout_devices = devices
    seg = pdl.Segmentation.process(
        pdl.Image(pdl.Extent(96, 64), pdl.Channels.rgba, pixels),
        pdl.Environment(opts))
    one = segs[1]
    assert torch.equal(seg.embedding, one.embedding)
    for prompt in (pdl.Point(20, 20), pdl.Point(70, 40)):
        np.testing.assert_array_equal(seg.compute_mask(prompt).pixels,
                                      one.compute_mask(prompt).pixels)


def test_scaleout_over_two_faked_cuda_devices_gives_an_sp_mesh(monkeypatch):
    """Two CUDA devices (faked) give Environment an ('sp',) mesh over
    cuda:0 and cuda:1, on which the ViTs run sequence-parallel and
    MobileSAM and BiRefNet on canvas-row bands
    (tests/test_torch_scaleout.py holds both on CPU meshes);
    ``scaleout_devices=1`` keeps the one device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    opts = pdl.Options(allow_random_weights=True, scaleout_devices=0)
    env = pdl.Environment(opts)
    assert env.mesh.shape == {"sp": 2}
    assert list(env.mesh.devices) == [torch.device("cuda", 0),
                                      torch.device("cuda", 1)]
    opts.scaleout_devices = 1
    env = pdl.Environment(opts)
    assert env.device.type == "cuda" and env.mesh is None
