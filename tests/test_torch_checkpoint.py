"""The port's checkpoints and serving export
(dlimgedit_tpu_torch/train/checkpoint.py, convert/from_numpy.py's
``numpy_from_params``) on the CPU (JAX's tests/test_checkpoint.py is the
model): the save / restore round trip, the latest step, a missing
directory, the optimizer-state leaf check of a mismatched config, a resume
that gives the same next loss bit for bit, the numpy round trip tree ->
port -> tree bit for bit (MobileSAM, a narrow ViT-B, the slim BiRefNet, a
w8a8 encoder), and an exported bundle that both packages' Environments
load (sha256 pin checked) and serve with the same embedding (atol 1e-4,
tests/test_torch_segmentation.py's)."""

import dataclasses
import hashlib

import jax
import numpy as np
import pytest
import torch

import dlimgedit_tpu as jdl
import dlimgedit_tpu_torch as pdl
from _torch_train_util import np_tree, sam_batch, slim_birefnet
from dlimgedit_tpu.models import sam as jsam
from dlimgedit_tpu.models import vit_sam as jvit
from dlimgedit_tpu.utils.pytree_io import flatten_tree
from dlimgedit_tpu_torch.convert.from_numpy import (
    load_into,
    numpy_from_params,
    params_from_numpy,
)
from dlimgedit_tpu_torch.errors import DlimgError
from dlimgedit_tpu_torch.models import sam, vit_sam
from dlimgedit_tpu_torch.ops.quant import quantize_encoder
from dlimgedit_tpu_torch.train import checkpoint as ckpt
from dlimgedit_tpu_torch.train import step

torch.set_num_threads(2)

S = 64


def _model(seed=0):
    return sam.Sam(sam.make_config("mobile_sam", S),
                   torch.Generator().manual_seed(seed))


def _trained(tcfg=step.TrainConfig()):
    cfg = sam.make_config("mobile_sam", S)
    model = _model()
    state = step.init_train_state(model, tcfg)
    batch = sam_batch(2, S, cfg.mask_input_size, seed=1)
    train = step.make_train_step(cfg, tcfg)
    model, state, _, _ = train(model, state, batch)
    return cfg, model, state, batch, train


def test_checkpoint_roundtrip(tmp_path):
    _, model, state, _, _ = _trained()
    ckpt.save_train_state(tmp_path, 7, model, state)
    assert ckpt.latest_step(tmp_path) == 7
    ckpt.save_train_state(tmp_path, 12, model, state)
    assert ckpt.latest_step(tmp_path) == 12
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_12", "step_7"]
    params, opt, n = ckpt.restore_train_state(tmp_path)
    assert n == 12
    assert set(params) == set(step.leaves(model))
    for k, v in step.leaves(model).items():
        assert torch.equal(params[k], v)
    assert int(opt["count"]) == 1
    for k, v in state["mu"].items():
        assert torch.equal(opt["mu"][k], v)


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore_train_state(tmp_path / "empty")


def test_a_mismatched_optimizer_config_raises(tmp_path):
    tcfg = step.TrainConfig(warmup_steps=2, decay_steps=4)
    _, model, state, _, _ = _trained(tcfg)
    ckpt.save_train_state(tmp_path, 1, model, state)
    with pytest.raises(DlimgError, match="leaves"):
        ckpt.restore_train_state(tmp_path)
    _, opt, _ = ckpt.restore_train_state(tmp_path, tcfg=tcfg)
    assert int(opt["schedule_count"]) == 1


def test_resume_gives_the_same_next_loss(tmp_path):
    tcfg = step.TrainConfig(warmup_steps=1, decay_steps=4)
    cfg, model, state, batch, train = _trained(tcfg)
    ckpt.save_train_state(tmp_path, 1, model, state)
    _, _, want, _ = train(model, state, batch)
    fresh, opt, n = ckpt.restore_train_state(tmp_path, like=_model(seed=5))
    _, _, got, _ = train(fresh, opt, batch)
    assert n == 1 and float(got) == float(want)


def _narrow_vit(mod):
    return mod.SamViTConfig(img_size=S, embed_dim=128, depth=2, num_heads=2,
                            window_size=14, global_attn_indexes=(1,))


def _trees():
    j_mobile = jsam.make_config("mobile_sam", S)
    j_vit = dataclasses.replace(jsam.make_config("vit_b", S),
                                encoder_vit=_narrow_vit(jvit))
    p_vit = dataclasses.replace(sam.make_config("vit_b", S),
                                encoder_vit=_narrow_vit(vit_sam))
    yield "mobile_sam", np_tree(jsam.init_sam(jax.random.PRNGKey(0), j_mobile)), \
        sam.Sam(sam.make_config("mobile_sam", S))
    yield "vit_b", np_tree(jsam.init_sam(jax.random.PRNGKey(0), j_vit)), \
        sam.Sam(p_vit)
    _, jparams, _, model = slim_birefnet()
    yield "birefnet", jparams, model


def test_numpy_round_trip_is_bit_equal():
    for name, tree, model in _trees():
        model.load_state_dict(params_from_numpy(tree), strict=True)
        back = flatten_tree(numpy_from_params(model))
        want = flatten_tree(tree)
        assert set(back) == set(want), name
        for k, w in want.items():
            assert back[k].dtype == w.dtype and back[k].shape == w.shape, k
            np.testing.assert_array_equal(back[k], w, err_msg=f"{name} {k}")


def test_numpy_round_trip_keeps_int8_leaves():
    model = _model()
    quantize_encoder(model.encoder, act_int8=True)
    tree = numpy_from_params(model)
    flat = flatten_tree(tree)
    q8 = [k for k in flat if k.endswith("/w_q8")]
    assert q8 and all(flat[k].dtype == np.int8 for k in q8)
    assert all(flat[k].dtype == np.float32 for k in flat
               if k.endswith("/w_scale"))
    again = load_into(_model(seed=3), tree)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_exported_bundle_serves_in_both_packages(tmp_path):
    _, model, _, _, _ = _trained()
    out = tmp_path / "models" / "segmentation" / "mobile_sam.npz"
    ckpt.export_serving_bundle(model, out)
    pin = out.parent / "mobile_sam.npz.sha256"
    pin.write_text(hashlib.sha256(out.read_bytes()).hexdigest() + "\n")
    pixels = np.random.default_rng(0).integers(0, 256, (32, 48, 3),
                                               dtype=np.uint8)
    segs = []
    for mod in (pdl, jdl):
        env = mod.Environment(mod.Options(
            backend=mod.Backend.cpu, model_directory=str(tmp_path / "models"),
            compute_dtype="float32", sam_image_size=S))
        seg = mod.Segmentation.process(
            mod.Image(mod.Extent(48, 32), mod.Channels.rgb, pixels), env)
        assert seg.compute_mask(mod.Point(24, 16)).extent == mod.Extent(48, 32)
        segs.append(np.asarray(seg.embedding))
    loaded = pdl.Environment(pdl.Options(
        backend=pdl.Backend.cpu, model_directory=str(tmp_path / "models"),
        compute_dtype="float32", sam_image_size=S)).sam_model().model
    for k, v in step.leaves(model).items():
        assert torch.equal(loaded.state_dict()[k], v), k
    np.testing.assert_allclose(segs[0], segs[1], atol=1e-4, rtol=0)
    pin.write_text("0" * 64 + "\n")
    with pytest.raises(DlimgError, match="integrity"):
        pdl.Environment(pdl.Options(
            backend=pdl.Backend.cpu, model_directory=str(tmp_path / "models"),
            compute_dtype="float32", sam_image_size=S)).sam_model()
