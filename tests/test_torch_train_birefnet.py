"""The port's BiRefNet fine-tuning step
(dlimgedit_tpu_torch/train/birefnet_step.py) against the JAX package's, on
the CPU in float32 (JAX's tests/test_train_birefnet.py is the model): its
slim BiRefNet at 64, JAX's seed-0 tree with nonzero offset and modulator
convs (so the deformable convs sample off the grid and their offsets get a
gradient), numpy-seeded images and masks.

Tolerances: loss and aux relative 1e-5; each leaf's gradient relative L2
1e-4 (``_torch_train_util``). Also: the loss falls over 3 steps and the
parameters move, the fine-tuned model serves through ``segment_frames``,
the soft IoU of a right answer on an empty mask is near 0, remat gives the
identical loss, the bf16 policy returns float32 gradients.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_train_util import assert_grads_close, rel_close, slim_birefnet
from dlimgedit_tpu.train import birefnet_step as jstep
from dlimgedit_tpu_torch.parallel.batch import segment_frames
from dlimgedit_tpu_torch.train import birefnet_step as pstep
from dlimgedit_tpu_torch.train.step import leaves, loss_and_grads

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    jcfg, jparams, cfg, _ = slim_birefnet()
    rng = np.random.default_rng(0)
    batch = {"images": rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
             "masks": (rng.random((2, 64, 64)) > 0.5).astype(np.float32)}
    return jcfg, jparams, cfg, batch


def _model():
    return slim_birefnet()[3]


def test_loss_and_grads_match_jax(setup):
    jcfg, jparams, cfg, batch = setup
    tcfg = jstep.BiRefNetTrainConfig()
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.birefnet_loss(p, jcfg, b, tcfg), has_aux=True))(
        jparams, batch)
    (loss, aux), grads = loss_and_grads(pstep.birefnet_loss, _model(), cfg,
                                        batch, pstep.BiRefNetTrainConfig())
    rel_close(loss, jl)
    assert set(aux) == set(jaux) == {"bce", "iou"}
    for k in aux:
        rel_close(aux[k], jaux[k])
    assert_grads_close(grads, jg)
    assert float(grads["squeeze.aspp.deforms.0.offset.w"].norm()) > 0


def test_loss_falls_and_the_model_serves(setup):
    _, _, cfg, batch = setup
    model = _model()
    tcfg = pstep.BiRefNetTrainConfig(learning_rate=1e-3)
    state = pstep.init_birefnet_train_state(model, tcfg)
    step = pstep.make_birefnet_train_step(cfg, tcfg)
    before = model.backbone.patch_embed.w.clone()
    losses = []
    for _ in range(3):
        model, state, loss, aux = step(model, state, batch)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert set(aux) == {"bce", "iou"}
    assert not torch.equal(model.backbone.patch_embed.w, before)
    logits = segment_frames(model, cfg, torch.from_numpy(batch["images"][:1]))
    assert logits.shape == (1, 64, 64, 1) and logits.dtype == torch.float32


def test_soft_iou_is_near_zero_for_a_right_empty_mask():
    logits = torch.full((1, 8, 8, 1), -20.0)
    assert float(pstep._soft_iou_loss(logits, torch.zeros_like(logits))) < 1e-6
    assert float(pstep._soft_iou_loss(-logits, torch.ones_like(logits))) < 1e-6


def test_remat_identical_loss_and_bf16_returns_f32_grads(setup):
    _, _, cfg, batch = setup
    model = _model()
    l0, _ = pstep.birefnet_loss(model, cfg, batch)
    l1, _ = pstep.birefnet_loss(model, cfg, batch,
                                pstep.BiRefNetTrainConfig(remat=True))
    assert float(l0) == float(l1)
    half = {k: v[:1] for k, v in batch.items()}
    _, grads = loss_and_grads(pstep.birefnet_loss, model, cfg, half,
                              pstep.BiRefNetTrainConfig(
                                  compute_dtype="bfloat16"))
    assert set(grads) == set(leaves(model))
    for g in grads.values():
        assert g.dtype == torch.float32 and torch.isfinite(g).all()


def test_training_after_serving_in_one_process(setup):
    """The device tensors the forward caches per size (Swin's index and
    shift masks, the align-corners matrices) are made outside inference
    mode, so a model served first (``segment_frames`` runs under
    ``torch.inference_mode``) trains afterwards."""
    from dlimgedit_tpu_torch.models import birefnet as bn
    from dlimgedit_tpu_torch.models import swin

    _, _, cfg, batch = setup
    for cached in (swin._rel_pos_index, swin._shift_attn_mask, bn._ac_matrix):
        cached.cache_clear()
    model = _model()
    segment_frames(model, cfg, torch.from_numpy(batch["images"][:1]))
    (loss, _), grads = loss_and_grads(pstep.birefnet_loss, model, cfg,
                                      {k: v[:1] for k, v in batch.items()},
                                      pstep.BiRefNetTrainConfig())
    assert np.isfinite(float(loss))
    assert all(torch.isfinite(g).all() for g in grads.values())
