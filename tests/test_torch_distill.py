"""The port's encoder distillation (dlimgedit_tpu_torch/train/distill.py)
against the JAX package's, on the CPU in float32 (JAX's
tests/test_distill.py is the model): a narrow ViT-B teacher (embed 128,
depth 2) and a MobileSAM student at image size 64, JAX's trees carried
across by ``params_from_numpy``, numpy-seeded images.

Tolerances: teacher embeddings atol 2e-5, rtol 1e-4 (JAX's own for its
sharded teacher); the distillation loss relative 1e-5; each leaf of the
student encoder's gradient relative L2 1e-4 (``_torch_train_util``). Also:
the loss falls over 3 steps, the step leaves everything but the encoder
untouched, the grafted model serves, remat gives the identical loss, the
bf16 policy returns float32 gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_util import assert_grads_close, load, rel_close
from dlimgedit_tpu.models import sam as jsam
from dlimgedit_tpu.models import vit_sam as jvit
from dlimgedit_tpu.train import distill as jdistill
from dlimgedit_tpu_torch.models import sam, vit_sam
from dlimgedit_tpu_torch.train import distill
from dlimgedit_tpu_torch.train.step import leaves, loss_and_grads

torch.set_num_threads(2)

B, S = 2, 64


def _narrow_vit(mod):
    return mod.SamViTConfig(img_size=S, embed_dim=128, depth=2, num_heads=2,
                            window_size=14, global_attn_indexes=(1,))


@pytest.fixture(scope="module")
def setup():
    jt_cfg = dataclasses.replace(jsam.make_config("vit_b", S),
                                 encoder_vit=_narrow_vit(jvit))
    t_cfg = dataclasses.replace(sam.make_config("vit_b", S),
                                encoder_vit=_narrow_vit(vit_sam))
    js_cfg = jsam.make_config("mobile_sam", S)
    s_cfg = sam.make_config("mobile_sam", S)
    jteacher = jsam.init_sam(jax.random.PRNGKey(0), jt_cfg)
    jstudent = jsam.init_sam(jax.random.PRNGKey(1), js_cfg)
    images = np.random.default_rng(0).standard_normal(
        (B, S, S, 3)).astype(np.float32)
    jemb = np.asarray(jdistill.teacher_embeddings(jteacher, jt_cfg,
                                                  jnp.asarray(images)))
    teacher = load(sam.Sam(t_cfg), jteacher)
    emb = distill.teacher_embeddings(teacher, t_cfg, torch.from_numpy(images))
    return dict(jt_cfg=jt_cfg, t_cfg=t_cfg, js_cfg=js_cfg, s_cfg=s_cfg,
                jteacher=jteacher, jstudent=jstudent, teacher=teacher,
                images=images, jemb=jemb, emb=emb)


def _student(setup):
    return load(sam.Sam(setup["s_cfg"]), setup["jstudent"])


def _batch(setup):
    return {"images": setup["images"], "teacher_emb": setup["jemb"]}


def test_teacher_embeddings_match_jax(setup):
    emb = setup["emb"]
    assert emb.shape == (B, S // 16, S // 16, 256)
    assert emb.dtype == torch.float32 and not emb.requires_grad
    np.testing.assert_allclose(emb.numpy(), setup["jemb"], atol=2e-5,
                               rtol=1e-4)


def test_distill_loss_and_grads_match_jax(setup):
    batch = _batch(setup)
    tcfg = jdistill.DistillConfig()
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda e, b: jdistill.distill_loss({"encoder": e}, setup["js_cfg"], b,
                                           tcfg), has_aux=True))(
        setup["jstudent"]["encoder"], batch)
    encoder = _student(setup).encoder
    (loss, aux), grads = loss_and_grads(distill.distill_loss, encoder,
                                        setup["s_cfg"], batch,
                                        distill.DistillConfig())
    rel_close(loss, jl)
    assert set(aux) == {"mse"}
    rel_close(aux["mse"], jaux["mse"])
    assert_grads_close(grads, jg)


def test_step_trains_only_the_encoder_and_the_loss_falls(setup):
    student = _student(setup)
    before = {k: v.clone() for k, v in leaves(student).items()}
    tcfg = distill.DistillConfig(learning_rate=1e-3)
    step = distill.make_distill_step(setup["s_cfg"], tcfg)
    state = distill.init_distill_state(student.encoder, tcfg)
    batch = {"images": setup["images"], "teacher_emb": setup["emb"]}
    losses = []
    for _ in range(3):
        enc, state, loss, aux = step(student.encoder, state, batch)
        losses.append(float(loss))
    assert enc is student.encoder and set(aux) == {"mse"}
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    after = leaves(student)
    for k, v in before.items():
        if not k.startswith("encoder."):
            assert torch.equal(after[k], v), k
    assert not torch.equal(after["encoder.patch_embed.conv1.w"],
                           before["encoder.patch_embed.conv1.w"])
    assert int(state["count"]) == 3

    grafted = distill.graft_student(student.encoder, setup["teacher"])
    assert set(dict(grafted.named_children())) == {
        "encoder", "prompt_encoder", "decoder"}
    assert grafted.decoder is setup["teacher"].decoder
    with torch.no_grad():
        emb = sam.encode_image(grafted, setup["s_cfg"],
                               torch.from_numpy(setup["images"][:1]))
        masks, iou = sam.decode_masks(
            grafted, setup["s_cfg"], emb, torch.tensor([[[32.0, 32.0],
                                                         [0.0, 0.0]]]),
            torch.tensor([[1.0, -1.0]]), multimask=False)
    L = setup["s_cfg"].mask_input_size
    assert masks.shape == (1, 1, L, L) and torch.isfinite(iou).all()


def test_remat_identical_loss_and_bf16_returns_f32_grads(setup):
    encoder = _student(setup).encoder
    batch = _batch(setup)
    l0, _ = distill.distill_loss(encoder, setup["s_cfg"], batch)
    l1, _ = distill.distill_loss(encoder, setup["s_cfg"], batch,
                                 distill.DistillConfig(remat=True))
    assert float(l0) == float(l1)
    _, grads = loss_and_grads(distill.distill_loss, encoder, setup["s_cfg"],
                              batch, distill.DistillConfig(
                                  compute_dtype="bfloat16"))
    for g in grads.values():
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
