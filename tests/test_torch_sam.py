"""The port's prompt encoder + mask decoder (`decode_masks`) against the
JAX package's, from the same JAX `init_sam` weights and a numpy-made
embedding, multimask and single-mask, float32. Tolerance atol 1e-4: float32
summation order through two two-way blocks and the upscaler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlimgedit_tpu.models import sam as jax_sam
from dlimgedit_tpu_torch.convert.from_numpy import params_from_numpy
from dlimgedit_tpu_torch.models import sam

torch.set_num_threads(2)

IMAGE_SIZE = 64


@pytest.fixture(scope="module")
def models():
    jcfg = jax_sam.make_config("mobile_sam", IMAGE_SIZE)
    jparams = jax_sam.init_sam(jax.random.PRNGKey(0), jcfg)
    cfg = sam.make_config("mobile_sam", IMAGE_SIZE)
    model = sam.Sam(cfg)
    model.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams)), strict=True)
    return jcfg, jparams, cfg, model.eval()


PROMPTS = {
    # (points (B, N, 2), labels (B, N)) in padded model-input pixels
    "point": ([[[20.0, 30.0], [0.0, 0.0]]], [[1.0, -1.0]]),
    "box": ([[[8.0, 10.0], [50.0, 40.0]]], [[2.0, 3.0]]),
    "three_points": ([[[20.0, 30.0], [40.0, 12.0], [5.0, 50.0]]],
                     [[1.0, 0.0, 1.0]]),
}


@pytest.mark.parametrize("multimask", [True, False])
@pytest.mark.parametrize("prompt", sorted(PROMPTS))
def test_decode_masks_matches_jax(models, prompt, multimask):
    jcfg, jparams, cfg, model = models
    points, labels = (np.asarray(a, np.float32) for a in PROMPTS[prompt])
    emb = np.random.default_rng(5).standard_normal(
        (1, IMAGE_SIZE // 16, IMAGE_SIZE // 16, 256)).astype(np.float32)
    want_m, want_iou = jax_sam.decode_masks(
        jparams, jcfg, jnp.asarray(emb), jnp.asarray(points),
        jnp.asarray(labels), multimask=multimask)
    with torch.inference_mode():
        got_m, got_iou = sam.decode_masks(
            model, cfg, torch.from_numpy(emb), torch.from_numpy(points),
            torch.from_numpy(labels), multimask=multimask)
    n_masks = 4 if multimask else 1
    assert got_m.shape == (1, n_masks, IMAGE_SIZE // 4, IMAGE_SIZE // 4)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got_iou.numpy(), np.asarray(want_iou),
                               atol=1e-4, rtol=0)


def test_select_single_mask_follows_the_onnx_rule():
    masks = torch.arange(4, dtype=torch.float32).reshape(1, 4, 1, 1).expand(1, 4, 2, 2)
    iou = torch.tensor([[0.9, 0.1, 0.5, 0.3]])
    m, s = sam.select_single_mask(masks, iou, num_points=2)
    assert float(m[0, 0, 0, 0]) == 2.0 and float(s[0, 0]) == pytest.approx(0.5)
    m, s = sam.select_single_mask(masks, iou, num_points=3)
    assert float(m[0, 0, 0, 0]) == 0.0 and float(s[0, 0]) == pytest.approx(0.9)
