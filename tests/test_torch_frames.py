"""The port's batched frames (dlimgedit_tpu_torch/parallel/batch.py:
``encode_frames``, ``segment_frames``) against the JAX package on the CPU,
float32, JAX's seed-0 trees carried across by ``params_from_numpy`` and
numpy-seeded frames (JAX's tests/test_parallel.py is the model; here on
one device, as the port has no mesh yet):

  * ``encode_frames`` of 4 frames against JAX's ``encode_image`` on the
    same batch: MobileSAM at 64 (full width) and a narrow ViT-B at 128
    (embed 128, depth 2, a windowed and a global block; the batch runs the
    windowed block without the pad-query skip), atol 1e-4, rtol 1e-4 (the
    port's encoder parity tolerance);
  * each frame of a batch against a call on that frame alone, atol 1e-5;
  * ``segment_frames`` of 2 frames against JAX's ``birefnet_apply`` on
    the slim BiRefNet at 64 with nonzero offsets: atol 1e-4, rtol 1e-4
    (tests/test_torch_birefnet.py's);
  * one executable per (program, model, config, shape, dtype) key, results
    that the next call does not overwrite, and a mesh of 2 devices runs
    each row through it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_util import load, slim_birefnet
from dlimgedit_tpu.models import birefnet as jbn
from dlimgedit_tpu.models import sam as jsam
from dlimgedit_tpu.models import vit_sam as jvit
from dlimgedit_tpu_torch.errors import DlimgError
from dlimgedit_tpu_torch.models import sam, vit_sam
from dlimgedit_tpu_torch.parallel import batch as pbatch
from dlimgedit_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(2)


def _narrow_vit(mod, size):
    return mod.SamViTConfig(img_size=size, embed_dim=128, depth=2,
                            num_heads=2, window_size=14,
                            global_attn_indexes=(1,))


def _sam(variant, size):
    """(JAX config, JAX params, port config, port model)."""
    jcfg = jsam.make_config(variant, size)
    cfg = sam.make_config(variant, size)
    if variant == "vit_b":
        jcfg = dataclasses.replace(jcfg, encoder_vit=_narrow_vit(jvit, size))
        cfg = dataclasses.replace(cfg, encoder_vit=_narrow_vit(vit_sam, size))
    jparams = jsam.init_sam(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, cfg, load(sam.Sam(cfg), jparams)


@pytest.fixture(scope="module", params=[("mobile_sam", 64), ("vit_b", 128)],
                ids=["mobile_sam", "vit_b"])
def sam_frames(request):
    variant, size = request.param
    jcfg, jparams, cfg, model = _sam(variant, size)
    frames = np.random.default_rng(0).standard_normal(
        (4, size, size, 3)).astype(np.float32)
    return jcfg, jparams, cfg, model, frames


def test_encode_frames_matches_jax(sam_frames):
    jcfg, jparams, cfg, model, frames = sam_frames
    got = pbatch.encode_frames(model, cfg, torch.from_numpy(frames))
    want = np.asarray(jsam.encode_image(jparams, jcfg, jnp.asarray(frames)))
    g = cfg.image_size // 16
    assert got.shape == (4, g, g, 256) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_each_frame_equals_a_call_on_it_alone(sam_frames):
    _, _, cfg, model, frames = sam_frames
    batch = pbatch.encode_frames(model, cfg, torch.from_numpy(frames))
    for i in (0, 3):
        one = pbatch.encode_frames(model, cfg, torch.from_numpy(frames[i:i + 1]))
        np.testing.assert_allclose(batch[i].numpy(), one[0].numpy(),
                                   atol=1e-5, rtol=0)


def test_one_executable_per_key_and_no_aliasing(sam_frames):
    _, _, cfg, model, frames = sam_frames
    x = torch.from_numpy(frames)
    first = pbatch.encode_frames(model, cfg, x)
    kept = first.clone()
    keys = {k for k in pbatch._GRAPH_CACHE if k[1] is model}
    second = pbatch.encode_frames(model, cfg, x.flip(0))
    assert torch.equal(first, kept)  # the second call wrote elsewhere
    assert not torch.equal(first, second)
    assert {k for k in pbatch._GRAPH_CACHE if k[1] is model} == keys
    pbatch.encode_frames(model, cfg, x[:2])
    assert len({k for k in pbatch._GRAPH_CACHE if k[1] is model}) == len(keys) + 1


def test_a_mesh_of_two_devices_is_not_ported(sam_frames):
    """The name dates from when a mesh of two devices raised. It now runs:
    each dp row encodes its part of the batch through the single-device
    executable of its (device, key), so over two distinct CPU device
    objects every frame equals the call without a mesh bit for bit; a
    batch that dp does not divide raises, as in JAX (the mesh tier's
    tests are tests/test_torch_parallel.py)."""
    _, _, cfg, model, frames = sam_frames
    x = torch.from_numpy(frames)
    mesh = pmesh.make_mesh(2, dp=2, devices=[torch.device("cpu"),
                                             torch.device("cpu")])
    got = pbatch.encode_frames(model, cfg, x, mesh=mesh)
    assert torch.equal(got[:2], pbatch.encode_frames(model, cfg, x[:2]))
    assert torch.equal(got[2:], pbatch.encode_frames(model, cfg, x[2:]))
    with pytest.raises(DlimgError, match="must divide"):
        pbatch.encode_frames(model, cfg, x[:1], mesh=mesh)


def test_segment_frames_matches_jax():
    jcfg, jparams, cfg, model = slim_birefnet()
    frames = np.random.default_rng(4).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    got = pbatch.segment_frames(model, cfg, torch.from_numpy(frames))
    want = np.asarray(jbn.birefnet_apply(jax.tree_util.tree_map(
        jnp.asarray, jparams), jnp.asarray(frames), jcfg))
    assert got.shape == (2, 64, 64, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    one = pbatch.segment_frames(model, cfg, torch.from_numpy(frames[1:]))
    np.testing.assert_allclose(got[1].numpy(), one[0].numpy(), atol=1e-5,
                               rtol=0)
