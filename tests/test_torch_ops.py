"""The port's pre- and post-processing ops against the JAX package's, on
inputs made with numpy from a seed: sam_preprocess (device resample,
normalise, pad), upsample_mask_logits, the mask bit-pack and the
largest-connected-component selection. float32; atol 1e-4 on values of
order 1-100 (matrix products summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlimgedit_tpu.ops import connected as jax_connected
from dlimgedit_tpu.ops import postprocess as jax_post
from dlimgedit_tpu.ops import preprocess as jax_pre
from dlimgedit_tpu_torch.ops import connected, postprocess, preprocess
from dlimgedit_tpu_torch.types import Channels, Extent, ImageView

torch.set_num_threads(2)


@pytest.mark.parametrize("h,w,bucket", [(64, 96, 256), (200, 300, 512), (37, 23, 256)])
def test_sam_preprocess_matches_jax(h, w, bucket):
    rng = np.random.default_rng(h)
    px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    view = ImageView(px, Extent(w, h), Channels.rgba)
    canvas = preprocess.pack_rgb_canvas(view, bucket)
    s = 64 / max(h, w)
    oh, ow = int(h * s + 0.5), int(w * s + 0.5)
    want = jax_pre.sam_preprocess(jnp.asarray(canvas), h, w, oh, ow, image_size=64)
    sizes = torch.tensor([h, w, oh, ow], dtype=torch.int32)
    got = preprocess.sam_preprocess(torch.from_numpy(canvas), sizes[0], sizes[1],
                                    sizes[2], sizes[3], image_size=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_canvas_pack_channel_maps():
    px = np.arange(2 * 3 * 4, dtype=np.uint8).reshape(2, 3, 4)
    for ch, order in ((Channels.rgba, (0, 1, 2)), (Channels.bgra, (2, 1, 0)),
                      (Channels.argb, (1, 2, 3))):
        canvas = preprocess.pack_rgb_canvas(ImageView(px, Extent(3, 2), ch), 8)
        np.testing.assert_array_equal(canvas[:2, :3], px[..., list(order)])
        assert not canvas[2:].any() and not canvas[:, 3:].any()


def test_pick_bucket_matches_jax():
    for m in (1, 256, 257, 1024, 1500, 2048, 4097, 5000):
        e = Extent(m, 7)
        assert preprocess.pick_bucket(e) == jax_pre.pick_bucket(e)


def test_upsample_mask_logits_matches_jax():
    rng = np.random.default_rng(3)
    low = rng.standard_normal((1, 3, 16, 16)).astype(np.float32)
    want = jax_post.upsample_mask_logits(jnp.asarray(low), 256, 64, 64, 96, 43, 64)
    sizes = torch.tensor([64, 96, 43, 64], dtype=torch.int32)
    got = postprocess.upsample_mask_logits(torch.from_numpy(low), 256, 64,
                                           *sizes.unbind())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_mask_bits_round_trip_matches_jax():
    logits = np.random.default_rng(4).standard_normal((2, 5, 64)).astype(np.float32)
    want = np.asarray(jax_post.pack_mask_bits(jnp.asarray(logits)))
    got = postprocess.pack_mask_bits(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(postprocess.unpack_mask_bits(got, 64),
                                  np.where(logits > 0, 255, 0).astype(np.uint8))


def _serpentine(n: int) -> np.ndarray:
    m = np.zeros((n, n), bool)
    m[::2] = True
    for r in range(1, n, 2):
        m[r, -1 if (r // 2) % 2 == 0 else 0] = True
    return m


@pytest.mark.parametrize("case", ["random", "serpentine", "empty"])
def test_largest_component_matches_jax(case):
    rng = np.random.default_rng(5)
    if case == "random":
        masks = rng.random((3, 40, 40)) > 0.45
    elif case == "serpentine":
        masks = np.stack([_serpentine(32), _serpentine(32).T])
    else:
        masks = np.zeros((1, 8, 8), bool)
    want = np.asarray(jax.vmap(jax_connected.largest_component_mask)(
        jnp.asarray(masks)))
    got = connected.largest_component_mask(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(got, want)
