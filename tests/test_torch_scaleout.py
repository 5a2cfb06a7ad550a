"""Options.scaleout_devices through the port's public runtime surface
(Environment / Segmentation / segment_objects), on the CPU; JAX's
tests/test_scaleout.py is the model (its ViT and mesh-rule cases).

JAX's tests see 8 virtual CPU devices. The port's Environment lists its
backend's distinct devices through ``runtime.environment.backend_devices``
(every CUDA device, or the one CPU); the tests patch that seam to
``[cpu] * 8``. With a mesh the ViT variants embed sequence-parallel
(parallel/sp.py): the embedding must match the single-device program
within atol 2e-5, rtol 1e-5 (JAX's tolerance for this degenerate
geometry, grid 4 < window 14) and the masks must be equal. MobileSAM and
BiRefNet run on canvas-row bands (parallel/spatial.py), with JAX's limits
(tests/test_scaleout.py): the MobileSAM embedding within atol 2e-4, rtol
1e-4 of one device's and under 5e-3 of the mask's pixels flipped;
BiRefNet's uint8 mask (slim, resolution 64) at most 1 quantum off, on
under 5e-3 of the pixels. Every mesh program is eager (not graphed).
"""

import numpy as np
import pytest
import torch

import dlimgedit_tpu_torch as pdl
from dlimgedit_tpu_torch.runtime import environment as renv

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture
def eight_devices(monkeypatch):
    monkeypatch.setattr(renv, "backend_devices", lambda device: [CPU] * 8)


def _opts(**kw):
    base = dict(backend=pdl.Backend.cpu, allow_random_weights=True,
                compute_dtype="float32", sam_image_size=64)
    base.update(kw)
    return pdl.Options(**base)


def _image(w=96, h=64, seed=0, channels=pdl.Channels.rgba):
    rng = np.random.default_rng(seed)
    n = {pdl.Channels.rgba: 4, pdl.Channels.rgb: 3}[channels]
    return pdl.Image(pdl.Extent(w, h), channels,
                     rng.integers(0, 256, (h, w, n), dtype=np.uint8))


def test_one_cpu_device_serves_without_a_mesh():
    assert renv.backend_devices(CPU) == [CPU]
    assert pdl.Environment(_opts(scaleout_devices=0)).mesh is None


def test_mesh_construction_rules(eight_devices):
    env = pdl.Environment(_opts(scaleout_devices=0))  # every device
    assert env.mesh is not None and env.mesh.shape == {"sp": 8}
    assert pdl.Environment(_opts()).mesh is None  # 1 (the default): off
    assert pdl.Environment(_opts(scaleout_devices=4)).mesh.shape == {"sp": 4}
    assert pdl.Environment(_opts(scaleout_devices=99)).mesh.shape == {"sp": 8}


def test_vit_process_parity(eight_devices):
    img = _image(seed=1)
    env1 = pdl.Environment(_opts(sam_variant="vit_b"))
    env8 = pdl.Environment(_opts(sam_variant="vit_b", scaleout_devices=0))
    seg1 = pdl.Segmentation.process(img, env1)
    seg8 = pdl.Segmentation.process(img, env8)
    key = next(k for k in env8.executables if k[0] == "embed")
    assert not env8.executables[key].graphed  # the program crosses devices
    np.testing.assert_allclose(seg8.embedding.numpy(), seg1.embedding.numpy(),
                               atol=2e-5, rtol=1e-5)
    np.testing.assert_array_equal(seg8.compute_mask(pdl.Point(20, 20)).pixels,
                                  seg1.compute_mask(pdl.Point(20, 20)).pixels)


def test_mobile_sam_process_parity(eight_devices):
    img = _image()
    env1 = pdl.Environment(_opts())
    env8 = pdl.Environment(_opts(scaleout_devices=0))
    seg1 = pdl.Segmentation.process(img, env1)
    seg8 = pdl.Segmentation.process(img, env8)
    key = next(k for k in env8.executables if k[0] == "embed")
    assert not env8.executables[key].graphed  # the program crosses devices
    np.testing.assert_allclose(seg8.embedding.numpy(), seg1.embedding.numpy(),
                               atol=2e-4, rtol=1e-4)
    m1 = seg1.compute_mask(pdl.Point(20, 20)).pixels
    m8 = seg8.compute_mask(pdl.Point(20, 20)).pixels
    assert np.mean(m1 != m8) < 5e-3


def test_birefnet_segment_objects_parity(eight_devices, monkeypatch):
    monkeypatch.setenv("DLIMG_BIREFNET_TEST_SLIM", "1")
    monkeypatch.setenv("DLIMG_BIREFNET_RESOLUTION", "64")
    img = _image(w=96, h=48, seed=2, channels=pdl.Channels.rgb)
    env8 = pdl.Environment(_opts(scaleout_devices=0))
    m1 = pdl.segment_objects(img, pdl.Environment(_opts())).pixels
    m8 = pdl.segment_objects(img, env8).pixels
    assert m8.shape == m1.shape == (48, 96, 1)
    key = next(k for k in env8.executables if k[0] == "birefnet")
    assert not env8.executables[key].graphed
    d = np.abs(m1.astype(np.int32) - m8.astype(np.int32))
    assert d.max() <= 1 and np.mean(d > 0) < 5e-3
