"""The port's training data (dlimgedit_tpu_torch/train/data.py) on the CPU
(JAX's tests/test_train_data.py is the model): the prefetcher keeps order,
content and depth; without a CUDA device it raises unless the caller asks
for the CPU; ``sam_batch_iterator`` draws JAX's batches from one seed, bit
for bit, and drives the port's train step. The CUDA copy stream is held
on the card (tests/test_torch_cuda.py, marked ``cuda``)."""

import numpy as np
import pytest
import torch

from dlimgedit_tpu.train.data import sam_batch_iterator as jax_iterator
from dlimgedit_tpu_torch.errors import DlimgError
from dlimgedit_tpu_torch.models import sam
from dlimgedit_tpu_torch.train import data, step

torch.set_num_threads(2)


def _host_batches(n):
    for i in range(n):
        yield {"x": np.full((4, 3), i, np.float32),
               "y": [np.arange(4, dtype=np.int32) + 10 * i]}


def test_prefetch_keeps_order_and_content():
    got = list(data.prefetch_to_device(_host_batches(5), depth=2,
                                       device="cpu"))
    assert len(got) == 5
    for i, b in enumerate(got):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        np.testing.assert_array_equal(b["x"].numpy(),
                                      np.full((4, 3), i, np.float32))
        assert isinstance(b["y"], list)
        np.testing.assert_array_equal(b["y"][0].numpy(),
                                      np.arange(4, dtype=np.int32) + 10 * i)


@pytest.mark.parametrize("depth,n", [(3, 6), (4, 1), (1, 3)])
def test_prefetch_keeps_depth_batches_in_flight(depth, n):
    pulled = []

    def tracked():
        for i in range(n):
            pulled.append(i)
            yield {"x": np.full((2,), i, np.float32)}

    it = data.prefetch_to_device(tracked(), depth=depth, device="cpu")
    first = next(it)
    # Yielding batch 0 has placed batches 0 .. depth (depth beyond it).
    assert pulled == list(range(min(depth + 1, n)))
    np.testing.assert_array_equal(first["x"].numpy(), np.zeros(2, np.float32))
    assert len(list(it)) == n - 1


def test_prefetch_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DlimgError, match="no CUDA device"):
        next(data.prefetch_to_device(_host_batches(1)))
    with pytest.raises(DlimgError, match="depth"):
        next(data.prefetch_to_device(_host_batches(1), depth=0, device="cpu"))


def test_sam_batch_iterator_draws_jax_batches():
    kw = dict(batch_size=2, image_size=64, mask_size=16, steps=3)
    got = list(data.sam_batch_iterator(np.random.default_rng(7), **kw))
    want = list(jax_iterator(np.random.default_rng(7), **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_sam_batch_iterator_drives_the_train_step():
    cfg = sam.make_config("mobile_sam", 64)
    model = sam.Sam(cfg)
    tcfg = step.TrainConfig()
    state = step.init_train_state(model, tcfg)
    train = step.make_train_step(cfg, tcfg)
    it = data.sam_batch_iterator(np.random.default_rng(0), batch_size=2,
                                 image_size=64, mask_size=cfg.mask_input_size,
                                 steps=2)
    losses = []
    for batch in data.prefetch_to_device(it, depth=2, device="cpu"):
        model, state, loss, _ = train(model, state, batch)
        losses.append(float(loss))
    assert len(losses) == 2 and all(np.isfinite(losses))
