"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: skipped where no CUDA device is present (the decision is
taken inside the tests, never at import). This file imports neither jax
nor the JAX package, so on a GPU machine without JAX it runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

chip_smoke.py runs the same comparisons at the main path's full shapes.
Tolerances as there: float32 atol 1e-5 (LayerNorm) / 2e-5 (attention),
bf16 atol 2e-2.
"""

import pytest
import torch

from dlimgedit_tpu_torch.errors import DlimgError
from dlimgedit_tpu_torch.ops.flash_attention import (
    levit_window_attention,
    levit_window_attention_plain,
)
from dlimgedit_tpu_torch.ops.fused_norm import fused_layer_norm, layer_norm_plain

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (2e-2, 2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,eps", [((3 * 49, 128), 1e-5), ((2, 7, 160), 1e-5),
                                       ((33, 320), 1e-5), ((1, 4, 4, 256), 1e-6)])
def test_fused_layer_norm_kernel_matches_plain(dev, shape, eps, dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    C = shape[-1]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    scale = (0.25 + 0.5 * torch.rand(C, generator=g, device=dev)).to(dtype)
    bias = (0.5 * torch.rand(C, generator=g, device=dev) - 0.25).to(dtype)
    before = fused_layer_norm.launches
    got = fused_layer_norm(x, scale, bias, eps)
    torch.cuda.synchronize()
    assert fused_layer_norm.launches == before + 1
    want = layer_norm_plain(x, scale, bias, eps)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype][0],
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,N,nh", [(3, 49, 4), (2, 196, 5), (5, 17, 2), (1, 256, 1)])
def test_levit_attention_kernel_matches_plain(dev, G, N, nh, dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn((G, N, nh * 96), generator=g, device=dev).to(dtype)
    bias = (0.5 * torch.randn((nh, N, N), generator=g, device=dev)).to(dtype)
    before = levit_window_attention.launches
    got = levit_window_attention(qkv, bias, nh)
    torch.cuda.synchronize()
    assert levit_window_attention.launches == before + 1
    want = levit_window_attention_plain(qkv, bias, nh)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype][1],
                               rtol=0)


def test_kernels_raise_instead_of_falling_back(dev):
    x = torch.zeros(4, 96, device=dev)  # no kernel for C = 96
    with pytest.raises(DlimgError):
        fused_layer_norm(x, torch.ones(96, device=dev), torch.zeros(96, device=dev))
    qkv = torch.zeros(2, 49, 4 * 3 * 16, device=dev)  # head width 16
    with pytest.raises(DlimgError):
        levit_window_attention(qkv, torch.zeros(4, 49, 49, device=dev), 4)
    x = torch.zeros(4, 128, device=dev, dtype=torch.float16)
    with pytest.raises(DlimgError):
        fused_layer_norm(x, torch.ones(128, device=dev, dtype=torch.float16),
                         torch.zeros(128, device=dev, dtype=torch.float16))
