"""The port's kernel modules against the JAX package's Pallas kernels, run
in interpret mode on the CPU. On CPU tensors the port's wrappers compute
their plain PyTorch versions; the CUDA kernels themselves are held against
those plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: float32 atol 1e-5 (LayerNorm) and 2e-5 (attention), the
order-of-summation noise of float32 reductions; bfloat16 atol 2e-2, a bit
more than one bf16 rounding step at |y| < 4 (inputs are made from one seed
with numpy and rounded to bf16 identically on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlimgedit_tpu.ops.flash_attention import (
    levit_window_attention as jax_levit_window_attention,
)
from dlimgedit_tpu.ops.fused_norm import fused_layer_norm as jax_fused_layer_norm
from dlimgedit_tpu_torch.errors import DlimgError
from dlimgedit_tpu_torch.ops.flash_attention import (
    levit_window_attention,
    levit_window_attention_plain,
)
from dlimgedit_tpu_torch.ops.fused_norm import fused_layer_norm, layer_norm_plain

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LN_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
ATTN_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,eps", [
    ((3 * 49, 128), 1e-5),    # stage-1 windows
    ((2, 7, 160), 1e-5),      # stage 2, rank 3
    ((5, 320), 1e-5),         # stage 3
    ((1, 4, 4, 256), 1e-6),   # neck, NHWC
])
def test_fused_layer_norm_matches_pallas(shape, eps, dtype):
    rng = np.random.default_rng(0)
    C = shape[-1]
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    scale = rng.uniform(0.25, 0.75, C).astype(np.float32)
    bias = rng.uniform(-0.25, 0.25, C).astype(np.float32)
    (jx, tx), (js, ts), (jb, tb) = (_pair(a, dtype) for a in (x, scale, bias))
    want = jax_fused_layer_norm(jx, js, jb, eps=eps, interpret=True)
    launches = fused_layer_norm.launches
    got = fused_layer_norm(tx, ts, tb, eps=eps)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert fused_layer_norm.launches == launches  # CPU: the plain version
    np.testing.assert_allclose(_f32(got), _f32(want), atol=LN_ATOL[dtype], rtol=0)
    torch.testing.assert_close(got, layer_norm_plain(tx, ts, tb, eps),
                               atol=0, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,window,nh", [(3, 7, 4), (2, 14, 5)])
def test_levit_window_attention_matches_pallas(G, window, nh, dtype):
    rng = np.random.default_rng(1)
    N, kd = window * window, 32
    qkv = rng.standard_normal((G, N, nh * 3 * kd)).astype(np.float32)
    bias = (0.5 * rng.standard_normal((nh, N, N))).astype(np.float32)
    (jq, tq), (jb, tb) = _pair(qkv, dtype), _pair(bias, dtype)
    want = jax_levit_window_attention(jq, jb, num_heads=nh, interpret=True)
    launches = levit_window_attention.launches
    got = levit_window_attention(tq, tb, nh)
    assert got.dtype == tq.dtype and got.shape == (G, N, nh * kd)
    assert levit_window_attention.launches == launches
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATTN_ATOL[dtype],
                               rtol=0)
    torch.testing.assert_close(got, levit_window_attention_plain(tq, tb, nh),
                               atol=0, rtol=0)


def test_levit_attention_bias_reaches_every_head():
    """Each head reads its own bias plane and writes its own kd columns: a
    bias on head 1 only changes head 1's output."""
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((1, 49, 2 * 3 * 32)).astype(np.float32))
    bias = torch.zeros(2, 49, 49)
    base = levit_window_attention(qkv, bias, 2)
    bias[1] = torch.from_numpy(rng.standard_normal((49, 49)).astype(np.float32))
    moved = levit_window_attention(qkv, bias, 2)
    torch.testing.assert_close(moved[..., :32], base[..., :32], atol=0, rtol=0)
    assert (moved[..., 32:] - base[..., 32:]).abs().max() > 1e-3


@pytest.mark.parametrize("case", ["scale_shape", "bias_shape"])
def test_fused_layer_norm_rejects_bad_params(case):
    x = torch.zeros(4, 128)
    scale, bias = torch.ones(128), torch.zeros(128)
    if case == "scale_shape":
        scale = torch.ones(64)
    else:
        bias = torch.zeros(1, 128)
    with pytest.raises(DlimgError):
        fused_layer_norm(x, scale, bias)


@pytest.mark.parametrize("case", ["heads", "bias_shape", "rank"])
def test_levit_window_attention_rejects_bad_shapes(case):
    qkv, bias, nh = torch.zeros(2, 49, 384), torch.zeros(4, 49, 49), 4
    if case == "heads":
        nh = 5
    elif case == "bias_shape":
        bias = torch.zeros(4, 49, 48)
    else:
        qkv = torch.zeros(98, 384)
    with pytest.raises(DlimgError):
        levit_window_attention(qkv, bias, nh)
