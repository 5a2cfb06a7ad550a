"""Shared building blocks (counterpart of dlimgedit_tpu/models/common.py).

Layout rules, kept from the JAX package so that tests compare like with
like:
  * activations are channels-last (NHWC); a convolution views its input as
    a channels_last NCHW tensor for ``F.conv2d`` (no copy) and returns
    NHWC;
  * linear weights are (in, out) and applied as ``x @ w``;
  * conv weights are OIHW (the JAX tree's HWIO, transposed once by
    ``convert.from_numpy``); the k == s transposed conv of the mask decoder
    keeps the same rule, (kh, kw, in, out) -> (out, in, kh, kw);
  * BatchNorm is folded into a per-channel (scale, bias) affine.

Parameter containers are ``nn.Module``s whose attribute names are the JAX
tree's keys, so a ``state_dict`` key is the tree path joined with dots.
Random initialisation draws from a ``torch.Generator`` with the JAX
package's distributions; the numbers differ from ``jax.random``'s.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_norm import layer_norm_plain


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU: the exact erf form in float32, the tanh approximation in
    bfloat16 (its error is below bf16's rounding step)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------

def trunc_normal(gen: torch.Generator, shape, std: float = 0.02) -> torch.Tensor:
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * std


def normal(gen: torch.Generator, shape, std: float = 1.0) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * std


def uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=gen)


def kaiming_uniform_conv(gen: torch.Generator, shape) -> torch.Tensor:
    """Torch Conv2d default init for an OIHW kernel."""
    _, cin, kh, kw = shape
    bound = math.sqrt(1.0 / (kh * kw * cin)) * math.sqrt(3.0)
    return uniform(gen, shape, bound)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Parameter containers (attribute names = JAX tree keys)
# ---------------------------------------------------------------------------

class Linear(nn.Module):
    """{"w": (in, out), "b": (out,)}; torch nn.Linear default init, or a
    truncated normal weight with a zero bias (TinyViT attention)."""

    def __init__(self, cin: int, cout: int, gen: torch.Generator,
                 trunc_std: Optional[float] = None):
        super().__init__()
        if trunc_std is None:
            bound = 1.0 / math.sqrt(cin)
            self.w = _param(uniform(gen, (cin, cout), bound))
            self.b = _param(uniform(gen, (cout,), bound))
        else:
            self.w = _param(trunc_normal(gen, (cin, cout), trunc_std))
            self.b = _param(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self, x)


class Conv(nn.Module):
    """{"w": OIHW} with an optional {"b"} (zeros at init)."""

    def __init__(self, cin: int, cout: int, ks: int, gen: torch.Generator,
                 groups: int = 1, with_bias: bool = False):
        super().__init__()
        self.w = _param(kaiming_uniform_conv(gen, (cout, cin // groups, ks, ks)))
        if with_bias:
            self.b = _param(torch.zeros(cout))


class ConvBN(nn.Module):
    """Conv2d_BN (TinyViT) with the BN folded to (scale, bias)."""

    def __init__(self, cin: int, cout: int, ks: int, gen: torch.Generator,
                 groups: int = 1, bn_weight_init: float = 1.0):
        super().__init__()
        self.w = _param(kaiming_uniform_conv(gen, (cout, cin // groups, ks, ks)))
        self.scale = _param(torch.full((cout,), bn_weight_init))
        self.bias = _param(torch.zeros(cout))
        self.groups = groups

    def forward(self, x: torch.Tensor, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
        return conv_bn(self, x, stride, padding, self.groups)


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = _param(torch.ones(dim))
        self.bias = _param(torch.zeros(dim))


class Mlp(nn.Module):
    """TinyViT MLP: {"norm", "fc1", "fc2"}."""

    def __init__(self, dim: int, hidden: int, gen: torch.Generator):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fc1 = Linear(dim, hidden, gen)
        self.fc2 = Linear(hidden, dim, gen)


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0,
           groups: int = 1) -> torch.Tensor:
    """NHWC conv with an OIHW kernel (the kernel follows x's dtype)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), stride=stride,
                 padding=padding, groups=groups)
    # A channels_last result makes this a no-op.
    return y.permute(0, 2, 3, 1).contiguous()


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """NHWC transposed conv with kernel_size == stride (non-overlapping), the
    SAM mask-decoder upscaler: a per-pixel product plus pixel-shuffle,
      out[b, s*i+p, s*j+q, o] = sum_c x[b,i,j,c] * w[o,c,p,q].
    Kernel layout (out, in, k, k)."""
    if stride != w.shape[2]:
        raise ValueError(f"conv_transpose2d implements the k == s case only; "
                         f"got kernel {w.shape[2]} with stride {stride}")
    B, H, W, _ = x.shape
    k = w.shape[2]
    O = w.shape[0]
    y = torch.einsum("bhwc,ocpq->bhpwqo", x, w.to(x.dtype))
    return y.reshape(B, H * k, W * k, O)


def conv_bn(params: ConvBN, x: torch.Tensor, stride: int = 1, padding: int = 0,
            groups: int = 1) -> torch.Tensor:
    y = conv2d(x, params.w, stride, padding, groups)
    return y * params.scale.to(y.dtype) + params.bias.to(y.dtype)


def layer_norm(params: LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis (also SAM's LayerNorm2d on NHWC), with
    one-pass statistics as in the JAX package (``layer_norm_plain``)."""
    return layer_norm_plain(x, params.scale, params.bias, eps)


def linear(params: Linear, x: torch.Tensor) -> torch.Tensor:
    y = x @ params.w.to(x.dtype)
    if hasattr(params, "b"):
        y = y + params.b.to(x.dtype)
    return y
