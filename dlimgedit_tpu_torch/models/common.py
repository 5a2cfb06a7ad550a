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
  * BatchNorm is folded into a per-channel (scale, bias) affine;
  * an int8-quantised linear (ops/quant.py) is a ``QuantLinear`` holding
    ``w_q`` or ``w_q8`` (int8, (in, out)), ``w_scale`` (float32, (out,))
    and ``b``; ``cast_tree`` leaves int8 weights and ``w_scale`` alone.

Parameter containers are ``nn.Module``s whose attribute names are the JAX
tree's keys, so a ``state_dict`` key is the tree path joined with dots.
Random initialisation draws from a ``torch.Generator`` with the JAX
package's distributions; the numbers differ from ``jax.random``'s.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_norm import layer_norm_plain
from ..ops.quant import dequantize_weight, int8_linear


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
    truncated normal weight with a zero bias (TinyViT attention). The JAX
    package's ``linear`` adds "b" only when the tree holds it, so a tree
    without it loads (``convert.from_numpy.load_into`` drops the leaf)."""

    bias_optional = True

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


class QuantLinear(nn.Module):
    """An int8 linear (ops/quant.py ``quantize_encoder``): {"w_q": int8 (in,
    out)} for the weight-only product, or {"w_q8": ...} for the s8 x s8
    one, with {"w_scale": float32 (out,)} and an optional {"b"}. ``w_q8``
    is an (in, out) view of column-major storage: cuBLASLt's fast int8
    kernels take the product only in that layout ("TN"); with a row-major
    weight ``torch._int_mm`` falls back to a kernel ~5x slower on an
    H100."""

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor,
                 b: Optional[torch.Tensor] = None, act_int8: bool = False):
        super().__init__()
        if act_int8:
            self.w_q8 = _param(w_q.t().contiguous().t())
        else:
            self.w_q = _param(w_q)
        self.w_scale = _param(w_scale)
        if b is not None:
            self.b = _param(b)

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
# Float32 precision
# ---------------------------------------------------------------------------

_PRECISION_LOCK = threading.Lock()
_precision_depth = 0
_precision_saved: Optional[tuple] = None

# The per-operation ``fp32_precision`` flags (backend, operation) that may
# let a float32 product or convolution round its operands below float32:
# TF32 in cuBLAS and cuDNN, bf16 or TF32 in oneDNN on the CPU. cuDNN's RNN
# leaf is set with its conv leaf so that the legacy flag stays readable.
_LEAVES = (("cuda", "matmul"), ("cudnn", "conv"), ("cudnn", "rnn"),
           ("mkldnn", "matmul"), ("mkldnn", "conv"))


def _leaf(name):
    return getattr(getattr(torch.backends, name[0]), name[1])


def _legacy_flags():
    """The legacy flags as (get, set, the block's value, the leaves their
    setter also writes): PyTorch checks each against those leaves when it
    is read, and refuses a mix."""
    cudnn = torch.backends.cudnn
    return ((lambda: cudnn.allow_tf32,
             lambda v: setattr(cudnn, "allow_tf32", v), False,
             (("cudnn", "conv"), ("cudnn", "rnn"))),
            (torch.get_float32_matmul_precision,
             torch.set_float32_matmul_precision, "highest",
             (("cuda", "matmul"), ("mkldnn", "matmul"))))


@contextlib.contextmanager
def full_precision():
    """Float32 products and convolutions at full float32 precision inside the
    block, whatever the caller's TF32 flags (the JAX package's
    ``precision=HIGHEST``); bf16 operands are unaffected.

    PyTorch's flags are process-wide, so this holds for every thread while
    any block is open: the first block to enter sets them, the last to
    leave puts back the caller's values, and blocks may nest and run on
    several threads at once. The legacy flags are set along with the
    per-operation ones, so that other threads can still read them. A flag
    that another thread writes meanwhile takes effect at once, also for
    the work inside the block, and stands afterwards: a flag is put back
    only if it still holds the value the block set. A CUDA graph keeps the
    algorithms chosen at its capture, so a capture runs inside the
    block."""
    global _precision_depth, _precision_saved
    with _PRECISION_LOCK:
        if _precision_depth == 0:
            leaves = {n: _leaf(n).fp32_precision for n in _LEAVES}
            legacy = []
            for get, put, value, _ in _legacy_flags():
                try:
                    legacy.append(get())
                except RuntimeError:  # a mix the caller made: left alone
                    legacy.append(None)
                else:
                    put(value)
            _precision_saved = (legacy, leaves)
            for n in _LEAVES:
                _leaf(n).fp32_precision = "ieee"
        _precision_depth += 1
    try:
        yield
    finally:
        with _PRECISION_LOCK:
            _precision_depth -= 1
            if _precision_depth == 0:
                legacy, leaves = _precision_saved
                untouched = {n for n in _LEAVES
                             if _leaf(n).fp32_precision == "ieee"}
                for (_, put, _, own), old in zip(_legacy_flags(), legacy):
                    if old is not None and untouched.issuperset(own):
                        put(old)
                for n in untouched:
                    _leaf(n).fp32_precision = leaves[n]


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0,
           groups: int = 1) -> torch.Tensor:
    """NHWC conv with an OIHW kernel (the kernel follows x's dtype). Float32
    runs at full precision, as JAX's HIGHEST, inside ``full_precision``,
    which the runtime's executables enter (runtime/environment.py); a
    direct call takes the caller's flags."""
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


def linear(params: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """x @ w + b (b when the module holds one), dispatched on what the
    module holds: ``w_q8`` runs the s8 x s8 product (``int8_linear``),
    ``w_q`` is dequantised per call into the product, ``w`` is used as it
    is, and a tensor-parallel linear (parallel/mesh.py ``TPLinear``) runs
    its own forward over its devices."""
    if hasattr(params, "w_shards"):
        return params(x)
    if hasattr(params, "w_q8"):
        return int8_linear(params, x)
    if hasattr(params, "w_q"):
        w = dequantize_weight(params.w_q, params.w_scale, x.dtype)
    else:
        w = params.w.to(x.dtype)
    y = x @ w
    if hasattr(params, "b"):
        y = y + params.b.to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# Dtype policy
# ---------------------------------------------------------------------------

def cast_tree(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the floating parameters and buffers of ``module`` to ``dtype``,
    in place, as ``module.to(dtype)`` would, except every ``w_scale``: the
    int8 scales, taken from float32 weights, stay float32 (integer tensors
    are never cast). Returns ``module``."""
    for mod in module.modules():
        for table in (mod._parameters, mod._buffers):
            for name, t in table.items():
                if (t is None or name == "w_scale"
                        or not t.is_floating_point() or t.dtype == dtype):
                    continue
                if isinstance(t, nn.Parameter):
                    t.data = t.data.to(dtype)
                else:
                    table[name] = t.to(dtype)
    return module
