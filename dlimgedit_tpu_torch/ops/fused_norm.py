"""Fused LayerNorm over the channel (last) axis — kernels K1 and K3.

Counterparts of dlimgedit_tpu/ops/fused_norm.py:64 ``fused_layer_norm``
(K1) and :98 ``fused_add_layer_norm`` (K3, residual add + LayerNorm). On a
CUDA tensor each wrapper launches its hand-written kernel in
``csrc/fused_layer_norm.cu`` (one read and one write of each activation,
float32 statistics in registers; the kernels move 16 bytes a lane at a
time, so every operand goes through ``kernel_operand``: dense and on a
16-byte boundary). The kernels take float32, bfloat16 and float16 (JAX
rounds float16 as bf16: float32 statistics, the output rounded once, K3's
s rounded and read back). Any width C >= 1 is taken: the widths of
``KERNEL_WIDTHS`` have instances of their own, other widths a masked
last chunk (rows of up to 160 chunks on 4-32 lanes) or a block a row
(wider rows). On a CPU tensor it computes the plain PyTorch version,
``layer_norm_plain`` or ``fused_add_layer_norm_plain``; the first is also
what ``models.common.layer_norm`` runs.
"""

from __future__ import annotations

import torch

from ..errors import DlimgError
from .cuda_build import (DTYPE_CODES, KERNEL_DTYPES, LIBRARY, check_launch,
                         kernel_operand)

# Row widths with instances of their own in csrc/fused_layer_norm.cu (the
# main paths' widths): TinyViT's stages (128, 160, 320) and its neck (256);
# the SAM ViT-B, -L and -H embeddings (768, 1024, 1280). Every other width
# runs the width-generic kernels.
KERNEL_WIDTHS = (128, 160, 256, 320, 768, 1024, 1280)


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with one-pass float32 statistics,
    E[x^2] - E[x]^2 clamped at 0 (``F.layer_norm`` takes two passes and is
    not the same function). The result has x's dtype. A mean is the sum
    times float32(1 / C), as XLA forms JAX's ``jnp.mean``: at small C the
    one-pass variance turns the last bit of the mean into ~1e-4 of the
    output, so the rounding must be the reference's."""
    x32 = x.float()
    inv_c = 1.0 / x.shape[-1] if x.shape[-1] else float("nan")
    mean = x32.sum(dim=-1, keepdim=True) * inv_c
    mean_sq = (x32 * x32).sum(dim=-1, keepdim=True) * inv_c
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def fused_add_layer_norm_plain(x: torch.Tensor, delta: torch.Tensor,
                               scale: torch.Tensor, bias: torch.Tensor,
                               eps: float):
    """(s, LN(s)) with s = x + delta rounded to x's dtype; the statistics
    are those of the rounded s, as in the unfused add -> LayerNorm chain."""
    s = (x.float() + delta.float()).to(x.dtype)
    return s, layer_norm_plain(s, scale, bias, eps)


def _check(name, x, scale, bias, delta=None):
    C = x.shape[-1]
    if tuple(scale.shape) != (C,) or tuple(bias.shape) != (C,):
        raise DlimgError(f"{name}: scale {tuple(scale.shape)} and "
                         f"bias {tuple(bias.shape)} must be ({C},)")
    tensors = (x, scale, bias) + (() if delta is None else (delta,))
    if delta is not None and delta.shape != x.shape:
        raise DlimgError(f"{name}: delta {tuple(delta.shape)} must have x's "
                         f"shape {tuple(x.shape)}")
    if any(t.device != x.device for t in tensors):
        raise DlimgError(f"{name}: all inputs must share a device")
    if not x.is_cuda:
        return
    if str(x.dtype) not in DTYPE_CODES:
        raise DlimgError(f"{name}: the CUDA kernel takes {KERNEL_DTYPES}, "
                         f"not {x.dtype}")
    if any(t.dtype != x.dtype for t in tensors):
        raise DlimgError(f"{name}: every input must have x's dtype on CUDA")


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of a tensor of any rank.

    CUDA tensors go through the K1 kernel (and count one launch in
    ``fused_layer_norm.launches``); CPU tensors through
    ``layer_norm_plain``."""
    _check("fused_layer_norm", x, scale, bias)
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    if not x.is_cuda:
        raise DlimgError(f"fused_layer_norm: unsupported device {x.device}")
    x, scale, bias = (kernel_operand(t) for t in (x, scale, bias))
    out = torch.empty_like(x)
    C = x.shape[-1]
    rows = x.numel() // C if C else 0
    lib = LIBRARY.get()
    rc = lib.dlimg_layer_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        rows, C, DTYPE_CODES[str(x.dtype)], float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("fused_layer_norm", rc, f"{rows} rows of {C}, {x.dtype}")
    fused_layer_norm.launches += 1
    return out


fused_layer_norm.launches = 0


def fused_add_layer_norm(x: torch.Tensor, delta: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor,
                         eps: float = 1e-6):
    """Residual add + LayerNorm in one pass: returns (s, LN(s)) with
    s = x + delta in x's dtype.

    CUDA tensors go through the K3 kernel (and count one launch in
    ``fused_add_layer_norm.launches``); CPU tensors through
    ``fused_add_layer_norm_plain``."""
    _check("fused_add_layer_norm", x, scale, bias, delta)
    if x.device.type == "cpu":
        return fused_add_layer_norm_plain(x, delta, scale, bias, eps)
    if not x.is_cuda:
        raise DlimgError(f"fused_add_layer_norm: unsupported device {x.device}")
    x, delta, scale, bias = (kernel_operand(t) for t in (x, delta, scale, bias))
    s = torch.empty_like(x)
    out = torch.empty_like(x)
    C = x.shape[-1]
    rows = x.numel() // C if C else 0
    lib = LIBRARY.get()
    rc = lib.dlimg_add_layer_norm(
        x.data_ptr(), delta.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        s.data_ptr(), out.data_ptr(), rows, C, DTYPE_CODES[str(x.dtype)],
        float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("fused_add_layer_norm", rc, f"{rows} rows of {C}, {x.dtype}")
    fused_add_layer_norm.launches += 1
    return s, out


fused_add_layer_norm.launches = 0
