"""Fused LayerNorm over the channel (last) axis — kernel K1.

Counterpart of dlimgedit_tpu/ops/fused_norm.py:64 ``fused_layer_norm``.
On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/fused_layer_norm.cu`` (one read and one write of the activation,
float32 statistics in registers). On a CPU tensor it computes the plain
PyTorch version, ``layer_norm_plain``, which is also what
``models.common.layer_norm`` runs.
"""

from __future__ import annotations

import torch

from ..errors import DlimgError
from .cuda_build import DTYPE_CODES, LIBRARY, check_launch

# Row widths the CUDA kernel is instantiated for (csrc/fused_layer_norm.cu):
# TinyViT's stages (128, 160, 320) and its neck (256).
KERNEL_WIDTHS = (128, 160, 256, 320)


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with one-pass float32 statistics,
    E[x^2] - E[x]^2 clamped at 0 (``F.layer_norm`` takes two passes and is
    not the same function). The result has x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    mean_sq = (x32 * x32).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _check(x, scale, bias):
    C = x.shape[-1]
    if tuple(scale.shape) != (C,) or tuple(bias.shape) != (C,):
        raise DlimgError(f"fused_layer_norm: scale {tuple(scale.shape)} and "
                         f"bias {tuple(bias.shape)} must be ({C},)")
    if not (x.device == scale.device == bias.device):
        raise DlimgError("fused_layer_norm: x, scale and bias must share a "
                         "device")
    if not x.is_cuda:
        return
    if str(x.dtype) not in DTYPE_CODES:
        raise DlimgError(f"fused_layer_norm: the CUDA kernel takes float32 "
                         f"or bfloat16, not {x.dtype}")
    if scale.dtype != x.dtype or bias.dtype != x.dtype:
        raise DlimgError("fused_layer_norm: scale and bias must have x's "
                         "dtype on CUDA")
    if C not in KERNEL_WIDTHS:
        raise DlimgError(f"fused_layer_norm: no CUDA kernel for width {C} "
                         f"(have {KERNEL_WIDTHS})")
    if not (x.is_contiguous() and scale.is_contiguous()
            and bias.is_contiguous()):
        raise DlimgError("fused_layer_norm: inputs must be contiguous")


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of a tensor of any rank.

    CUDA tensors go through the K1 kernel (and count one launch in
    ``fused_layer_norm.launches``); CPU tensors through
    ``layer_norm_plain``."""
    _check(x, scale, bias)
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    if not x.is_cuda:
        raise DlimgError(f"fused_layer_norm: unsupported device {x.device}")
    out = torch.empty_like(x)
    C = x.shape[-1]
    rows = x.numel() // C if C else 0
    lib = LIBRARY.get()
    rc = lib.dlimg_layer_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        rows, C, DTYPE_CODES[str(x.dtype)], float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("fused_layer_norm", rc)
    fused_layer_norm.launches += 1
    return out


fused_layer_norm.launches = 0
