"""SAM mask postprocessing (counterpart of dlimgedit_tpu/ops/postprocess.py).

The ONNX decoder's `mask_postprocessing` — bilinear low-res -> model input
size, crop to the pre-padded size, bilinear to the original size — is linear,
so it composes into ONE pair of (bucket x L) matrices: the whole
postprocess is two matrix products, a compare and a bit-pack. BiRefNet's
postprocess is ``sigmoid_to_u8``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .resample import resample_matrix


def _composed_axis_matrix(bucket: int, low: int, model_size: int, orig, crop,
                          device) -> torch.Tensor:
    """(bucket, low) matrix == resize(crop(resize(low->model_size))->orig)."""
    up = resample_matrix(model_size, low, model_size, low, antialias=False,
                         device=device)
    down = resample_matrix(bucket, model_size, orig, crop, antialias=False,
                           device=device)
    return down @ up


def upsample_matrices(low: int, bucket: int, model_size: int, orig_h, orig_w,
                      crop_h, crop_w, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (bucket, low) row and column matrices of ``upsample_mask_logits``."""
    return (_composed_axis_matrix(bucket, low, model_size, orig_h, crop_h, device),
            _composed_axis_matrix(bucket, low, model_size, orig_w, crop_w, device))


def upsample_with(R: torch.Tensor, C: torch.Tensor,
                  low_res: torch.Tensor) -> torch.Tensor:
    """``upsample_mask_logits`` with its matrices made beforehand."""
    x = torch.einsum("ih,bthw->btiw", R, low_res.float())
    return torch.einsum("btiw,jw->btij", x, C)


def upsample_mask_logits(low_res: torch.Tensor, bucket: int, model_size: int,
                         orig_h, orig_w, crop_h, crop_w) -> torch.Tensor:
    """low_res: (B, T, L, L) logits -> (B, T, bucket, bucket) logits at the
    original resolution (valid region [:orig_h, :orig_w], rest zero)."""
    R, C = upsample_matrices(low_res.shape[-1], bucket, model_size, orig_h,
                             orig_w, crop_h, crop_w, low_res.device)
    return upsample_with(R, C, low_res)


def pack_mask_bits(logits: torch.Tensor) -> torch.Tensor:
    """Threshold logits > 0 and pack 8 pixels per byte along the last axis,
    MSB first (np.unpackbits order): (..., W) -> (..., W//8) uint8."""
    *lead, w = logits.shape
    if w % 8:
        raise ValueError(f"width {w} not a multiple of 8")
    bits = (logits > 0).to(torch.uint8).reshape(*lead, w // 8, 8)
    # [128, 64, ..., 1], made on the device (no host copy).
    weights = torch.pow(2, torch.arange(7, -1, -1, device=bits.device))
    return (bits * weights.to(torch.uint8)).sum(dim=-1, dtype=torch.uint8)


def unpack_mask_bits(packed: np.ndarray, width: int) -> np.ndarray:
    """Host inverse of pack_mask_bits: (..., W//8) u8 -> (..., W) u8 {0,255}."""
    bits = np.unpackbits(packed, axis=-1, count=width)
    return bits * np.uint8(255)


def sigmoid_to_u8(logits: torch.Tensor) -> torch.Tensor:
    """BiRefNet postprocess: uint8(sigmoid(x) * 255) in float32, truncated
    like the reference's C cast (floor; sigmoid * 255 is never negative)."""
    v = torch.sigmoid(logits.float()) * 255.0
    return torch.floor(v).to(torch.uint8)
