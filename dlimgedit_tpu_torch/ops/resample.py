"""Dynamic-size separable resampling as dense matrix products (counterpart
of dlimgedit_tpu/ops/resample.py).

    out[:oh, :ow] = R @ img @ C^T,   R: (OH_bucket, IH), C: (OW_bucket, IW)

R/C are built on the device from the sizes (0-d device tensors or Python
numbers), so one code path serves every image size up to the bucket and the
host never waits for the device. Bilinear weights match torch
``interpolate(..., align_corners=False)``; with ``antialias=True``,
PIL-style antialiased bilinear.
"""

from __future__ import annotations

import torch


def _scalar(v, device) -> torch.Tensor:
    """A float32 0-d tensor on `device`: a device tensor is cast in place; a
    Python number is filled on the device (no host copy, which would wait
    for the work queued on the stream)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def resample_matrix(out_bucket: int, in_bucket: int, out_size, in_size,
                    antialias: bool = False, device=None) -> torch.Tensor:
    """(out_bucket, in_bucket) float32 bilinear resampling matrix. Row i
    (i < out_size) holds the weights of output pixel i over source pixels
    [0, in_size); other rows are zero."""
    if device is None:
        device = next((v.device for v in (out_size, in_size)
                       if isinstance(v, torch.Tensor)), torch.device("cpu"))
    out_size = _scalar(out_size, device)
    in_size = _scalar(in_size, device)
    dev = out_size.device
    i = torch.arange(out_bucket, dtype=torch.float32, device=dev)[:, None]
    j = torch.arange(in_bucket, dtype=torch.float32, device=dev)[None, :]
    scale = in_size / out_size
    src = torch.clamp((i + 0.5) * scale - 0.5, min=0.0)
    src = torch.minimum(src, in_size - 1.0)
    if antialias:
        # Stretch the triangle kernel when minifying (PIL semantics).
        kscale = torch.clamp(out_size / in_size, max=1.0)
    else:
        kscale = torch.ones((), dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - torch.abs(src - j) * kscale, min=0.0)
    valid = (i < out_size) & (j < in_size)
    w = torch.where(valid, w, torch.zeros((), device=dev))
    denom = w.sum(dim=1, keepdim=True)
    return torch.where(denom > 0, w / torch.clamp(denom, min=1e-20),
                       torch.zeros((), device=dev))


def apply_resample(R: torch.Tensor, Cm: torch.Tensor,
                   img: torch.Tensor) -> torch.Tensor:
    """Apply row/column resample matrices to (H, W, C) float data."""
    x = torch.einsum("ih,hwc->iwc", R, img)
    return torch.einsum("iwc,jw->ijc", x, Cm)
