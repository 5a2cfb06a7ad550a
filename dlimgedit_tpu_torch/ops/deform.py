"""Modulated deformable convolution v2, NHWC (counterpart of
dlimgedit_tpu/ops/deform.py): torchvision's ``deform_conv2d`` semantics,
the op inside BiRefNet's ASPPDeformable. Stride 1, dilation 1, one offset
group: the only configuration BiRefNet uses.

The tap loop accumulates, for each of the K = kh * kw taps,
    bilinear gather -> modulate -> 1x1 product (float32)
so the sampled activations are never held as a (H, W, K, C) tensor. One
gather per tap fetches all four bilinear corners from a corner stack (the
input zero-padded and its four 2x2 shifts concatenated on channels).

The JAX package bands the output rows to keep XLA's TPU fusion; that is
not part of the result, and this version computes the whole image per
tap (one tap's temporaries at BiRefNet's largest deform, 512 x 512 x 64
at resolution 2048, are ~0.3 GB).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _bilinear_sample(x: torch.Tensor, py: torch.Tensor, px: torch.Tensor
                     ) -> torch.Tensor:
    """Sample x (B, H, W, C) at float positions (py, px) (B, H', W') with
    bilinear interpolation; taps outside the image contribute zero. The
    four-gather form: the oracle that the corner-stack form is held to."""
    B, H, W, C = x.shape
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    wy = (py - y0)[..., None]
    wx = (px - x0)[..., None]
    flat = x.reshape(B, H * W, C)
    oh, ow = py.shape[-2:]

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yc = torch.clamp(yi, 0, H - 1).to(torch.int64)
        xc = torch.clamp(xi, 0, W - 1).to(torch.int64)
        idx = (yc * W + xc).reshape(B, oh * ow, 1).expand(B, oh * ow, C)
        v = torch.gather(flat, 1, idx).reshape(B, oh, ow, C)
        return v * inb[..., None].to(v.dtype)

    return (tap(y0, x0) * (1 - wy) * (1 - wx)
            + tap(y0, x0 + 1) * (1 - wy) * wx
            + tap(y0 + 1, x0) * wy * (1 - wx)
            + tap(y0 + 1, x0 + 1) * wy * wx)


def _corner_stack(x: torch.Tensor, int8: bool = False):
    """The 4-corner map for stacked bilinear sampling: x padded by (1 top /
    left, 2 bottom / right) with zeros and its four 2x2-corner shifts
    concatenated on channels, (B, (H+2) * (W+2), 4C), so one row gather at
    (y0 + 1, x0 + 1) fetches all four corners, and corners off the image
    read zeros, for any y0 in [-1, H], x0 in [-1, W].

    ``int8=True`` quantises the stack symmetrically, scale = max|x| / 127,
    computed on the device (a 0-d tensor: nothing is read back to the
    host). -> (stack, (H, W, W + 2), scale or None)."""
    B, H, W, C = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 2, 1, 2))
    stack = torch.cat([xp[:, :-1, :-1], xp[:, :-1, 1:],
                       xp[:, 1:, :-1], xp[:, 1:, 1:]], dim=-1)
    stack = stack.reshape(B, (H + 2) * (W + 2), 4 * C)
    scale = None
    if int8:
        absmax = x.float().abs().amax()
        scale = torch.clamp(absmax, min=1e-12) / 127.0
        stack = torch.clamp(torch.round(stack.float() / scale), -127, 127
                            ).to(torch.int8)
    return stack, (H, W, W + 2), scale


def _bilinear_sample_stacked(stack_info, py: torch.Tensor, px: torch.Tensor,
                             C: int, dtype: torch.dtype) -> torch.Tensor:
    """Bilinear sample from a ``_corner_stack``: one gather per tap."""
    stack, (H, W, Ws), scale = stack_info
    B = stack.shape[0]
    oh, ow = py.shape[-2:]
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    wy = (py - y0)[..., None]
    wx = (px - x0)[..., None]
    # Zero iff the 2x2 cell misses the image entirely; inside that range the
    # padded stack already returns zeros for corners off the image.
    box = (py > -1.0) & (py < H) & (px > -1.0) & (px < W)
    yc = (torch.clamp(y0, -1, H - 1) + 1).to(torch.int64)
    xc = (torch.clamp(x0, -1, W - 1) + 1).to(torch.int64)
    rows = stack.shape[1]
    idx = (yc * Ws + xc).reshape(B, oh * ow)
    idx = idx + torch.arange(B, device=idx.device)[:, None] * rows
    v4 = stack.reshape(B * rows, 4 * C).index_select(0, idx.reshape(-1))
    v4 = v4.reshape(B, oh, ow, 4, C)
    if scale is not None:  # int8 stack: dequantise after the gather
        v4 = v4.float() * scale
    w00 = (1 - wy) * (1 - wx)
    w01 = (1 - wy) * wx
    w10 = wy * (1 - wx)
    w11 = wy * wx
    out = (v4[..., 0, :] * w00 + v4[..., 1, :] * w01
           + v4[..., 2, :] * w10 + v4[..., 3, :] * w11)
    return (out * box[..., None].to(out.dtype)).to(dtype)


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  padding: int = 0, int8_gather: bool = False,
                  rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Modulated deformable conv, stride 1 / dilation 1 / one offset group.

    x:      (B, H, W, C), the whole input
    offset: (B, h, W, 2K) float32, interleaved (dy, dx) per tap
            k = ky * kw + kx (torchvision's channel order, channels last)
    mask:   (B, h, W, K) float32 modulation (through 2 * sigmoid already)
    w:      (Cout, C, kh, kw) OIHW
    bias:   (Cout,) or None, added last
    int8_gather: gather from an int8 corner stack (a bounded approximation,
            ``_corner_stack``, built from the whole input)
    rows:   (lo, hi), the output rows to compute (h = hi - lo; a canvas-row
            band's, parallel/spatial.py); default every row (h = H)
    Every tap's sample, modulation and product is float32; the result,
    (B, h, W, Cout), is cast to x's dtype.
    """
    B, H, W, C = x.shape
    cout, _, kh, kw = w.shape
    lo, hi = rows or (0, H)
    h = hi - lo
    stack_info = _corner_stack(x, int8=int8_gather)  # shared by every tap
    wmat = w.float().permute(2, 3, 1, 0)  # (kh, kw, C, Cout)
    ys = torch.arange(lo, hi, device=x.device, dtype=offset.dtype)[:, None]
    xs = torch.arange(W, device=x.device, dtype=offset.dtype)[None, :]
    acc = torch.zeros((B * h * W, cout), dtype=torch.float32, device=x.device)
    for ky in range(kh):
        for kx in range(kw):
            k = ky * kw + kx
            py = ys + (ky - padding) + offset[..., 2 * k]
            px = xs + (kx - padding) + offset[..., 2 * k + 1]
            val = _bilinear_sample_stacked(stack_info, py, px, C,
                                           torch.float32) * mask[..., k:k + 1]
            acc.addmm_(val.reshape(B * h * W, C), wmat[ky, kx])
    out = acc.reshape(B, h, W, cout)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)

