"""Swin Transformer v1 backbone, NHWC (counterpart of
dlimgedit_tpu/models/swin.py): BiRefNet's backbone family, swin_v1_tiny
for BiRefNet_lite. Patch embed (4 x 4 conv), stages of window attention
and shifted window attention blocks with relative-position bias tables,
linear patch merging between stages; returns the 4-stage feature pyramid,
each stage's output layer-normed.

The relative-position index and the shift masks are made on the device,
once per (window, padded size, device) (``_rel_pos_index``,
``_shift_attn_mask``): a forward copies nothing from the host. LayerNorm
and attention are plain PyTorch, as in the JAX package (no Pallas kernel
there).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn

from .common import (
    LayerNorm,
    Linear,
    _param,
    conv2d,
    gelu,
    layer_norm,
    linear,
    trunc_normal,
)


@dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-5

    def stage_dim(self, i: int) -> int:
        return self.embed_dim * (2 ** i)


SWIN_PRESETS = {
    "swin_v1_tiny": SwinConfig(),
    "swin_v1_small": SwinConfig(depths=(2, 2, 18, 2)),
    "swin_v1_base": SwinConfig(embed_dim=128, depths=(2, 2, 18, 2),
                               num_heads=(4, 8, 16, 32)),
    "swin_v1_large": SwinConfig(embed_dim=192, depths=(2, 2, 18, 2),
                                num_heads=(6, 12, 24, 48)),
}


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def _rel_pos_index(window: int, device: torch.device) -> torch.Tensor:
    """The Swin relative-position index (w^2, w^2) into the ((2w-1)^2,)
    bias table, int64 on `device`, made there once: by a graphed
    executable's eager warm-up, never inside its capture."""
    t = torch.arange(window * window, device=device)
    y, x = t // window, t % window
    dy = y[:, None] - y[None, :] + (window - 1)
    dx = x[:, None] - x[None, :] + (window - 1)
    return dy * (2 * window - 1) + dx


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def _shift_attn_mask(pH: int, pW: int, window: int, shift: int,
                     device: torch.device) -> torch.Tensor:
    """The additive region mask (0 / -100) of shifted-window attention over
    the padded (pH, pW) grid, (num_windows, w^2, w^2) float32 on `device`,
    made there once. A row's region is 0 above pH - window, 1 above
    pH - shift, else 2 (likewise columns); cells of different regions
    may not attend to each other."""
    def regions(n):
        i = torch.arange(n, device=device)
        return (i >= n - window).long() + (i >= n - shift).long()

    img = regions(pH)[:, None] * 3 + regions(pW)[None, :]
    nH, nW = pH // window, pW // window
    wins = img.reshape(nH, window, nW, window).permute(0, 2, 1, 3)
    wins = wins.reshape(nH * nW, window * window)
    diff = wins[:, :, None] != wins[:, None, :]
    return torch.where(diff, -100.0, 0.0).to(torch.float32)


class _Weight(nn.Module):
    """{"w": (in, out)}: a linear map with no bias."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w = _param(w)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, gen: torch.Generator):
        super().__init__()
        self.lin1 = Linear(dim, hidden, gen)
        self.lin2 = Linear(hidden, dim, gen)


class SwinBlock(nn.Module):
    """{"norm1", "qkv", "proj", "rel_bias", "norm2", "mlp"}."""

    def __init__(self, dim: int, num_heads: int, window: int,
                 mlp_ratio: float, gen: torch.Generator):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.qkv = Linear(dim, 3 * dim, gen, trunc_std=0.02)
        self.proj = Linear(dim, dim, gen)
        self.rel_bias = _param(trunc_normal(gen, ((2 * window - 1) ** 2,
                                                  num_heads)))
        self.norm2 = LayerNorm(dim)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), gen)


class _PatchMerge(nn.Module):
    def __init__(self, dim: int, gen: torch.Generator):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = _Weight(trunc_normal(gen, (4 * dim, 2 * dim)))


class _Stage(nn.Module):
    def __init__(self, cfg: SwinConfig, i: int, gen: torch.Generator):
        super().__init__()
        dim = cfg.stage_dim(i)
        self.blocks = nn.ModuleList(
            SwinBlock(dim, cfg.num_heads[i], cfg.window, cfg.mlp_ratio, gen)
            for _ in range(cfg.depths[i]))
        self.out_norm = LayerNorm(dim)
        if i < 3:
            self.downsample = _PatchMerge(dim, gen)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: SwinConfig, gen: torch.Generator):
        super().__init__()
        self.w = _param(trunc_normal(gen, (cfg.embed_dim, cfg.in_chans,
                                           cfg.patch_size, cfg.patch_size)))
        self.b = _param(torch.zeros(cfg.embed_dim))
        self.norm = LayerNorm(cfg.embed_dim)


class Swin(nn.Module):
    """{"patch_embed", "stages"}, as the JAX tree; seeded init mirrors JAX
    ``init_swin`` (truncated normal qkv, reduction and rel-pos tables,
    zero qkv and patch-embed biases) with torch's random numbers."""

    def __init__(self, cfg: SwinConfig = SwinConfig(),
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.patch_embed = _PatchEmbed(cfg, gen)
        self.stages = nn.ModuleList(_Stage(cfg, i, gen) for i in range(4))


def init_swin(gen: torch.Generator, cfg: SwinConfig = SwinConfig()) -> Swin:
    return Swin(cfg, gen)


def _window_attention(p: SwinBlock, x: torch.Tensor, num_heads: int,
                      window: int, mask: Optional[torch.Tensor]
                      ) -> torch.Tensor:
    """x: (B, nW, w^2, C); mask: (nW, w^2, w^2) additive or None. Scores
    and softmax in float32, probabilities rounded to x's dtype before the
    float32 product with v, as in JAX."""
    B, nW, N, C = x.shape
    hd = C // num_heads
    qkv = linear(p.qkv, x).reshape(B, nW, N, 3, num_heads, hd)
    q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
    attn = torch.einsum("bwnhd,bwmhd->bwhnm", q.float(), k.float()) * (hd ** -0.5)
    idx = _rel_pos_index(window, x.device)
    bias = p.rel_bias[idx.reshape(-1)].reshape(N, N, num_heads).permute(2, 0, 1)
    attn = attn + bias.float()[None, None]
    if mask is not None:
        attn = attn + mask[None, :, None, :, :]
    attn = torch.softmax(attn, dim=-1).to(v.dtype)
    out = torch.einsum("bwhnm,bwmhd->bwnhd", attn.float(), v.float()).to(v.dtype)
    return linear(p.proj, out.reshape(B, nW, N, C))


def _swin_block(p: SwinBlock, x: torch.Tensor, num_heads: int, window: int,
                shift: int, eps: float) -> torch.Tensor:
    H = x.shape[1]
    y = layer_norm(p.norm1, x, eps=eps)
    pad_b = (window - H % window) % window
    if pad_b:
        y = torch.nn.functional.pad(y, (0, 0, 0, 0, 0, pad_b))
    mask = None
    if shift > 0:
        y = torch.roll(y, -shift, dims=1)
        mask = _shift_attn_mask(H + pad_b, _padded(y.shape[2], window),
                                window, shift, y.device)
    y = _attend_rows(p, y, num_heads, window, shift, mask)
    if shift > 0:
        y = torch.roll(y, shift, dims=1)
    return _swin_tail(p, x, y[:, :H], eps)


def _padded(n: int, window: int) -> int:
    return n + (window - n % window) % window


def _attend_rows(p: SwinBlock, x: torch.Tensor, num_heads: int, window: int,
                 shift: int, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Window attention over whole rows of windows: x (B, h, W, C), the
    normed (and zero-padded) rows, h a multiple of the window, already
    rolled up by `shift` rows; the columns are padded and rolled here.
    mask: the shift mask of these windows, (h / w * pW / w, w^2, w^2), or
    None. -> (B, h, W, C) in the same (rolled) rows. The dense block runs
    it on the whole padded grid, a canvas-row band on the windows that
    meet its rows (parallel/spatial.py)."""
    B, h, W, C = x.shape
    pad_r = (window - W % window) % window
    if pad_r:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad_r))
    pW = W + pad_r
    if shift > 0:
        x = torch.roll(x, -shift, dims=2)
    nH, nW = h // window, pW // window
    x = x.reshape(B, nH, window, nW, window, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, nH * nW, window * window, C)
    x = _window_attention(p, x, num_heads, window, mask)
    x = x.reshape(B, nH, nW, window, window, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, h, pW, C)
    if shift > 0:
        x = torch.roll(x, shift, dims=2)
    return x[:, :, :W]


def _swin_tail(p: SwinBlock, shortcut: torch.Tensor, attn: torch.Tensor,
               eps: float) -> torch.Tensor:
    """The block after its attention: residual, norm2, MLP, residual."""
    x = shortcut + attn
    y = layer_norm(p.norm2, x, eps=eps)
    y = linear(p.mlp.lin2, gelu(linear(p.mlp.lin1, y)))
    return x + y


def _patch_merge(p: _PatchMerge, x: torch.Tensor, eps: float) -> torch.Tensor:
    B, H, W, C = x.shape
    pad_b, pad_r = H % 2, W % 2
    if pad_b or pad_r:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        H, W = H + pad_b, W + pad_r
    # The 4C block order of torch Swin-v1 PatchMerging's cat([x0, x1, x2,
    # x3]) = (h0w0, h1w0, h0w1, h1w1): w-parity is the outer 2C split,
    # h-parity the inner (converted checkpoints depend on it).
    x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
    x = x.reshape(B, H // 2, W // 2, 4 * C)
    x = layer_norm(p.norm, x, eps=eps)
    return linear(p.reduction, x)


def _patch_embed(pe: _PatchEmbed, x: torch.Tensor, cfg: SwinConfig,
                 padding=0) -> torch.Tensor:
    """The patch embed (a patch-strided conv, its bias, LayerNorm); a
    canvas-row band passes padding (0, 0) with its rows fetched."""
    x = conv2d(x, pe.w, stride=cfg.patch_size, padding=padding)
    x = x + pe.b.to(x.dtype)
    return layer_norm(pe.norm, x, eps=cfg.layer_norm_eps)


def swin_apply(model: Swin, x: torch.Tensor, cfg: SwinConfig = SwinConfig()
               ) -> List[torch.Tensor]:
    """x: (B, S, S, 3) -> 4 feature maps at strides 4/8/16/32, each
    layer-normed (the dense-prediction pyramid)."""
    x = _patch_embed(model.patch_embed, x, cfg)
    feats = []
    for i, stage in enumerate(model.stages):
        for j, bp in enumerate(stage.blocks):
            shift = 0 if j % 2 == 0 else cfg.window // 2
            x = _swin_block(bp, x, cfg.num_heads[i], cfg.window, shift,
                            cfg.layer_norm_eps)
        feats.append(layer_norm(stage.out_norm, x, eps=cfg.layer_norm_eps))
        if hasattr(stage, "downsample"):
            x = _patch_merge(stage.downsample, x, cfg.layer_norm_eps)
    return feats
