"""TinyViT-5M image encoder (the MobileSAM `vit_t` encoder) in PyTorch.

Counterpart of dlimgedit_tpu/models/tinyvit.py, NHWC throughout:

  patch_embed (2x conv stride-2, 1024->256)
  stage0: ConvLayer of MBConv blocks @256, merge -> 128
  stage1: window-attention blocks (ws=7)  @128, merge -> 64
  stage2: window-attention blocks (ws=14) @64,  merge -> 64 (stride-1 merge)
  stage3: window-attention blocks (ws=7)  @64
  neck:   1x1 conv -> LN2d -> 3x3 conv -> LN2d, 320 -> 256 channels

Output: (B, 64, 64, 256) image embedding, NHWC.

Two config flags route to the port's CUDA kernels: ``use_fused_norm`` sends
every LayerNorm of the encoder through K1 (ops/fused_norm.py) and
``use_flash_attention`` the window attention through K2
(ops/flash_attention.py). On CPU tensors both wrappers compute their plain
versions, which are exactly what the encoder runs with the flags off.
The JAX stem's space-to-depth rewrite is a TPU device; the port runs the
plain stride-2 convs (the JAX fallback at tinyvit.py:321-323).
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import (
    levit_window_attention,
    levit_window_attention_plain,
)
from ..ops.fused_norm import fused_layer_norm
from .common import (
    Conv,
    ConvBN,
    LayerNorm,
    Linear,
    Mlp,
    _param,
    conv2d,
    conv_bn,
    gelu,
    layer_norm,
    linear,
)


@dataclass(frozen=True)
class TinyViTConfig:
    img_size: int = 1024
    in_chans: int = 3
    embed_dims: Tuple[int, ...] = (64, 128, 160, 320)
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (2, 4, 5, 10)
    window_sizes: Tuple[int, ...] = (7, 7, 14, 7)
    mlp_ratio: float = 4.0
    mbconv_expand_ratio: float = 4.0
    local_conv_size: int = 3
    neck_dim: int = 256
    # Kernel K1 for every encoder LayerNorm (the Environment turns it on
    # for CUDA devices).
    use_fused_norm: bool = False
    # Kernel K2 for the window attention (likewise on for CUDA devices).
    use_flash_attention: bool = False

    @property
    def patch_resolution(self) -> int:
        return self.img_size // 4

    def stage_resolution(self, i: int) -> int:
        # Stage 3 runs at stage 2's resolution (stride-1 merge).
        return self.patch_resolution // (2 ** (i if i < 3 else 2))

    @property
    def embedding_resolution(self) -> int:
        return self.stage_resolution(3)


@functools.lru_cache(maxsize=None)
def attention_bias_idxs(window: int) -> Tuple[np.ndarray, int]:
    """Static relative-offset index table for a `window x window` grid.

    Returns (idxs [N, N] int32, num_offsets), offsets enumerated in the
    LeViT/TinyViT order so converted checkpoints line up."""
    points = list(itertools.product(range(window), range(window)))
    offsets: Dict[Tuple[int, int], int] = {}
    idxs = []
    for p1 in points:
        for p2 in points:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    n = len(points)
    return np.array(idxs, dtype=np.int32).reshape(n, n), len(offsets)


# ---------------------------------------------------------------------------
# Modules (attribute names = JAX tree keys)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int,
                 gen: torch.Generator):
        super().__init__()
        key_dim = dim // num_heads
        h = 3 * key_dim * num_heads  # attn_ratio = 1
        idxs, n_off = attention_bias_idxs(window)
        self.num_heads = num_heads
        self.norm = LayerNorm(dim)
        self.qkv = Linear(dim, h, gen, trunc_std=0.02)
        self.proj = Linear(key_dim * num_heads, dim, gen, trunc_std=0.02)
        self.attention_biases = _param(torch.zeros(num_heads, n_off))
        self.register_buffer("bias_idxs", torch.from_numpy(idxs).long(),
                             persistent=False)

    def forward(self, x: torch.Tensor, cfg: TinyViTConfig) -> torch.Tensor:
        """LeViT-style biased attention over (B, N, C) tokens."""
        x = _ln(self.norm, x, cfg)
        qkv = linear(self.qkv, x)
        bias = self.attention_biases[:, self.bias_idxs]  # (nh, N, N)
        if cfg.use_flash_attention:
            out = levit_window_attention(qkv, bias, self.num_heads)
        else:
            out = levit_window_attention_plain(qkv, bias, self.num_heads)
        return linear(self.proj, out)


class MBConv(nn.Module):
    def __init__(self, dim: int, expand: float, gen: torch.Generator):
        super().__init__()
        hidden = int(dim * expand)
        self.conv1 = ConvBN(dim, hidden, 1, gen)
        self.conv2 = ConvBN(hidden, hidden, 3, gen, groups=hidden)
        self.conv3 = ConvBN(hidden, dim, 1, gen, bn_weight_init=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = gelu(self.conv1(x))
        x = gelu(self.conv2(x, padding=1))
        x = self.conv3(x)
        return gelu(x + shortcut)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, out_dim: int, gen: torch.Generator):
        super().__init__()
        self.conv1 = ConvBN(dim, out_dim, 1, gen)
        self.conv2 = ConvBN(out_dim, out_dim, 3, gen, groups=out_dim)
        self.conv3 = ConvBN(out_dim, out_dim, 1, gen)

    def forward(self, x: torch.Tensor, stride: int) -> torch.Tensor:
        x = gelu(self.conv1(x))
        x = gelu(self.conv2(x, stride=stride, padding=1))
        return self.conv3(x)


class Block(nn.Module):
    def __init__(self, cfg: TinyViTConfig, dim: int, num_heads: int,
                 window: int, gen: torch.Generator):
        super().__init__()
        self.window = window
        self.attn = Attention(dim, num_heads, window, gen)
        self.local_conv = ConvBN(dim, dim, cfg.local_conv_size, gen, groups=dim)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio), gen)

    def forward(self, x: torch.Tensor, cfg: TinyViTConfig) -> torch.Tensor:
        B, H, W, C = x.shape
        ws = self.window
        shortcut = x
        if H == ws and W == ws:
            att = self.attn(x.reshape(B, H * W, C), cfg).reshape(B, H, W, C)
        else:
            att = self.attend(x, cfg)
        x = shortcut + att
        x = self.local_conv(x, padding=cfg.local_conv_size // 2)
        return x + _mlp_ln(self.mlp, x, cfg)

    def attend(self, x: torch.Tensor, cfg: TinyViTConfig) -> torch.Tensor:
        """The window attention of x (B, H, W, C) over a window grid from
        its first row and column. The partition comes BEFORE the
        attention's LayerNorm: zero pad tokens become LN(0) = bias and take
        part as keys, as in JAX. A canvas-row band (parallel/spatial.py)
        passes whole rows of windows, the zero rows below the image
        already fetched."""
        B, H, W, C = x.shape
        wx, meta = _window_partition(x, self.window)
        return _window_unpartition(self.attn(wx, cfg), self.window, meta,
                                   H, W, C)


class Stage(nn.Module):
    def __init__(self, blocks, downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        if downsample is not None:
            self.downsample = downsample


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, gen: torch.Generator):
        super().__init__()
        self.conv1 = ConvBN(cin, dim // 2, 3, gen)
        self.conv2 = ConvBN(dim // 2, dim, 3, gen)


class Neck(nn.Module):
    def __init__(self, cin: int, dim: int, gen: torch.Generator):
        super().__init__()
        self.conv1 = Conv(cin, dim, 1, gen)
        self.ln1 = LayerNorm(dim)
        self.conv2 = Conv(dim, dim, 3, gen)
        self.ln2 = LayerNorm(dim)


class TinyViT(nn.Module):
    """The encoder. ``forward(x, cfg)`` takes the config whose flags route
    the kernels; it defaults to the construction config."""

    def __init__(self, cfg: TinyViTConfig = TinyViTConfig(),
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        ed = cfg.embed_dims
        self.patch_embed = PatchEmbed(cfg.in_chans, ed[0], gen)
        stages = []
        for i in range(4):
            if i == 0:
                blocks = [MBConv(ed[0], cfg.mbconv_expand_ratio, gen)
                          for _ in range(cfg.depths[0])]
            else:
                blocks = [Block(cfg, ed[i], cfg.num_heads[i],
                                cfg.window_sizes[i], gen)
                          for _ in range(cfg.depths[i])]
            down = PatchMerging(ed[i], ed[i + 1], gen) if i < 3 else None
            stages.append(Stage(blocks, down))
        self.stages = nn.ModuleList(stages)
        self.neck = Neck(ed[3], cfg.neck_dim, gen)

    def forward(self, x: torch.Tensor,
                cfg: Optional[TinyViTConfig] = None) -> torch.Tensor:
        """x: (B, img_size, img_size, 3) normalised pixels -> (B, 64, 64,
        neck_dim) NHWC embedding."""
        cfg = cfg or self.cfg
        pe = self.patch_embed
        x = gelu(pe.conv1(x, stride=2, padding=1))
        x = pe.conv2(x, stride=2, padding=1)
        for i, stage in enumerate(self.stages):
            for blk in stage.blocks:
                x = blk(x) if i == 0 else blk(x, cfg)
            if hasattr(stage, "downsample"):
                x = stage.downsample(x, merge_stride(cfg, i))
        neck = self.neck
        x = conv2d(x, neck.conv1.w)
        x = _ln(neck.ln1, x, cfg, eps=1e-6)
        x = conv2d(x, neck.conv2.w, padding=1)
        return _ln(neck.ln2, x, cfg, eps=1e-6)


# ---------------------------------------------------------------------------
# Functions
# ---------------------------------------------------------------------------

def merge_stride(cfg: TinyViTConfig, i: int) -> int:
    """The stride of stage i's PatchMerging: the merge into the last stage
    keeps 64x64 (MobileSAM)."""
    return 1 if cfg.embed_dims[i + 1] in (320, 448, 576) else 2


def _ln(params: LayerNorm, x: torch.Tensor, cfg: TinyViTConfig,
        eps: float = 1e-5) -> torch.Tensor:
    if cfg.use_fused_norm:
        return fused_layer_norm(x, params.scale, params.bias, eps=eps)
    return layer_norm(params, x, eps=eps)


def _mlp_ln(params: Mlp, x: torch.Tensor, cfg: TinyViTConfig) -> torch.Tensor:
    y = _ln(params.norm, x, cfg)
    y = gelu(linear(params.fc1, y))
    return linear(params.fc2, y)


def _window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> (B*nH*nW, ws*ws, C) with bottom/right zero padding."""
    B, H, W, C = x.shape
    pad_b = (ws - H % ws) % ws
    pad_r = (ws - W % ws) % ws
    if pad_b or pad_r:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    pH, pW = H + pad_b, W + pad_r
    nH, nW = pH // ws, pW // ws
    x = x.reshape(B, nH, ws, nW, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * nH * nW, ws * ws, C), (B, pH, pW, nH, nW, pad_b, pad_r)


def _window_unpartition(x: torch.Tensor, ws: int, meta, H: int, W: int, C: int):
    B, pH, pW, nH, nW, pad_b, pad_r = meta
    x = x.reshape(B, nH, nW, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, pH, pW, C)
    if pad_b or pad_r:
        x = x[:, :H, :W, :]
    return x.contiguous()
