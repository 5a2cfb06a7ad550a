"""SAM ViT image encoders (ViT-B/L/H) in PyTorch.

Counterpart of dlimgedit_tpu/models/vit_sam.py: a plain ViT with MViTv2
decomposed relative-position attention, windowed (14 x 14) except at the
global blocks, and the 2-conv LayerNorm2d neck. NHWC throughout.

Kernel routing, as on the JAX package's accelerator path:
  * ``use_flash_attention`` sends the attention of every block through
    ``ops.flash_attention.flash_attention_relpos``: K5 for the windows
    (with the bottom-window pad-query skip), K4 for the global blocks;
  * ``fused_window_blocks`` (with ``use_rel_pos``) sends the windowed
    blocks, whatever ``use_flash_attention`` says, through
    ``ops.flash_attention.windowed_attention_fused`` (K6): the normed x is
    padded to a multiple of the window before the qkv linear and the
    kernel reads the windows in place from the three channel slices of
    its output, with no partition copy; the global blocks keep K4 (or the
    dense path);
  * ``use_flash_attention`` also routes the block LayerNorms: block 0's
    ``norm1`` through K1, every other block LayerNorm through K3 (the
    residual add fused in, in the residual-carry form of
    ``_vit_block_carry``). JAX's separate ``fused_layer_norm`` override (an
    A/B switch of its TPU ledger) is not carried over.
On CPU tensors the wrappers compute their plain versions. With both flags
off the encoder runs the dense path (``_decomposed_rel_pos_bias``), JAX's
CPU reference. The JAX patch embed's space-to-depth matmul is a TPU device;
the port runs the same function as a strided convolution.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.flash_attention import (
    cached_rel_pos_index,
    flash_attention_relpos,
    rel_pos_index,
    windowed_attention_fused,
)
from ..ops.fused_norm import fused_add_layer_norm, fused_layer_norm
from .common import (
    Conv,
    LayerNorm,
    Linear,
    _param,
    conv2d,
    gelu,
    layer_norm,
    linear,
    trunc_normal,
)
from .tinyvit import _window_partition, _window_unpartition


@dataclass(frozen=True)
class SamViTConfig:
    img_size: int = 1024
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    neck_dim: int = 256
    use_abs_pos: bool = True
    use_rel_pos: bool = True
    layer_norm_eps: float = 1e-6
    # K4 / K5 for the attention and K1 / K3 for the block LayerNorms (the
    # Environment turns it on for CUDA).
    use_flash_attention: bool = False
    # The windowed blocks through K6 (windowed_attention_fused), windows
    # read in place from the padded qkv output instead of partitioned; off
    # by default, as in JAX (set on a bundle's config to use it).
    fused_window_blocks: bool = False

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


VIT_PRESETS = {
    "vit_b": lambda img_size=1024: SamViTConfig(
        img_size=img_size, embed_dim=768, depth=12, num_heads=12,
        global_attn_indexes=(2, 5, 8, 11)),
    "vit_l": lambda img_size=1024: SamViTConfig(
        img_size=img_size, embed_dim=1024, depth=24, num_heads=16,
        global_attn_indexes=(5, 11, 17, 23)),
    "vit_h": lambda img_size=1024: SamViTConfig(
        img_size=img_size, embed_dim=1280, depth=32, num_heads=16,
        global_attn_indexes=(7, 15, 23, 31)),
}


# ---------------------------------------------------------------------------
# Modules (attribute names = JAX tree keys)
# ---------------------------------------------------------------------------

class PatchEmbed(nn.Module):
    """{"w": OIHW (C, 3, P, P), "b": (C,)}; JAX keeps w as HWIO."""

    def __init__(self, cfg: SamViTConfig, gen: torch.Generator):
        super().__init__()
        P = cfg.patch_size
        self.w = _param(trunc_normal(gen, (cfg.embed_dim, cfg.in_chans, P, P)))
        self.b = _param(torch.zeros(cfg.embed_dim))


class ViTMlp(nn.Module):
    def __init__(self, dim: int, hidden: int, gen: torch.Generator):
        super().__init__()
        self.lin1 = Linear(dim, hidden, gen)
        self.lin2 = Linear(hidden, dim, gen)


class Block(nn.Module):
    def __init__(self, cfg: SamViTConfig, window: int, gen: torch.Generator):
        super().__init__()
        d = cfg.embed_dim
        self.window = window
        self.norm1 = LayerNorm(d)
        self.qkv = Linear(d, 3 * d, gen, trunc_std=0.02)
        self.proj = Linear(d, d, gen)
        self.norm2 = LayerNorm(d)
        self.mlp = ViTMlp(d, int(d * cfg.mlp_ratio), gen)
        if cfg.use_rel_pos:
            size = cfg.grid if window == 0 else window
            hd = d // cfg.num_heads
            self.rel_pos_h = _param(torch.zeros(2 * size - 1, hd))
            self.rel_pos_w = _param(torch.zeros(2 * size - 1, hd))
            # The tables' gather index, made with the model and moved with
            # it (JAX makes it a constant of the jitted program): no host
            # copy per call. The tables are gathered per call, so that
            # weights written after the model is built count.
            self.register_buffer("rel_pos_idx", rel_pos_index(size),
                                 persistent=False)


class Neck(nn.Module):
    def __init__(self, cin: int, dim: int, gen: torch.Generator):
        super().__init__()
        self.conv1 = Conv(cin, dim, 1, gen)
        self.ln1 = LayerNorm(dim)
        self.conv2 = Conv(dim, dim, 3, gen)
        self.ln2 = LayerNorm(dim)


class SamViT(nn.Module):
    """The encoder; seeded init mirrors JAX ``init_sam_vit`` (zero rel-pos
    tables, zero ``pos_embed``, zero qkv bias). ``forward(x, cfg)`` takes
    the config whose flags route the kernels."""

    def __init__(self, cfg: SamViTConfig = SamViTConfig(),
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg, gen)
        self.blocks = nn.ModuleList(
            Block(cfg, 0 if i in cfg.global_attn_indexes else cfg.window_size,
                  gen)
            for i in range(cfg.depth))
        self.neck = Neck(cfg.embed_dim, cfg.neck_dim, gen)
        if cfg.use_abs_pos:
            self.pos_embed = _param(torch.zeros(1, cfg.grid, cfg.grid,
                                                cfg.embed_dim))

    def forward(self, x: torch.Tensor,
                cfg: Optional[SamViTConfig] = None) -> torch.Tensor:
        return sam_vit_apply(self, x, cfg or self.cfg)


# ---------------------------------------------------------------------------
# Functions
# ---------------------------------------------------------------------------

def gather_rel_pos(table: torch.Tensor, size: int,
                   idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(2*size-1, hd) raw table -> (size, size, hd) with
    g[i, j] = table[i - j + size - 1]. ``idx``: a block's ``rel_pos_idx``
    buffer; for another size (an input grid other than the configured one)
    the index made once per (size, device)."""
    if idx is None or idx.shape[0] != size:
        idx = cached_rel_pos_index(size, table.device)
    return table[idx]


def _decomposed_rel_pos_bias(q: torch.Tensor, bp: Block, h: int, w: int
                             ) -> torch.Tensor:
    """q: (B*, nh, h*w, hd) -> the float32 bias (B*, nh, h*w, h*w) (the
    dense path)."""
    rh = gather_rel_pos(bp.rel_pos_h, h, bp.rel_pos_idx).to(q.dtype).float()
    rw = gather_rel_pos(bp.rel_pos_w, w, bp.rel_pos_idx).to(q.dtype).float()
    Bn, nh, _, hd = q.shape
    qr = q.float().reshape(Bn, nh, h, w, hd)
    bias_h = torch.einsum("bnhwc,hkc->bnhwk", qr, rh)
    bias_w = torch.einsum("bnhwc,wkc->bnhwk", qr, rw)
    bias = bias_h[..., :, None] + bias_w[..., None, :]
    return bias.reshape(Bn, nh, h * w, h * w)


def _vit_attention(bp: Block, x: torch.Tensor, num_heads: int,
                   use_rel_pos: bool, use_flash: bool = False,
                   apply_proj: bool = True, n_w: Optional[int] = None,
                   valid_rows: Optional[int] = None) -> torch.Tensor:
    """x: (B*, h, w, C) -> (B*, h, w, C). apply_proj=False returns the
    attention output before ``proj`` (the windowed caller projects after
    the unpartition crop); n_w / valid_rows: the bottom-window pad-query
    skip of the kernel path."""
    Bn, h, w, C = x.shape
    hd = C // num_heads
    qkv = linear(bp.qkv, x.reshape(Bn, h * w, C))
    qkv = qkv.reshape(Bn, h * w, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (Bn, nh, hw, hd)
    if use_flash and use_rel_pos:
        rh = gather_rel_pos(bp.rel_pos_h, h, bp.rel_pos_idx).to(q.dtype)
        rw = gather_rel_pos(bp.rel_pos_w, w, bp.rel_pos_idx).to(q.dtype)
        out = flash_attention_relpos(
            q.reshape(Bn * num_heads, h * w, hd),
            k.reshape(Bn * num_heads, h * w, hd),
            v.reshape(Bn * num_heads, h * w, hd), rh, rw, grid_h=h, grid_w=w,
            heads=num_heads, n_w=n_w, valid_rows=valid_rows)
        out = out.reshape(Bn, num_heads, h * w, hd)
    else:
        attn = (q.float() @ k.float().transpose(-1, -2)) * (hd ** -0.5)
        if use_rel_pos:
            attn = attn + _decomposed_rel_pos_bias(q, bp, h, w)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = (attn.float() @ v.float()).to(v.dtype)
    out = out.permute(0, 2, 1, 3).reshape(Bn, h, w, C)
    if not apply_proj:
        return out
    return linear(bp.proj, out)


def _layer_norm(params: LayerNorm, x: torch.Tensor, cfg: SamViTConfig
                ) -> torch.Tensor:
    if cfg.use_flash_attention:
        return fused_layer_norm(x, params.scale, params.bias,
                                eps=cfg.layer_norm_eps)
    return layer_norm(params, x, eps=cfg.layer_norm_eps)


def _add_layer_norm(params: LayerNorm, x: torch.Tensor, delta: torch.Tensor,
                    cfg: SamViTConfig):
    """(x + delta, LN(x + delta)): K3 when fused, else the unfused chain."""
    if cfg.use_flash_attention:
        return fused_add_layer_norm(x, delta, params.scale, params.bias,
                                    eps=cfg.layer_norm_eps)
    s = x + delta
    return s, layer_norm(params, s, eps=cfg.layer_norm_eps)


def _vit_block_carry(bp: Block, base: torch.Tensor,
                     delta: Optional[torch.Tensor], cfg: SamViTConfig):
    """One block in residual-carry form: the stream is base + delta (delta
    None for block 0); returns (h, mlp_out) with the block output h +
    mlp_out, so that both residual adds fuse into the next LayerNorm."""
    if delta is None:
        x = base
        y1 = _layer_norm(bp.norm1, x, cfg)
    else:
        x, y1 = _add_layer_norm(bp.norm1, base, delta, cfg)
    a = _vit_attn_branch(bp, y1, cfg)
    h, y2 = _add_layer_norm(bp.norm2, x, a, cfg)
    m = linear(bp.mlp.lin2, gelu(linear(bp.mlp.lin1, y2)))
    return h, m


def _vit_attn_branch(bp: Block, x: torch.Tensor, cfg: SamViTConfig
                     ) -> torch.Tensor:
    """The attention half-block on the already-normed x."""
    B, H, W, C = x.shape
    window = bp.window
    if window == 0:
        return _vit_attention(bp, x, cfg.num_heads, cfg.use_rel_pos,
                              use_flash=cfg.use_flash_attention)
    if cfg.fused_window_blocks and cfg.use_rel_pos:
        # Pad the normed x BEFORE the qkv linear: pad tokens get k = v = the
        # qkv bias, as in the partitioned path.
        pad_b, pad_r = (-H) % window, (-W) % window
        if pad_b or pad_r:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        qkv = linear(bp.qkv, x)  # (B, Hp, Wp, 3C)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        att = windowed_attention_fused(
            q, k, v,
            gather_rel_pos(bp.rel_pos_h, window, bp.rel_pos_idx).to(q.dtype),
            gather_rel_pos(bp.rel_pos_w, window, bp.rel_pos_idx).to(q.dtype),
            ws=window,
            num_heads=cfg.num_heads)
        return linear(bp.proj, att[:, :H, :W, :])
    # Partition AFTER the LayerNorm: zero pad tokens give k = v = the qkv
    # bias and take part as keys, as in JAX.
    wx, meta = _window_partition(x, window)
    nW, pad_b = meta[4], meta[5]
    # Pad-query skip (batch 1 only: the bottom windows must be the tail of
    # the window axis) and proj after the unpartition crop; both exact.
    skip_ok = B == 1 and pad_b > 0
    wx = _vit_attention(bp, wx.reshape(-1, window, window, C), cfg.num_heads,
                        cfg.use_rel_pos, use_flash=cfg.use_flash_attention,
                        apply_proj=False, n_w=nW if skip_ok else None,
                        valid_rows=window - pad_b if skip_ok else None)
    x = _window_unpartition(wx.reshape(-1, window * window, C), window, meta,
                            H, W, C)
    return linear(bp.proj, x)


def _patch_embed(pe: PatchEmbed, x: torch.Tensor, P: int) -> torch.Tensor:
    """Non-overlapping P x P patch embed, stride P."""
    return conv2d(x, pe.w, stride=P) + pe.b.to(x.dtype)


def sam_vit_apply(model: SamViT, x: torch.Tensor, cfg: SamViTConfig
                  ) -> torch.Tensor:
    """x: (B, S, S, 3) normalised pixels -> (B, S/16, S/16, neck_dim)."""
    x = _patch_embed(model.patch_embed, x, cfg.patch_size)
    if cfg.use_abs_pos and hasattr(model, "pos_embed"):
        x = x + model.pos_embed.to(x.dtype)
    delta = None
    for bp in model.blocks:
        x, delta = _vit_block_carry(bp, x, delta, cfg)
    if delta is not None:
        x = x + delta
    neck = model.neck
    x = conv2d(x, neck.conv1.w)
    x = layer_norm(neck.ln1, x, eps=1e-6)
    x = conv2d(x, neck.conv2.w, padding=1)
    return layer_norm(neck.ln2, x, eps=1e-6)
