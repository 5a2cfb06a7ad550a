"""BiRefNet (lite): dichotomous foreground segmentation, NHWC (counterpart
of dlimgedit_tpu/models/birefnet.py; upstream ZhengPeng7/BiRefNet's
configuration for the released BiRefNet_lite checkpoint):

  backbone        swin_v1_tiny, pyramid [96, 192, 384, 768]
  mul_scl_ipt     'cat': the backbone also runs on the half-resolution
                  image, its features resized (bilinear, align_corners)
                  and concatenated: laterals [192, 384, 768, 1536]
  cxt_num         3: x1 / x2 / x3 resized onto x4 and concatenated
  squeeze / dec   BasicDecBlk: conv3x3 + ReLU -> ASPPDeformable -> conv3x3
  ASPPDeformable  1x1 + {1, 3, 7} modulated deformable branches + a global
                  average branch, projected by a 1x1 conv + ReLU
  dec_ipt         the input image tiled into channels at each decoder
                  scale, through SimpleConvs
  out_ref         gdt gates: p * sigmoid(1x1(relu(conv3x3(p))))

BatchNorms are folded into the convs at conversion, so every conv is w
(+ b). Conv kernels are OIHW (the JAX tree's HWIO, transposed by
``convert.from_numpy``). The output is logits; the runtime takes
floor(sigmoid * 255).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.deform import deform_conv2d
from .common import _param, conv2d, kaiming_uniform_conv, relu
from .swin import SWIN_PRESETS, Swin, SwinConfig, swin_apply


@dataclass(frozen=True)
class BiRefNetConfig:
    img_size: int = 1024
    backbone: str = "swin_v1_tiny"
    mul_scl_ipt: str = "cat"          # '' disables the half-res branch
    cxt_num: int = 3
    dec_inter_channels: int = 64
    aspp_channelster: int = 256       # ASPPDeformable branch width
    aspp_kernel_sizes: Tuple[int, ...] = (1, 3, 7)
    gdt_channels: int = 16
    # The int8 corner stack for the deformable gathers (a bounded
    # approximation, ops/deform._corner_stack); Options.birefnet_int8_deform.
    deform_int8_gather: bool = False
    # Tests may substitute a narrow Swin; None -> SWIN_PRESETS[backbone].
    swin_cfg: Optional[SwinConfig] = None

    @property
    def swin(self) -> SwinConfig:
        return self.swin_cfg or SWIN_PRESETS[self.backbone]

    @property
    def channels(self) -> Tuple[int, ...]:
        """Deepest-first lateral channels (doubled under mul_scl_ipt='cat')."""
        d = self.swin.embed_dim
        ch = (8 * d, 4 * d, 2 * d, d)
        if self.mul_scl_ipt == "cat":
            ch = tuple(2 * c for c in ch)
        return ch

    @property
    def cxt(self) -> Tuple[int, ...]:
        """Context channels appended to x4: laterals[1:] reversed, the last
        cxt_num."""
        if not self.cxt_num:
            return ()
        return tuple(self.channels[1:][::-1][-self.cxt_num:])


# ---------------------------------------------------------------------------
# align_corners=True bilinear resize, as two matrix products
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def _ac_matrix(n_out: int, n_in: int, device: torch.device) -> torch.Tensor:
    """(n_out, n_in) float32 bilinear matrix with torch's align_corners=True
    mapping, src = i * (n_in - 1) / (n_out - 1), made on `device` once (by
    a graphed executable's warm-up). The position in float64, as JAX's
    numpy builds it."""
    pos = torch.arange(n_out, dtype=torch.float64, device=device)
    if n_in == 1 or n_out == 1:
        pos = pos * 0  # every row reads column 0
    else:
        pos = pos * (n_in - 1) / (n_out - 1)
    i0 = torch.clamp(torch.floor(pos).long(), max=n_in - 1)
    f = pos - i0
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    cols = torch.arange(n_in, device=device)[None, :]
    lo = (1.0 - f).to(torch.float32)[:, None]
    hi = f.to(torch.float32)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return (torch.where(cols == i0[:, None], lo, zero)
            + torch.where(cols == i1[:, None], hi, zero))


def resize_align_corners(x: torch.Tensor, size_hw: Tuple[int, int]
                         ) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C), bilinear, align_corners=True (the mode
    used throughout upstream BiRefNet), in float32, cast back to x's
    dtype."""
    B, H, W, C = x.shape
    h, w = size_hw
    if (H, W) == (h, w):
        return x
    return _apply_ac(_ac_matrix(h, H, x.device), _ac_matrix(w, W, x.device),
                     x)


def _apply_ac(R: torch.Tensor, Cm: torch.Tensor, x: torch.Tensor
              ) -> torch.Tensor:
    """R @ x @ Cm^T over the rows and columns of x (B, H, W, C), in
    float32, cast back: the resize, or a canvas-row band of it (the rows
    of R it keeps and the columns they read)."""
    y = torch.einsum("ih,bhwc->biwc", R, x.float())
    y = torch.einsum("biwc,jw->bijc", y, Cm)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Parameter containers (attribute names = JAX tree keys)
# ---------------------------------------------------------------------------

class ConvB(nn.Module):
    """{"w": OIHW, "b"}: Kaiming-uniform w and a zero b, or both zero. The
    JAX package adds "b" only where the tree holds it (``_conv``, the
    deform conv, the head fold), so a tree without it loads
    (``convert.from_numpy.load_into`` drops the leaf); the ASPP projection
    reads its bias unconditionally there, and here
    (``bias_optional=False``)."""

    def __init__(self, cin: int, cout: int, ks: int, gen: torch.Generator,
                 zero: bool = False, bias_optional: bool = True):
        super().__init__()
        self.bias_optional = bias_optional
        shape = (cout, cin, ks, ks)
        self.w = _param(torch.zeros(shape) if zero
                        else kaiming_uniform_conv(gen, shape))
        self.b = _param(torch.zeros(cout))


class Deform(nn.Module):
    """_ASPPModuleDeformable: zero-initialised offset and modulator convs
    (as upstream) and the regular conv (BN folded)."""

    def __init__(self, cin: int, cout: int, ks: int, gen: torch.Generator):
        super().__init__()
        self.offset = ConvB(cin, 2 * ks * ks, ks, gen, zero=True)
        self.modulator = ConvB(cin, ks * ks, ks, gen, zero=True)
        self.conv = ConvB(cin, cout, ks, gen)


class Aspp(nn.Module):
    def __init__(self, cin: int, cfg: BiRefNetConfig, gen: torch.Generator):
        super().__init__()
        cs = cfg.aspp_channelster
        self.aspp1 = Deform(cin, cs, 1, gen)
        self.deforms = nn.ModuleList(Deform(cin, cs, s, gen)
                                     for s in cfg.aspp_kernel_sizes)
        self.gap = ConvB(cin, cs, 1, gen)
        self.proj = ConvB((2 + len(cfg.aspp_kernel_sizes)) * cs, cin, 1, gen,
                          bias_optional=False)


class DecBlk(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: BiRefNetConfig,
                 gen: torch.Generator):
        super().__init__()
        ci = cfg.dec_inter_channels
        self.conv_in = ConvB(cin, ci, 3, gen)
        self.aspp = Aspp(ci, cfg, gen)
        self.conv_out = ConvB(ci, cout, 3, gen)


class SimpleConvs(nn.Module):
    def __init__(self, cin: int, cout: int, gen: torch.Generator,
                 inter: int = 64):
        super().__init__()
        self.conv1 = ConvB(cin, inter, 3, gen)
        self.conv_out = ConvB(inter, cout, 3, gen)


class Decoder(nn.Module):
    def __init__(self, cfg: BiRefNetConfig, gen: torch.Generator):
        super().__init__()
        ch, gc = cfg.channels, cfg.gdt_channels
        self.ipt_blk5 = SimpleConvs(2 ** 10 * 3, ch[0] // 8, gen)
        self.ipt_blk4 = SimpleConvs(2 ** 8 * 3, ch[0] // 8, gen)
        self.ipt_blk3 = SimpleConvs(2 ** 6 * 3, ch[1] // 8, gen)
        self.ipt_blk2 = SimpleConvs(2 ** 4 * 3, ch[2] // 8, gen)
        self.ipt_blk1 = SimpleConvs(3, ch[3] // 8, gen)
        self.dec4 = DecBlk(ch[0] + ch[0] // 8, ch[1], cfg, gen)
        self.dec3 = DecBlk(ch[1] + ch[0] // 8, ch[2], cfg, gen)
        self.dec2 = DecBlk(ch[2] + ch[1] // 8, ch[3], cfg, gen)
        self.dec1 = DecBlk(ch[3] + ch[2] // 8, ch[3] // 2, cfg, gen)
        self.lat4 = ConvB(ch[1], ch[1], 1, gen)
        self.lat3 = ConvB(ch[2], ch[2], 1, gen)
        self.lat2 = ConvB(ch[3], ch[3], 1, gen)
        for i, c in ((4, ch[1]), (3, ch[2]), (2, ch[3])):
            setattr(self, f"gdt{i}", ConvB(c, gc, 3, gen))
        for i in (4, 3, 2):
            setattr(self, f"gdt_attn{i}", ConvB(gc, 1, 1, gen))
        self.head = ConvB(ch[3] // 2 + ch[3] // 8, 1, 1, gen)


class BiRefNet(nn.Module):
    """{"backbone", "squeeze", "decoder"}, as the JAX tree; seeded init
    mirrors JAX ``init_birefnet`` (zero offset and modulator convs, zero
    conv biases) with torch's random numbers."""

    def __init__(self, cfg: BiRefNetConfig = BiRefNetConfig(),
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        ch = cfg.channels
        self.backbone = Swin(cfg.swin, gen)
        self.squeeze = DecBlk(ch[0] + sum(cfg.cxt), ch[0], cfg, gen)
        self.decoder = Decoder(cfg, gen)


def init_birefnet(gen: torch.Generator,
                  cfg: BiRefNetConfig = BiRefNetConfig()) -> BiRefNet:
    return BiRefNet(cfg, gen)


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _conv(p: ConvB, x: torch.Tensor, padding: int = 0) -> torch.Tensor:
    y = conv2d(x, p.w, padding=padding)
    if hasattr(p, "b"):
        y = y + p.b.to(y.dtype)
    return y


def _deform_offsets(p: Deform, x: torch.Tensor, padding
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The offsets and the modulator (2 sigmoid) of a deform conv, float32."""
    offset = _conv(p.offset, x, padding=padding).float()
    modulator = 2.0 * torch.sigmoid(_conv(p.modulator, x,
                                          padding=padding).float())
    return offset, modulator


def _apply_deform(p: Deform, x: torch.Tensor, ks: int,
                  int8_gather: bool = False, offsets=None,
                  rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """_ASPPModuleDeformable: modulated deformable conv (+ folded BN) +
    ReLU; offsets and modulator in float32. A canvas-row band passes the
    whole input, its rows' ``offsets`` and the ``rows`` themselves."""
    pad = ks // 2
    offset, modulator = (_deform_offsets(p, x, pad) if offsets is None
                         else offsets)
    y = deform_conv2d(x, offset, modulator, p.conv.w,
                      getattr(p.conv, "b", None), padding=pad,
                      int8_gather=int8_gather, rows=rows)
    return relu(y)


def _apply_aspp(p: Aspp, x: torch.Tensor, cfg: BiRefNetConfig
                ) -> torch.Tensor:
    """ASPPDeformable: the 1x1 deform and the K deform branches, the global
    average branch, concat -> 1x1 (+ BN) -> ReLU. The projection is applied
    per branch, each slice's result summed in float32 (an exact linear
    split: the (n_branch * channelster)-wide concat is never made); the
    broadcast average branch is one 1x1-pixel product."""
    branches: List[torch.Tensor] = [
        _apply_deform(p.aspp1, x, 1, cfg.deform_int8_gather)]
    for bp, s in zip(p.deforms, cfg.aspp_kernel_sizes):
        branches.append(_apply_deform(bp, x, s, cfg.deform_int8_gather))
    return _aspp_project(p, branches, x.float().mean(dim=(1, 2), keepdim=True),
                         x.dtype)


def _aspp_project(p: Aspp, branches: List[torch.Tensor], mean: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """The ASPP tail: the branches and the float32 global average ``mean``
    (B, 1, 1, C) projected, summed, ReLU."""
    gap = relu(_conv(p.gap, mean.to(dtype)))
    w = p.proj.w                            # (cout, n_branch * cs, 1, 1)
    cs = gap.shape[-1]
    y = conv2d(branches[0], w[:, :cs]).float()
    for i, br in enumerate(branches[1:], start=1):
        y = y + conv2d(br, w[:, i * cs:(i + 1) * cs]).float()
    # align_corners resize of a 1x1 map is a broadcast: its projection is a
    # 1x1-pixel product broadcast over the block.
    y = y + conv2d(gap, w[:, len(branches) * cs:]).float()
    y = y + p.proj.b.float()
    return relu(y).to(dtype)  # dropout: eval-mode identity


def _apply_dec_blk(p: DecBlk, x: torch.Tensor, cfg: BiRefNetConfig
                   ) -> torch.Tensor:
    """BasicDecBlk: conv3x3 (+ BN) + ReLU -> ASPPDeformable -> conv3x3."""
    x = relu(_conv(p.conv_in, x, padding=1))
    x = _apply_aspp(p.aspp, x, cfg)
    return _conv(p.conv_out, x, padding=1)


def _apply_simple_convs(p: SimpleConvs, x: torch.Tensor) -> torch.Tensor:
    return _conv(p.conv_out, _conv(p.conv1, x, padding=1), padding=1)


def _gdt_gate(dec: Decoder, idx: int, p: torch.Tensor) -> torch.Tensor:
    """out_ref gate: p * sigmoid(attn(gdt_convs(p)))."""
    return _gdt_attend(dec, idx, p,
                       relu(_conv(getattr(dec, f"gdt{idx}"), p, padding=1)))


def _gdt_attend(dec: Decoder, idx: int, p: torch.Tensor, g: torch.Tensor
                ) -> torch.Tensor:
    """The gate's per-pixel tail on the gdt conv's output g."""
    attn = torch.sigmoid(_conv(getattr(dec, f"gdt_attn{idx}"), g).float())
    return p * attn.to(p.dtype)


def _head_fold(dec: Decoder, p: torch.Tensor, x: torch.Tensor,
               size_hw: Tuple[int, int]) -> torch.Tensor:
    """The level-1 tail, reassociated exactly. Upstream computes
    head(cat(resize(p, S), SimpleConvs_ipt1(x))) with a 1x1 head and an
    align_corners resize, both linear, and no nonlinearity between
    SimpleConvs' two convs, so

        head(cat(up(p), ipt(x))) = up(head_a(p)) + (head_b . ipt)(x) + bias

    where head_b . conv_out is ONE 3x3 inter -> 1 conv,
    w_fold[0, i, k, l] = sum_c w_out[c, i, k, l] * head_w[c], its bias
    folded likewise: one channel is resized instead of ch[3] // 2. A bias
    the tree leaves out adds nothing, as in JAX (where it adds 0.0)."""
    wa, w_fold, bias = _head_weights(dec, p.shape[-1])
    a = resize_align_corners(conv2d(p, wa), size_hw)  # (B, S, S, 1)
    t = _conv(dec.ipt_blk1.conv1, x, padding=1)
    return _head_sum(a, conv2d(t, w_fold.to(t.dtype), padding=1), bias)


def _head_weights(dec: Decoder, cp: int):
    """(head_a (1, cp, 1, 1), the folded 3x3 w_fold (1, inter, 3, 3)
    float32, the folded bias or None) of ``_head_fold``."""
    head_w = dec.head.w                          # (1, cp + ci, 1, 1)
    wb = head_w[0, cp:, 0, 0].float()
    blk = dec.ipt_blk1
    w_fold = torch.einsum("cikl,c->ikl", blk.conv_out.w.float(), wb)[None]
    bias = None
    if hasattr(blk.conv_out, "b"):
        bias = blk.conv_out.b.float() @ wb
    if hasattr(dec.head, "b"):
        hb = dec.head.b.float()
        bias = hb if bias is None else bias + hb
    return head_w[:, :cp], w_fold, bias


def _head_sum(a: torch.Tensor, b: torch.Tensor, bias) -> torch.Tensor:
    out = a + b.to(a.dtype)
    return out if bias is None else out + bias.to(a.dtype)


def _get_patches(x: torch.Tensor, tile: int,
                 rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Decoder.get_patches_batch: the image split into (tile x tile)
    patches stacked into channels, column-major (the W split outer, the H
    split inner: upstream splits along -1 first). ``rows`` = (lo, hi):
    only those rows of the result (a canvas-row band's)."""
    B, H, W, C = x.shape
    nh, nw = H // tile, W // tile
    lo, hi = rows or (0, tile)
    y = x.reshape(B, nh, tile, nw, tile, C)[:, :, lo:hi]
    y = y.permute(0, 2, 4, 3, 1, 5)  # (B, rows, tile, nw, nh, C)
    return y.reshape(B, hi - lo, tile, nw * nh * C)


def birefnet_apply(model: BiRefNet, x: torch.Tensor,
                   cfg: BiRefNetConfig = BiRefNetConfig()) -> torch.Tensor:
    """x: (B, S, S, 3) ImageNet-normalised pixels -> (B, S, S, 1) float32
    logits. S must be divisible by 64 (the half-resolution backbone pass
    at S/2, stride 32)."""
    S = x.shape[1]
    feats = swin_apply(model.backbone, x, cfg.swin)
    if cfg.mul_scl_ipt == "cat":
        x_half = resize_align_corners(x, (S // 2, S // 2))
        feats_half = swin_apply(model.backbone, x_half, cfg.swin)
        feats = [torch.cat([f, resize_align_corners(fh, f.shape[1:3])], dim=-1)
                 for f, fh in zip(feats, feats_half)]
    x1, x2, x3, x4 = feats

    if cfg.cxt_num:
        ctx = [resize_align_corners(f, x4.shape[1:3]) for f in (x1, x2, x3)]
        x4 = torch.cat(ctx[-cfg.cxt_num:] + [x4], dim=-1)
    x4 = _apply_dec_blk(model.squeeze, x4, cfg)

    dec = model.decoder
    # Level 4 (1/32)
    pat = _get_patches(x, x4.shape[1])
    x4 = torch.cat([x4, _apply_simple_convs(dec.ipt_blk5, pat)], dim=-1)
    p4 = _apply_dec_blk(dec.dec4, x4, cfg)
    p4 = _gdt_gate(dec, 4, p4)
    _p4 = resize_align_corners(p4, x3.shape[1:3])
    _p3 = _p4 + _conv(dec.lat4, x3)

    # Level 3 (1/16)
    pat = _get_patches(x, x3.shape[1])
    _p3 = torch.cat([_p3, _apply_simple_convs(dec.ipt_blk4, pat)], dim=-1)
    p3 = _apply_dec_blk(dec.dec3, _p3, cfg)
    p3 = _gdt_gate(dec, 3, p3)
    _p3u = resize_align_corners(p3, x2.shape[1:3])
    _p2 = _p3u + _conv(dec.lat3, x2)

    # Level 2 (1/8)
    pat = _get_patches(x, x2.shape[1])
    _p2 = torch.cat([_p2, _apply_simple_convs(dec.ipt_blk3, pat)], dim=-1)
    p2 = _apply_dec_blk(dec.dec2, _p2, cfg)
    p2 = _gdt_gate(dec, 2, p2)
    _p2u = resize_align_corners(p2, x1.shape[1:3])
    _p1 = _p2u + _conv(dec.lat2, x1)

    # Level 1 (1/4 -> 1/1): the head folded through the resize and concat.
    pat = _get_patches(x, x1.shape[1])
    _p1 = torch.cat([_p1, _apply_simple_convs(dec.ipt_blk2, pat)], dim=-1)
    _p1 = _apply_dec_blk(dec.dec1, _p1, cfg)
    logits = _head_fold(dec, _p1, x, (S, S))
    return logits.float()


# ---------------------------------------------------------------------------
# Seeded values for the leaves the init leaves at zero or one
# ---------------------------------------------------------------------------

def nonzero_init(path: Sequence[str], shape, rng: np.random.Generator,
                 offset_weight_std: float = 0.02,
                 offset_bias_std: float = 2.0) -> Optional[np.ndarray]:
    """Seeded float32 values for a leaf (its tree path or ``state_dict``
    name split at the dots) that the init leaves at zero or one, else None.
    The init zeroes the offset and modulator convs, which makes every
    deformable conv a plain conv (modulator 2 * sigmoid(0) = 1), so a test
    or measurement that must sample off the grid seeds them: offset biases
    of `offset_bias_std` pixels reach past the edges of the deep maps. The
    other conv and linear biases, the LayerNorms and the rel-pos tables
    are seeded too."""
    name, parent = path[-1], (path[-2] if len(path) > 1 else "")
    if parent in ("offset", "modulator"):
        std = (offset_weight_std if name == "w"
               else offset_bias_std if parent == "offset" else 1.0)
    elif name == "rel_bias":
        std = 0.5
    elif name == "b" or ("norm" in parent and name == "bias"):
        std = 0.2
    elif name == "scale":
        return (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    else:
        return None
    return (std * rng.standard_normal(shape)).astype(np.float32)


def seed_nonzero_init(model: nn.Module, seed: int = 0, **stds) -> None:
    """``nonzero_init`` over a model's parameters, in place (cast to each
    parameter's dtype): the same values for every model of one config."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            v = nonzero_init(name.split("."), tuple(p.shape), rng, **stds)
            if v is not None:
                p.copy_(torch.from_numpy(v))
