"""Canvas-row (spatial) sharding of BiRefNet and the TinyViT encoder over
an ('sp',) mesh (counterpart of dlimgedit_tpu/parallel/spatial.py, and of
the TinyViT branch of its runtime/segmentation.py).

The JAX package states one sharding (the canvas rows over 'sp') and XLA
derives a halo exchange for every layer. PyTorch has no such partitioner,
so the port spells the schedule out as a row-band program:

  * ``Bands``: a band-sharded tensor, one (B, h_i, ...) tensor per device
    of the mesh holding rows [starts[i], starts[i + 1]) of the whole. The
    bands of a level split that level's rows into contiguous ranges of
    ceil(H / sp) rows (``split_rows``); the last may be short or empty, and
    an empty band holds None and computes nothing (S = 64 over 8 devices
    leaves 2 rows at stride 32).
  * ``rows(t, lo, hi, device)``: rows [lo, hi) of a band-sharded tensor on
    ``device``, fetched from whichever bands own them (``.to`` and
    ``torch.cat`` in band order, as parallel/sp.py's gather); rows outside
    [0, H) are zeros, and with ``period`` rows wrap around (Swin's shifted
    windows roll over the padded height). A full all-gather is
    ``rows(t, 0, H, device)``.
  * ``band_map``: each output band fetches the input rows it needs and
    runs the model's own layer function on them. Each layer's output bands
    follow the split of its own level, so levels whose splits do not line
    up (stride 2, 4, 32; the half-resolution pass) need no special case.

The rules, each a wrapper around the model's functions (``PerBand`` holds the
model as each band's device runs it: ``mesh.replica``):

  per-pixel ops (LayerNorm, 1x1 convs, activations, adds, concats): band by
      band (``local``);
  k x k convs, stride s (``conv_rows``): output rows [o0, o1) fetch input
      rows [s o0 - pad, s (o1 - 1) - pad + k), zeros outside the image,
      and run the conv with no row padding;
  window attention (``window_rows``; TinyViT's blocks and Swin's): every
      window that meets the band is fetched whole and computed whole (a
      window that straddles a band edge is computed by both bands; the
      window grid starts at row 0 of the image, the zero pad rows lie only
      below row H), the band keeps its rows; Swin's shifted windows in
      rolled coordinates, fetched cyclically modulo the padded height,
      with the dense shift mask's rows;
  the deformable convs: offsets and modulator by the conv rule, then the
      whole input gathered once per ASPP block (as JAX all-gathers each
      table) and only the band's output rows sampled
      (``deform_conv2d(rows=...)``), so the corner stack, and its int8
      scale, is the dense one;
  the global average: float32 band sums added in band order on each
      band's device, over H * W;
  the align-corners resize: output rows select rows of the resize matrix,
      whose nonzero columns are the input rows fetched (``_ac_span``);
  ``_get_patches`` (every output row reads one row of every tile): the
      3-channel input gathered once per forward and sliced;
  the result: gathered to the mesh's first device as one tensor (JAX
      returns it replicated), so everything downstream is unchanged.

Mesh devices may repeat (``[cpu] * 8`` in the tests, ``[cuda:0] * 4`` on
one card): the bands then run one after another, and no shard is written
in place. The program is eager (it crosses devices); on CUDA tensors the
TinyViT bands launch K1 and K2 at the band shapes (the config's flags, as
the dense encoder), or raise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..models import birefnet as bn
from ..models import swin as sw
from ..models import tinyvit as tv
from ..models.common import conv2d, full_precision, gelu, layer_norm, relu
from .mesh import Mesh, replica
from .sp import make_sp_mesh

__all__ = ["Bands", "birefnet_apply_bands", "birefnet_apply_spatial",
           "make_spatial_mesh", "rows", "segment_image_spatial",
           "shard_rows", "split_rows", "tinyvit_apply_spatial"]

# The same 1-D mesh as the sequence-parallel tier; its axis is rows here
# instead of window shards, so one ('sp',) serving mesh serves both.
make_spatial_mesh = make_sp_mesh


# ---------------------------------------------------------------------------
# The layout and the fetch
# ---------------------------------------------------------------------------

def split_rows(H: int, n: int) -> Tuple[int, ...]:
    """The n + 1 band starts of H rows over n bands: ceil(H / n) rows a
    band, the last bands short or empty."""
    c = -(-H // n)
    return tuple(min(i * c, H) for i in range(n + 1))


@dataclass(eq=False)
class Bands:
    """A tensor's rows (its dim 1) over devices: ``parts[i]``, on
    ``devices[i]``, holds rows [starts[i], starts[i + 1]), or is None when
    that range is empty."""
    parts: List[Optional[torch.Tensor]]
    starts: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    @property
    def H(self) -> int:
        return self.starts[-1]

    def band(self, i: int) -> Tuple[int, int]:
        return self.starts[i], self.starts[i + 1]

    @property
    def ref(self) -> torch.Tensor:
        """A nonempty part (for the trailing shape and the dtype)."""
        return next(p for p in self.parts if p is not None)

    @property
    def W(self) -> int:
        return self.ref.shape[2]


def shard_rows(x: torch.Tensor, devices: Sequence[torch.device]) -> Bands:
    """The whole tensor ``x`` laid out over ``devices`` by rows: each band
    a contiguous copy on its device."""
    starts = split_rows(x.shape[1], len(devices))
    parts = [x[:, lo:hi].contiguous().to(d) if hi > lo else None
             for d, lo, hi in zip(devices, starts, starts[1:])]
    return Bands(parts, starts, tuple(devices))


def rows(t: Bands, lo: int, hi: int, device: torch.device,
         period: Optional[int] = None) -> torch.Tensor:
    """Rows [lo, hi) of ``t`` on ``device``, one contiguous tensor. Rows
    outside [0, H) are zeros; with ``period``, row r is row r mod period
    and rows in [H, period) are zeros."""
    ref = t.ref
    pieces = []

    def zeros(n):
        pieces.append(torch.zeros((ref.shape[0], n) + ref.shape[2:],
                                  dtype=ref.dtype, device=device))

    segments = []
    r = lo
    while r < hi:  # runs that do not wrap
        m = r if period is None else r % period
        n = hi - r if period is None else min(hi - r, period - m)
        segments.append((m, m + n))
        r += n
    for a, b in segments:
        if a < 0:
            zeros(min(b, 0) - a)
        for i, part in enumerate(t.parts):
            s0, s1 = t.band(i)
            c0, c1 = max(a, s0, 0), min(b, s1)
            if c0 < c1:
                pieces.append(part[:, c0 - s0:c1 - s0].to(device))
        if max(a, t.H) < b:
            zeros(b - max(a, t.H))
    if len(pieces) == 1:
        return pieces[0].contiguous()
    return torch.cat(pieces, dim=1)


def gather(t: Bands, device: torch.device) -> torch.Tensor:
    """The whole tensor on ``device``."""
    return rows(t, 0, t.H, device)


def band_map(t: Bands, h_out: int, need: Callable[[int, int], Tuple[int, int]],
             fn: Callable, period: Optional[int] = None) -> Bands:
    """An ``h_out``-row output over t's devices: band i's output rows [o0,
    o1) are fn(i, x, o0, o1), x the input rows ``need(o0, o1)`` fetched
    onto band i's device. An empty output band computes nothing."""
    starts = split_rows(h_out, len(t.devices))
    parts = []
    for i, d in enumerate(t.devices):
        o0, o1 = starts[i], starts[i + 1]
        if o0 == o1:
            parts.append(None)
            continue
        lo, hi = need(o0, o1)
        parts.append(fn(i, rows(t, lo, hi, d, period), o0, o1))
    return Bands(parts, starts, t.devices)


def local(fn: Callable, *ts: Bands) -> Bands:
    """A per-pixel op band by band: fn(i, *the band's parts), all inputs
    at one level (one split)."""
    t0 = ts[0]
    assert all(t.starts == t0.starts for t in ts), "bands of two levels"
    parts = [None if p is None else fn(i, *(t.parts[i] for t in ts))
             for i, p in enumerate(t0.parts)]
    return Bands(parts, t0.starts, t0.devices)


def conv_rows(t: Bands, k: int, fn: Callable, stride: int = 1,
              pad: Optional[int] = None, h_out: Optional[int] = None
              ) -> Bands:
    """A k x k conv with ``stride`` and ``pad`` zero rows each side
    (default k // 2): output band [o0, o1) fetches input rows
    [stride o0 - pad, stride (o1 - 1) - pad + k) and runs fn(i, x,
    padding), padding = (0, pad), the model's conv with the row padding
    already fetched. ``h_out``: when the layer pads other than the conv
    would (Swin's patch merge pads an odd H by one bottom row)."""
    pad = k // 2 if pad is None else pad
    if h_out is None:
        h_out = (t.H + 2 * pad - k) // stride + 1
    return band_map(t, h_out,
                    lambda o0, o1: (stride * o0 - pad,
                                    stride * (o1 - 1) - pad + k),
                    lambda i, x, o0, o1: fn(i, x, (0, pad)))


def window_rows(t: Bands, ws: int, fn: Callable, shift: int = 0) -> Bands:
    """Window attention over ws-row windows from row 0 of the image (the
    height padded with zero rows to pH, a multiple of ws), the rows rolled
    up by ``shift`` (Swin's shifted windows): band [o0, o1) fetches every
    window that meets its rows, cyclically modulo pH, and runs fn(i, x, a)
    on those whole windows; x's first row is rolled row a (a multiple of
    ws; -ws is the last window, which wraps). The band keeps its rows."""
    pH = -(-t.H // ws) * ws

    def span(o0, o1):
        return ((o0 - shift) // ws) * ws, -(-(o1 - shift) // ws) * ws

    def need(o0, o1):
        a, b = span(o0, o1)
        return a + shift, b + shift

    def run(i, x, o0, o1):
        a = span(o0, o1)[0]
        return fn(i, x, a)[:, o0 - shift - a:o1 - shift - a].contiguous()

    return band_map(t, t.H, need, run, period=pH)


def _ac_span(n_out: int, n_in: int, o0: int, o1: int) -> Tuple[int, int]:
    """The input rows [c0, c1) that rows [o0, o1) of ``_ac_matrix(n_out,
    n_in)`` read (its nonzero columns), from its float64 positions."""
    def first(i):
        if n_in == 1 or n_out == 1:
            return 0
        return min(math.floor(i * (n_in - 1) / (n_out - 1)), n_in - 1)

    return first(o0), min(first(o1 - 1) + 1, n_in - 1) + 1


def resize_rows(t: Bands, size_hw: Tuple[int, int]) -> Bands:
    """``resize_align_corners`` on bands: output rows [o0, o1) multiply
    their rows of the row matrix by the input rows those read."""
    h, w = size_hw
    H, W = t.H, t.W
    if (H, W) == (h, w):
        return t

    def run(i, x, o0, o1):
        c0, c1 = _ac_span(h, H, o0, o1)
        R = bn._ac_matrix(h, H, x.device)[o0:o1, c0:c1]
        return bn._apply_ac(R, bn._ac_matrix(w, W, x.device), x)

    return band_map(t, h, lambda o0, o1: _ac_span(h, H, o0, o1), run)


def mean_rows(t: Bands) -> List[Optional[torch.Tensor]]:
    """The float32 global average (B, 1, 1, C) on each nonempty band's
    device: the band sums added in band order, over H * W."""
    sums = [None if p is None else p.float().sum(dim=(1, 2), keepdim=True)
            for p in t.parts]
    out = []
    for p, d in zip(t.parts, t.devices):
        acc = None
        for s in sums:
            if s is not None:
                acc = s.to(d) if acc is None else acc + s.to(d)
        out.append(None if p is None else acc / (t.H * t.W))
    return out


def _whole(t: Bands) -> Dict[torch.device, torch.Tensor]:
    """The whole tensor on each of t's devices, gathered once a device."""
    return {d: gather(t, d) for d in dict.fromkeys(t.devices)}


def _cat(i, *parts):
    return torch.cat(parts, dim=-1)


def _add(i, a, b):
    return a + b


class PerBand:
    """The model as each band's device runs it (one module per band);
    attribute access and indexing map over them, ``at(i)`` is band i's."""

    def __init__(self, mods: Sequence):
        self.mods = list(mods)

    def __getattr__(self, name):
        if name.startswith("__") or name == "mods":
            raise AttributeError(name)
        return PerBand([getattr(m, name) for m in self.mods])

    def __getitem__(self, j):
        return PerBand([m[j] for m in self.mods])

    def __len__(self):
        return len(self.mods[0])

    def at(self, i: int):
        return self.mods[i]


def _mesh_devices(mesh: Mesh, axis: str) -> Tuple[torch.device, ...]:
    if tuple(mesh.shape) != (axis,):
        raise ValueError(f"canvas-row sharding needs a ({axis!r},) mesh, "
                         f"got axes {tuple(mesh.shape)}")
    return tuple(mesh.devices.reshape(-1))


def _replicas(model: torch.nn.Module, devices: Sequence[torch.device]
              ) -> PerBand:
    """The model per band: itself on its own device, else ``replica``'s
    cached copy on the band's device."""
    return PerBand([replica(model, (d,)) for d in devices])


# ---------------------------------------------------------------------------
# Swin and BiRefNet on bands
# ---------------------------------------------------------------------------

def _shift_mask_rows(pH: int, pW: int, ws: int, shift: int, a: int, h: int,
                     device) -> torch.Tensor:
    """The dense shift mask's windows for rolled rows [a, a + h)."""
    N = ws * ws
    nH, n = pH // ws, h // ws
    full = sw._shift_attn_mask(pH, pW, ws, shift, device)
    full = full.reshape(nH, pW // ws, N, N)
    first = (a // ws) % nH
    part = (full[first:first + n] if first + n <= nH
            else torch.cat([full[first:], full[:first + n - nH]]))
    return part.reshape(-1, N, N)


def _swin_block_bands(P: PerBand, x: Bands, num_heads: int, ws: int,
                      shift: int, eps: float) -> Bands:
    y = local(lambda i, v: layer_norm(P.at(i).norm1, v, eps=eps), x)
    pH, pW = sw._padded(x.H, ws), sw._padded(x.W, ws)

    def attend(i, v, a):
        mask = (_shift_mask_rows(pH, pW, ws, shift, a, v.shape[1], v.device)
                if shift > 0 else None)
        return sw._attend_rows(P.at(i), v, num_heads, ws, shift, mask)

    att = window_rows(y, ws, attend, shift)
    return local(lambda i, s, v: sw._swin_tail(P.at(i), s, v, eps), x, att)


def swin_apply_bands(P: PerBand, x: Bands, cfg: sw.SwinConfig) -> List[Bands]:
    """``swin_apply`` on bands: the 4-level pyramid, each level's bands."""
    eps = cfg.layer_norm_eps
    x = conv_rows(x, cfg.patch_size,
                  lambda i, v, pad: sw._patch_embed(P.patch_embed.at(i), v,
                                                    cfg, pad),
                  stride=cfg.patch_size, pad=0)
    feats = []
    for s in range(len(P.stages)):
        stage = P.stages[s]
        for j in range(len(stage.blocks)):
            shift = 0 if j % 2 == 0 else cfg.window // 2
            x = _swin_block_bands(stage.blocks[j], x, cfg.num_heads[s],
                                  cfg.window, shift, eps)
        feats.append(local(lambda i, v: layer_norm(stage.out_norm.at(i), v,
                                                   eps=eps), x))
        if hasattr(stage, "downsample"):
            x = conv_rows(x, 2, lambda i, v, pad: sw._patch_merge(
                stage.downsample.at(i), v, eps),
                stride=2, pad=0, h_out=-(-x.H // 2))
    return feats


def _conv3(P: PerBand, x: Bands, act: bool = False) -> Bands:
    """A BiRefNet 3x3 ``_conv`` (padding 1), ReLU with ``act``."""
    def run(i, v, pad):
        y = bn._conv(P.at(i), v, padding=pad)
        return relu(y) if act else y
    return conv_rows(x, 3, run)


def _aspp_bands(P: PerBand, x: Bands, cfg: bn.BiRefNetConfig) -> Bands:
    whole = _whole(x)
    branches = []
    for dp, ks in [(P.aspp1, 1)] + [(P.deforms[j], s) for j, s in
                                    enumerate(cfg.aspp_kernel_sizes)]:
        offsets = conv_rows(x, ks, lambda i, v, pad: bn._deform_offsets(
            dp.at(i), v, pad))
        branches.append([None if off is None else bn._apply_deform(
            dp.at(i), whole[x.devices[i]], ks, cfg.deform_int8_gather,
            offsets=off, rows=x.band(i))
            for i, off in enumerate(offsets.parts)])
    means = mean_rows(x)
    dtype = x.ref.dtype
    parts = [None if p is None else bn._aspp_project(
        P.at(i), [br[i] for br in branches], means[i], dtype)
        for i, p in enumerate(x.parts)]
    return Bands(parts, x.starts, x.devices)


def _dec_blk_bands(P: PerBand, x: Bands, cfg: bn.BiRefNetConfig) -> Bands:
    x = _conv3(P.conv_in, x, act=True)
    return _conv3(P.conv_out, _aspp_bands(P.aspp, x, cfg))


def _patches(whole: Dict, devices, tile: int) -> Bands:
    starts = split_rows(tile, len(devices))
    parts = [None if lo == hi else bn._get_patches(whole[d], tile, (lo, hi))
             for d, lo, hi in zip(devices, starts, starts[1:])]
    return Bands(parts, starts, tuple(devices))


def _head_fold_bands(dec: PerBand, p: Bands, x: Bands) -> Bands:
    weights = [bn._head_weights(dec.at(i), p.ref.shape[-1])
               for i in range(len(p.devices))]
    a = local(lambda i, v: conv2d(v, weights[i][0]), p)
    a = resize_rows(a, (x.H, x.W))
    t = _conv3(dec.ipt_blk1.conv1, x)
    b = conv_rows(t, 3, lambda i, v, pad: conv2d(
        v, weights[i][1].to(v.dtype), padding=pad))
    return local(lambda i, u, v: bn._head_sum(u, v, weights[i][2]), a, b)


def birefnet_apply_bands(P: PerBand, x: Bands, cfg: bn.BiRefNetConfig
                         ) -> Bands:
    """``birefnet_apply`` on bands: ``P`` the model per band, x the
    normalised pixels' bands -> the logits' bands (B, h_i, S, 1), in the
    compute dtype."""
    S = x.H
    feats = swin_apply_bands(P.backbone, x, cfg.swin)
    if cfg.mul_scl_ipt == "cat":
        half = swin_apply_bands(P.backbone, resize_rows(x, (S // 2, S // 2)),
                                cfg.swin)
        feats = [local(_cat, f, resize_rows(fh, (f.H, f.W)))
                 for f, fh in zip(feats, half)]
    x1, x2, x3, x4 = feats
    if cfg.cxt_num:
        ctx = [resize_rows(f, (x4.H, x4.W)) for f in (x1, x2, x3)]
        x4 = local(_cat, *(ctx[-cfg.cxt_num:] + [x4]))
    p = _dec_blk_bands(P.squeeze, x4, cfg)

    dec = P.decoder
    whole = _whole(x)  # the 3-channel input, for every level's patches
    for k, skip in ((4, x3), (3, x2), (2, x1), (1, None)):
        ipt = getattr(dec, f"ipt_blk{k + 1}")
        pat = _conv3(ipt.conv_out, _conv3(ipt.conv1,
                                          _patches(whole, x.devices, p.H)))
        p = _dec_blk_bands(getattr(dec, f"dec{k}"), local(_cat, p, pat), cfg)
        if skip is None:
            break
        g = _conv3(getattr(dec, f"gdt{k}"), p, act=True)
        p = local(lambda i, u, v: bn._gdt_attend(dec.at(i), k, u, v), p, g)
        lat = local(lambda i, v: bn._conv(getattr(dec.at(i), f"lat{k}"), v),
                    skip)
        p = local(_add, resize_rows(p, (skip.H, skip.W)), lat)
    return _head_fold_bands(dec, p, x)


def birefnet_apply_spatial(model: bn.BiRefNet, x: torch.Tensor,
                           cfg: bn.BiRefNetConfig, mesh: Mesh,
                           axis: str = "sp") -> torch.Tensor:
    """Row-sharded ``birefnet_apply``: the same contract and a mesh. x:
    (B, S, S, 3) ImageNet-normalised pixels, laid out over the mesh's rows
    on entry; -> (B, S, S, 1) float32 logits, whole, on the mesh's first
    device. Float32 at full precision, as every executable stage."""
    devices = _mesh_devices(mesh, axis)
    with full_precision():
        out = birefnet_apply_bands(_replicas(model, devices),
                                   shard_rows(x, devices), cfg)
        return gather(out, devices[0]).float()


def segment_image_spatial(model: bn.BiRefNet, cfg: bn.BiRefNetConfig,
                          x: torch.Tensor, mesh: Optional[Mesh] = None
                          ) -> torch.Tensor:
    """BiRefNet logits of one (or a few) images with the rows over every
    device of ``mesh`` (default: every CUDA device): the single-image
    latency analog of ``segment_frames``. Under ``torch.no_grad``."""
    mesh = mesh or make_spatial_mesh()
    with torch.no_grad():
        return birefnet_apply_spatial(model, x, cfg, mesh)


# ---------------------------------------------------------------------------
# TinyViT on bands
# ---------------------------------------------------------------------------

def _mbconv_bands(P: PerBand, x: Bands) -> Bands:
    h = local(lambda i, v: gelu(P.at(i).conv1(v)), x)
    h = conv_rows(h, 3, lambda i, v, pad: gelu(P.at(i).conv2(v, padding=pad)))
    return local(lambda i, s, v: gelu(P.at(i).conv3(v) + s), x, h)


def _merge_bands(P: PerBand, x: Bands, stride: int) -> Bands:
    h = local(lambda i, v: gelu(P.at(i).conv1(v)), x)
    h = conv_rows(h, 3, lambda i, v, pad: gelu(
        P.at(i).conv2(v, stride=stride, padding=pad)), stride=stride)
    return local(lambda i, v: P.at(i).conv3(v), h)


def _block_bands(P: PerBand, x: Bands, cfg: tv.TinyViTConfig, ws: int
                 ) -> Bands:
    att = window_rows(x, ws, lambda i, v, a: P.at(i).attend(v, cfg))
    x = local(_add, x, att)
    x = conv_rows(x, cfg.local_conv_size,
                  lambda i, v, pad: P.at(i).local_conv(v, padding=pad))
    return local(lambda i, v: v + tv._mlp_ln(P.at(i).mlp, v, cfg), x)


def tinyvit_apply_bands(P: PerBand, x: Bands, cfg: tv.TinyViTConfig) -> Bands:
    """``TinyViT.forward`` on bands -> the embedding's bands."""
    pe = P.patch_embed
    x = conv_rows(x, 3, lambda i, v, pad: gelu(
        pe.conv1.at(i)(v, stride=2, padding=pad)), stride=2)
    x = conv_rows(x, 3, lambda i, v, pad: pe.conv2.at(i)(
        v, stride=2, padding=pad), stride=2)
    for s in range(len(P.stages)):
        stage = P.stages[s]
        for j in range(len(stage.blocks)):
            blk = stage.blocks[j]
            x = (_mbconv_bands(blk, x) if s == 0 else
                 _block_bands(blk, x, cfg, cfg.window_sizes[s]))
        if hasattr(stage, "downsample"):
            x = _merge_bands(stage.downsample, x, tv.merge_stride(cfg, s))
    neck = P.neck
    x = local(lambda i, v: tv._ln(neck.ln1.at(i),
                                  conv2d(v, neck.conv1.at(i).w), cfg,
                                  eps=1e-6), x)
    x = conv_rows(x, 3, lambda i, v, pad: conv2d(v, neck.conv2.at(i).w,
                                                 padding=pad))
    return local(lambda i, v: tv._ln(neck.ln2.at(i), v, cfg, eps=1e-6), x)


def tinyvit_apply_spatial(model: tv.TinyViT, x: torch.Tensor,
                          cfg: tv.TinyViTConfig, mesh: Mesh,
                          axis: str = "sp") -> torch.Tensor:
    """Row-sharded TinyViT (MobileSAM's encoder): x (B, S, S, 3)
    normalised pixels -> the (B, S/16, S/16, neck_dim) embedding, whole,
    on the mesh's first device. With ``cfg``'s kernel flags every band
    runs K1 and K2 on its rows and windows."""
    devices = _mesh_devices(mesh, axis)
    with full_precision():
        out = tinyvit_apply_bands(_replicas(model, devices),
                                  shard_rows(x, devices), cfg)
        return gather(out, devices[0])
