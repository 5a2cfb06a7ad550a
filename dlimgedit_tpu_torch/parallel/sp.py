"""Sequence-parallel (sp) SAM ViT encoding over a device mesh (counterpart
of dlimgedit_tpu/parallel/sp.py).

The token windows of one image are split over the ('sp',) axis. A SAM ViT
interleaves windowed and global attention over a static window grid, so
between two global blocks no windowed block mixes tokens across windows:
the residual stream lives window-sharded, and every windowed block runs on
the shard's windows alone. Communication happens only at a global block
(every shard gathers the stream) and at the end (the gather before the
neck).

JAX writes this as one ``shard_map``; here its body is a loop over the
mesh's devices. Each shard's windows live on its device beside a replica
of the encoder (``mesh.replica``: the encoder itself on its own device).
JAX's ``all_gather`` is ``torch.cat`` of the shards, each moved to the
receiving device with ``.to``, in shard order; on a repeated device
``.to`` returns the shard itself, so no shard is written in place. Two
forms of the global block, chosen as JAX chooses:

  * ``block_global_replicated`` (with the kernels on, or a quantised qkv):
    every shard runs the whole block on the gathered grid through the one
    canonical body, ``_vit_block_carry``; with ``use_flash_attention`` it
    takes K1, K3 and K4;
  * ``block_global_rows``: queries, proj and MLP on this shard's band of
    grid rows, k and v recomputed from the whole grid, then the bands
    gathered. Its float32 products run at full precision
    (``full_precision``, as every executable stage).

The windowed blocks take K1 twice and K5 when the kernels are on. Pad
tokens are zeroed AFTER the LayerNorm, as the dense path pads the normed
activations, so pad keys see the qkv bias only; dummy windows (added so
that sp divides the window count) and grid padding are cropped at the
end. Numerically the dense path's per-token math (tests/test_torch_sp.py).
The program is eager: it crosses devices.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from ..models.common import conv2d, full_precision, gelu, layer_norm, linear
from ..models.vit_sam import (
    SamViTConfig,
    _layer_norm,
    _patch_embed,
    _vit_attention,
    _vit_block_carry,
    gather_rel_pos,
)
from .mesh import Mesh, cuda_devices, replica

__all__ = ["encode_image_sp", "make_sp_mesh", "sam_vit_apply_sp"]


def make_sp_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D ('sp',) mesh over ``n_devices`` of ``devices`` (default: every
    CUDA device). Fewer visible than requested raises: a silently smaller
    mesh would let parity checks pass while exercising no parallelism, and
    there is no CPU fallback. An explicit list may repeat a device."""
    devices = list(cuda_devices() if devices is None else devices)
    n = n_devices or len(devices)
    if n == 0 or len(devices) < n:
        raise ValueError(f"make_sp_mesh({n}): only {len(devices)} devices "
                         f"visible (pass devices= for a mesh of others)")
    return Mesh(devices[:n], ("sp",))


def _geometry(cfg: SamViTConfig, B: int, sp: int):
    """Static window-grid geometry of the sharded layout. window_size 0
    (every block global in the dense path) is one grid-sized window per
    image."""
    G, ws = cfg.grid, cfg.window_size or cfg.grid
    pad = (ws - G % ws) % ws
    pG = G + pad
    n_side = pG // ws
    n_win = B * n_side * n_side
    n_pad = (-n_win) % sp  # dummy windows so sp divides the window count
    return G, ws, pad, pG, n_side, n_win, n_win + n_pad


def _partition(x: torch.Tensor, ws: int, pad: int, n_extra: int
               ) -> torch.Tensor:
    """(B, G, G, C) grid -> (n_win + n_extra, ws, ws, C) zero-padded
    windows."""
    B, G, _, C = x.shape
    if pad:
        x = F.pad(x, (0, 0, 0, pad, 0, pad))
    n = (G + pad) // ws
    x = x.reshape(B, n, ws, n, ws, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B * n * n, ws, ws, C)
    if n_extra:
        x = F.pad(x, (0, 0, 0, 0, 0, 0, 0, n_extra))
    return x


def _unpartition(wins: torch.Tensor, B: int, G: int, ws: int, pad: int
                 ) -> torch.Tensor:
    """Inverse of _partition (drops dummy windows and grid padding), made
    contiguous (the kernels take contiguous rows)."""
    n = (G + pad) // ws
    C = wins.shape[-1]
    x = wins[: B * n * n].reshape(B, n, n, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, G + pad, G + pad, C)[:, :G, :G, :].contiguous()


def _token_mask(cfg: SamViTConfig, B: int, sp: int, dtype,
                device=None) -> torch.Tensor:
    """(n_win_padded, ws, ws, 1) validity mask: 1 where the token maps to a
    real grid position, 0 at grid padding and dummy windows."""
    G, ws, pad, _, _, _, n_tot = _geometry(cfg, B, sp)
    ones = torch.ones((B, G, G, 1), dtype=dtype, device=device)
    return _partition(ones, ws, pad, n_tot - B * ((G + pad) // ws) ** 2)


def _gather(parts: List[torch.Tensor], device: torch.device, dim: int
            ) -> torch.Tensor:
    """``all_gather(tiled=True)`` as one device receives it."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def sam_vit_apply_sp(model, x: torch.Tensor, cfg: SamViTConfig, mesh: Mesh,
                     axis: str = "sp") -> torch.Tensor:
    """Sequence-parallel ``sam_vit_apply``: the same arguments and a mesh.
    ``model`` is the SamViT encoder; x: (B, S, S, 3) normalised pixels ->
    (B, S/16, S/16, neck_dim) on the mesh's first device."""
    with full_precision():
        return _apply_sp(model, x, cfg, mesh, axis)


def _apply_sp(model, x, cfg, mesh, axis):
    devices = list(mesh.devices.reshape(-1))
    sp = mesh.shape[axis]
    B = x.shape[0]
    G, ws, pad, _, _, n_win, n_tot = _geometry(cfg, B, sp)
    n_loc = n_tot // sp
    n_extra = n_tot - n_win
    d0 = devices[0]
    encoders = [replica(model, (d,)) for d in devices]

    # Patch embed and abs pos on the whole grid (~2% of the encoder's
    # FLOPs), on the first device, before the window split.
    x = x.to(d0)
    x = _patch_embed(encoders[0].patch_embed, x, cfg.patch_size)
    if cfg.use_abs_pos and hasattr(encoders[0], "pos_embed"):
        x = x + encoders[0].pos_embed.to(x.dtype)
    wins0 = _partition(x, ws, pad, n_extra)
    mask0 = _token_mask(cfg, B, sp, x.dtype, d0)
    wins = [wins0[i * n_loc:(i + 1) * n_loc].to(d)
            for i, d in enumerate(devices)]
    masks = [mask0[i * n_loc:(i + 1) * n_loc].to(d)
             for i, d in enumerate(devices)]

    def block_windowed(bp, win, mask):
        # Pad semantics of the dense path: zero AFTER the LayerNorm, so pad
        # keys see the qkv bias only; residual garbage at pads is cropped
        # at the end.
        y1 = _layer_norm(bp.norm1, win, cfg) * mask
        a = _vit_attention(bp, y1, cfg.num_heads, cfg.use_rel_pos,
                           use_flash=cfg.use_flash_attention)
        win = win + a
        y2 = _layer_norm(bp.norm2, win, cfg)
        return win + linear(bp.mlp.lin2, gelu(linear(bp.mlp.lin1, y2)))

    def block_global_replicated(bp, grid):
        h, m = _vit_block_carry(bp, grid, None, cfg)
        return h + m

    def block_global_rows(bp, grid, idx):
        # Row-sharded global block: queries, proj, MLP and the quadratic
        # score / out products on this shard's band of rows; k / v from
        # the whole (unpadded) grid, so no key is masked, and pad-query
        # rows are cropped by the final slice.
        B_, G_, _, C = grid.shape
        nh = cfg.num_heads
        hd = C // nh
        rl = -(-G_ // sp)  # ceil: the band of rows of one shard
        Gp = rl * sp
        y1 = _layer_norm(bp.norm1, grid, cfg)
        y1l = F.pad(y1, (0, 0, 0, 0, 0, Gp - G_))[:, idx * rl:(idx + 1) * rl]
        xl = F.pad(grid, (0, 0, 0, 0, 0, Gp - G_))[:, idx * rl:(idx + 1) * rl]
        w, b = bp.qkv.w, bp.qkv.b
        dt = y1.dtype
        q = y1l.reshape(B_, rl * G_, C) @ w[:, :C].to(dt) + b[:C].to(dt)
        kv = y1.reshape(B_, G_ * G_, C) @ w[:, C:].to(dt) + b[C:].to(dt)
        q = q.reshape(B_, rl * G_, nh, hd).permute(0, 2, 1, 3)
        kv = kv.reshape(B_, G_ * G_, 2, nh, hd).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
        scores = torch.einsum("bnqd,bnkd->bnqk", q.float(),
                              k.float()) * (hd ** -0.5)
        if cfg.use_rel_pos:
            rh = gather_rel_pos(bp.rel_pos_h, G_, bp.rel_pos_idx)
            rw = gather_rel_pos(bp.rel_pos_w, G_, bp.rel_pos_idx)
            rh_loc = F.pad(rh, (0, 0, 0, 0, 0, Gp - G_))[idx * rl:(idx + 1) * rl]
            qr = q.float().reshape(B_, nh, rl, G_, hd)
            bias_h = torch.einsum("bnrwc,rkc->bnrwk", qr,
                                  rh_loc.to(dt).float())
            bias_w = torch.einsum("bnrwc,wlc->bnrwl", qr, rw.to(dt).float())
            scores = scores + (bias_h[..., :, None]
                               + bias_w[..., None, :]).reshape(
                                   B_, nh, rl * G_, G_ * G_)
        probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        out = torch.einsum("bnqk,bnkd->bnqd", probs.float(),
                           v.float()).to(v.dtype)
        out = out.permute(0, 2, 1, 3).reshape(B_, rl, G_, C)
        h = xl + linear(bp.proj, out)
        y2 = _layer_norm(bp.norm2, h, cfg)
        return h + linear(bp.mlp.lin2, gelu(linear(bp.mlp.lin1, y2)))

    rows_form = not cfg.use_flash_attention
    for i in range(len(encoders[0].blocks)):
        blocks = [enc.blocks[i] for enc in encoders]
        if i in cfg.global_attn_indexes:
            if rows_form and hasattr(blocks[0].qkv, "w"):
                bands = []
                for s, (bp, d) in enumerate(zip(blocks, devices)):
                    grid = _unpartition(_gather(wins, d, 0), B, G, ws, pad)
                    bands.append(block_global_rows(bp, grid, s))
                new = []
                for s, d in enumerate(devices):
                    grid = _gather(bands, d, 1)[:, :G]
                    full = _partition(grid, ws, pad, n_extra)
                    new.append(full[s * n_loc:(s + 1) * n_loc])
            else:
                new = []
                for s, (bp, d) in enumerate(zip(blocks, devices)):
                    grid = _unpartition(_gather(wins, d, 0), B, G, ws, pad)
                    grid = block_global_replicated(bp, grid)
                    full = _partition(grid, ws, pad, n_extra)
                    new.append(full[s * n_loc:(s + 1) * n_loc])
            wins = new
        else:
            wins = [block_windowed(bp, w, m)
                    for bp, w, m in zip(blocks, wins, masks)]
    grid = _unpartition(_gather(wins, d0, 0), B, G, ws, pad)

    neck = encoders[0].neck
    grid = conv2d(grid, neck.conv1.w)
    grid = layer_norm(neck.ln1, grid, eps=1e-6)
    grid = conv2d(grid, neck.conv2.w, padding=1)
    return layer_norm(neck.ln2, grid, eps=1e-6)


def encode_image_sp(model, cfg, x: torch.Tensor,
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """SAM-level sequence-parallel encode (ViT-B/L/H). ``model``: a Sam;
    ``cfg``: its SamConfig (``cfg.encoder_vit`` required: TinyViT's conv
    stages have no token axis to shard; it scales over dp). x: (B, S, S,
    3) normalised pixels -> (B, S/16, S/16, 256) on the mesh's first
    device. Eager, under ``torch.no_grad``."""
    if cfg.encoder_vit is None:
        raise ValueError("encode_image_sp needs a ViT encoder variant "
                         "(vit_b/vit_l/vit_h); MobileSAM scales via dp")
    mesh = mesh or make_sp_mesh()
    with torch.no_grad():
        return sam_vit_apply_sp(model.encoder, x, cfg.encoder_vit, mesh)
