"""Attention kernels of the encoders — K2, K4 and K5.

Counterpart of dlimgedit_tpu/ops/flash_attention.py:

  * ``levit_window_attention`` (K2, ``csrc/levit_attention.cu``; JAX :531):
    TinyViT's window attention with a static per-head bias;
  * ``flash_attention_relpos`` (JAX :443): the SAM ViT's attention with the
    decomposed relative-position bias, routed as in JAX to
    ``relpos_attention_windowed`` (K5; JAX ``_attention_head_fused``, :307)
    for windows (N <= 256 with ``heads`` given) and to
    ``relpos_attention_global`` (K4; JAX ``_attention_grouped``, :139)
    otherwise, both in ``csrc/relpos_attention.cu``.

On a CUDA tensor each wrapper launches its hand-written kernel; on a CPU
tensor it computes the plain PyTorch version (``levit_window_attention_plain``,
``attention_relpos_plain``), which repeats the JAX kernels' rounding. The
bias halves [q.rh | q.rw] are plain tensor work outside the kernels, as in
JAX (``_bias_halves``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..errors import DlimgError
from .cuda_build import DTYPE_CODES, LIBRARY, check_launch

# The K2 kernel's head width and largest window (csrc/levit_attention.cu).
KERNEL_HEAD_DIM = 32
KERNEL_MAX_TOKENS = 256
# Head widths K4 and K5 are instantiated for (csrc/relpos_attention.cu):
# SAM ViT-B/L (64) and ViT-H (80).
KERNEL_HEAD_DIMS = (64, 80)


def levit_window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                                 num_heads: int) -> torch.Tensor:
    """qkv: (G, N, nh * 3 * kd), per head [q | k | v]; bias: (nh, N, N).
    Scores and softmax in float32, probabilities rounded to qkv's dtype
    before p @ v, which accumulates in float32. Returns (G, N, nh * kd)."""
    G, N, H = qkv.shape
    kd = H // (3 * num_heads)
    qkv4 = qkv.reshape(G, N, num_heads, 3 * kd)
    q = qkv4[..., :kd].float()
    k = qkv4[..., kd:2 * kd].float()
    v = qkv4[..., 2 * kd:]
    s = torch.einsum("gnhd,gmhd->ghnm", q, k) * (kd ** -0.5)
    s = s + bias.float()[None]
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    out = torch.einsum("ghnm,gmhd->gnhd", p.float(), v.float())
    return out.to(qkv.dtype).reshape(G, N, num_heads * kd)


def _check(qkv, bias, num_heads):
    if qkv.dim() != 3:
        raise DlimgError(f"levit_window_attention: qkv must be (G, N, H), "
                         f"got {tuple(qkv.shape)}")
    G, N, H = qkv.shape
    kd, rem = divmod(H, num_heads * 3)
    if rem:
        raise DlimgError(
            f"levit_window_attention: qkv channel dim {H} is not "
            f"num_heads({num_heads}) * 3 * kd")
    if tuple(bias.shape) != (num_heads, N, N):
        raise DlimgError(f"levit_window_attention: bias {tuple(bias.shape)} "
                         f"must be ({num_heads}, {N}, {N})")
    if qkv.device != bias.device:
        raise DlimgError("levit_window_attention: qkv and bias must share a "
                         "device")
    if not qkv.is_cuda:
        return kd
    if str(qkv.dtype) not in DTYPE_CODES or bias.dtype != qkv.dtype:
        raise DlimgError(f"levit_window_attention: the CUDA kernel takes "
                         f"float32 or bfloat16 qkv and bias of one dtype, got "
                         f"{qkv.dtype} and {bias.dtype}")
    if kd != KERNEL_HEAD_DIM or not 0 < N <= KERNEL_MAX_TOKENS:
        raise DlimgError(f"levit_window_attention: the CUDA kernel takes "
                         f"kd == {KERNEL_HEAD_DIM} and N <= "
                         f"{KERNEL_MAX_TOKENS}, got kd={kd}, N={N}")
    if not (qkv.is_contiguous() and bias.is_contiguous()):
        raise DlimgError("levit_window_attention: inputs must be contiguous")
    return kd


def levit_window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """Biased window attention for TinyViT (LeViT construction).

    qkv: (G, N, nh * 3 * kd), the qkv linear's output per window;
    bias: (nh, N, N), the gathered attention-bias table. Returns
    (G, N, nh * kd). CUDA tensors go through the K2 kernel (and count one
    launch in ``levit_window_attention.launches``)."""
    kd = _check(qkv, bias, num_heads)
    if qkv.device.type == "cpu":
        return levit_window_attention_plain(qkv, bias, num_heads)
    if not qkv.is_cuda:
        raise DlimgError(f"levit_window_attention: unsupported device "
                         f"{qkv.device}")
    G, N, _ = qkv.shape
    out = torch.empty((G, N, num_heads * kd), dtype=qkv.dtype,
                      device=qkv.device)
    lib = LIBRARY.get()
    rc = lib.dlimg_levit_attention(
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), G, N, num_heads, kd,
        DTYPE_CODES[str(qkv.dtype)], float(kd ** -0.5),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    check_launch("levit_window_attention", rc)
    levit_window_attention.launches += 1
    return out


levit_window_attention.launches = 0


# ---------------------------------------------------------------------------
# Rel-pos attention of the SAM ViT encoders (K4, K5)
# ---------------------------------------------------------------------------

def _gathered_tables(rh: torch.Tensor, rw: torch.Tensor, grid_h: int,
                     grid_w: int, dtype: torch.dtype):
    """Raw (2*g-1, hd) tables -> gathered (g, g, hd) with
    rh_g[yi, yj] = rh[yi - yj + gh - 1]; likewise rw along x."""
    idx_h = np.arange(grid_h)[:, None] - np.arange(grid_h)[None, :] + grid_h - 1
    idx_w = np.arange(grid_w)[:, None] - np.arange(grid_w)[None, :] + grid_w - 1
    rh_g = rh[torch.from_numpy(idx_h).to(rh.device)]
    rw_g = rw[torch.from_numpy(idx_w).to(rw.device)]
    return rh_g.to(dtype), rw_g.to(dtype)


def _bias_halves(q: torch.Tensor, rh_g: torch.Tensor, rw_g: torch.Tensor,
                 grid_h: int, grid_w: int, out_scale: float = 1.0
                 ) -> torch.Tensor:
    """[q.rh | q.rw] bias halves, (G, N, gh + gw), in q's dtype.

    Products in float32 from q and the tables in q's dtype; ``out_scale``
    multiplies the float32 result BEFORE the one rounding to q's dtype (the
    folded bias takes bias / scale, which the score's ``* scale`` restores).
    JAX's two contraction orders (``mode`` "grid" / "expand") were a TPU
    layout choice; this is the "grid" form."""
    G, N, hd = q.shape
    q4 = q.float().reshape(G, grid_h, grid_w, hd)
    bh = torch.einsum("ghwd,hyd->ghwy", q4, rh_g.to(q.dtype).float())
    bw = torch.einsum("ghwd,wyd->ghwy", q4, rw_g.to(q.dtype).float())
    b = torch.cat([bh, bw], dim=-1).reshape(G, N, grid_h + grid_w)
    if out_scale != 1.0:
        b = b * out_scale
    return b.to(q.dtype)


def _skip_rows(G: int, N: int, grid_h: int, grid_w: int,
               heads: Optional[int], n_w: Optional[int],
               valid_rows: Optional[int]) -> Tuple[int, int]:
    """(first group with the pad-query skip, query rows it keeps): the last
    n_w windows (of G // heads) keep only valid_rows * grid_w query rows.
    (G, N) when the skip does not apply (JAX's conditions, :344)."""
    if heads is None or n_w is None or valid_rows is None:
        return G, N
    W = G // heads
    if 0 < valid_rows < grid_h and 0 < n_w < W:
        return (W - n_w) * heads, valid_rows * grid_w
    return G, N


def attention_relpos_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bhw: torch.Tensor, grid_h: int, grid_w: int, *,
                           folded: bool = False, heads: Optional[int] = None,
                           n_w: Optional[int] = None,
                           valid_rows: Optional[int] = None) -> torch.Tensor:
    """The plain version of K4 and K5. q, k, v: (G, N, hd); bhw: (G, N,
    gh + gw) in q's dtype (from ``_bias_halves``; divided by the scale when
    ``folded``). Scores in float32: q.k * scale + (bh + bw), or
    (q.k + bh + bw) * scale when folded; exact float32 softmax; p rounded to
    q's dtype before p.v, which accumulates in float32. With ``heads``,
    ``n_w`` and ``valid_rows`` the skipped pad-query rows of the last n_w
    windows are zero."""
    G, N, hd = q.shape
    scale = hd ** -0.5
    tok = torch.arange(N, device=q.device)
    b = bhw.float()
    bias = b[:, :, :grid_h][:, :, tok // grid_w] + b[:, :, grid_h:][:, :, tok % grid_w]
    qk = q.float() @ k.float().transpose(1, 2)
    s = (qk + bias) * scale if folded else qk * scale + bias
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = (p.float() @ v.float()).to(q.dtype)
    g_skip, n_valid = _skip_rows(G, N, grid_h, grid_w, heads, n_w, valid_rows)
    if g_skip < G:
        out[g_skip:, n_valid:] = 0
    return out


def _check_relpos(name, q, k, v, bhw, grid_h, grid_w):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise DlimgError(f"{name}: q, k, v must be (G, N, hd) of one shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    G, N, hd = q.shape
    if N != grid_h * grid_w:
        raise DlimgError(f"{name}: N = {N} is not grid_h * grid_w = "
                         f"{grid_h} * {grid_w}")
    if tuple(bhw.shape) != (G, N, grid_h + grid_w):
        raise DlimgError(f"{name}: bias halves {tuple(bhw.shape)} must be "
                         f"({G}, {N}, {grid_h + grid_w})")
    tensors = (q, k, v, bhw)
    if any(t.device != q.device for t in tensors):
        raise DlimgError(f"{name}: all inputs must share a device")
    if not q.is_cuda:
        return
    if str(q.dtype) not in DTYPE_CODES or any(t.dtype != q.dtype
                                              for t in tensors):
        raise DlimgError(f"{name}: the CUDA kernel takes float32 or bfloat16 "
                         f"inputs of one dtype")
    if hd not in KERNEL_HEAD_DIMS:
        raise DlimgError(f"{name}: no CUDA kernel for head width {hd} (have "
                         f"{KERNEL_HEAD_DIMS})")
    if not all(t.is_contiguous() for t in tensors):
        raise DlimgError(f"{name}: inputs must be contiguous")


def relpos_attention_global(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bhw: torch.Tensor, grid_h: int,
                            grid_w: int) -> torch.Tensor:
    """Rel-pos attention over G groups of N = grid_h * grid_w tokens (the
    ViT's global blocks). CUDA tensors go through K4 (one launch counted in
    ``relpos_attention_global.launches``); CPU tensors through
    ``attention_relpos_plain``."""
    name = "relpos_attention_global"
    _check_relpos(name, q, k, v, bhw, grid_h, grid_w)
    if q.device.type == "cpu":
        return attention_relpos_plain(q, k, v, bhw, grid_h, grid_w)
    if not q.is_cuda:
        raise DlimgError(f"{name}: unsupported device {q.device}")
    G, N, hd = q.shape
    out = torch.empty_like(q)
    rc = LIBRARY.get().dlimg_relpos_attention_global(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bhw.data_ptr(),
        out.data_ptr(), G, N, hd, grid_h, grid_w, DTYPE_CODES[str(q.dtype)],
        float(hd ** -0.5), torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(name, rc)
    relpos_attention_global.launches += 1
    return out


relpos_attention_global.launches = 0


def relpos_attention_windowed(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bhw: torch.Tensor, grid_h: int,
                              grid_w: int, heads: int, folded: bool,
                              n_w: Optional[int] = None,
                              valid_rows: Optional[int] = None
                              ) -> torch.Tensor:
    """Rel-pos attention over windows: G = windows * heads groups, head
    fastest, with the folded bias when ``folded`` and the pad-query skip of
    the last ``n_w`` windows (only their first ``valid_rows`` window rows
    are computed; the rest are zero). CUDA tensors go through K5 (one launch
    counted in ``relpos_attention_windowed.launches``); CPU tensors through
    ``attention_relpos_plain``."""
    name = "relpos_attention_windowed"
    _check_relpos(name, q, k, v, bhw, grid_h, grid_w)
    if q.shape[0] % heads:
        raise DlimgError(f"{name}: G = {q.shape[0]} is not a multiple of "
                         f"heads = {heads}")
    if q.device.type == "cpu":
        return attention_relpos_plain(q, k, v, bhw, grid_h, grid_w,
                                      folded=folded, heads=heads, n_w=n_w,
                                      valid_rows=valid_rows)
    if not q.is_cuda:
        raise DlimgError(f"{name}: unsupported device {q.device}")
    G, N, hd = q.shape
    g_skip, n_valid = _skip_rows(G, N, grid_h, grid_w, heads, n_w, valid_rows)
    out = torch.empty_like(q)
    rc = LIBRARY.get().dlimg_relpos_attention_windowed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bhw.data_ptr(),
        out.data_ptr(), G, N, hd, grid_h, grid_w, int(folded), g_skip,
        n_valid, DTYPE_CODES[str(q.dtype)], float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(name, rc)
    relpos_attention_windowed.launches += 1
    return out


relpos_attention_windowed.launches = 0


def flash_attention_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rh: torch.Tensor, rw: torch.Tensor, *, grid_h: int,
                           grid_w: int, heads: Optional[int] = None,
                           n_w: Optional[int] = None,
                           valid_rows: Optional[int] = None) -> torch.Tensor:
    """Rel-pos attention over (G, N, hd) groups, N == grid_h * grid_w.

    rh / rw: gathered (g, g, hd) or raw (2*g-1, hd) tables. With ``heads``
    (groups are windows * heads, head fastest) and N <= 256 the windowed
    kernel K5 runs, with the folded bias when hd + gh + gw <= 128 and the
    pad-query skip given by n_w / valid_rows; otherwise the global kernel
    K4. The routing is JAX's (flash_attention.py:464)."""
    G, N, hd = q.shape
    if rh.dim() == 2:
        rh_g, rw_g = _gathered_tables(rh, rw, grid_h, grid_w, q.dtype)
    else:
        rh_g, rw_g = rh.to(q.dtype), rw.to(q.dtype)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if heads is not None and N <= 256 and G % heads == 0:
        folded = hd + grid_h + grid_w <= 128
        bhw = _bias_halves(q, rh_g, rw_g, grid_h, grid_w,
                           out_scale=1.0 / hd ** -0.5 if folded else 1.0)
        return relpos_attention_windowed(q, k, v, bhw, grid_h, grid_w, heads,
                                         folded, n_w, valid_rows)
    bhw = _bias_halves(q, rh_g, rw_g, grid_h, grid_w)
    return relpos_attention_global(q, k, v, bhw, grid_h, grid_w)


def attention_reference(q, k, v, rh, rw, grid_h: int, grid_w: int):
    """Dense float32 oracle (JAX :480); rh / rw in gathered (g, g, hd) form."""
    BH, N, hd = q.shape
    qf = q.float()
    s = qf @ k.float().transpose(1, 2) * hd ** -0.5
    qr = qf.reshape(BH, grid_h, grid_w, hd)
    bh = torch.einsum("bhwc,hkc->bhwk", qr, rh.float())
    bw = torch.einsum("bhwc,wkc->bhwk", qr, rw.float())
    bias = (bh[..., :, None] + bw[..., None, :]).reshape(BH, N, N)
    p = torch.softmax(s + bias, dim=-1)
    return (p @ v.float()).to(q.dtype)
