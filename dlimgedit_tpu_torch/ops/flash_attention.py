"""Attention kernels of the encoders — K2, K4, K5, K6 and K7.

Counterpart of dlimgedit_tpu/ops/flash_attention.py:

  * ``levit_window_attention`` (K2; JAX :531): TinyViT's window attention
    with a static per-head bias, on the tensor cores in bf16 and float16
    (``csrc/levit_attention_tc.cuh``; ``levit_attention_tc.cu``,
    ``levit_attention_tc_f16.cu``) and in float32, every product in three
    TF32 passes (``csrc/levit_attention_f32tc.cu``);
  * ``flash_attention_relpos`` (JAX :443): the SAM ViT's attention with the
    decomposed relative-position bias, routed as in JAX to
    ``relpos_attention_windowed`` (K5; JAX ``_attention_head_fused``, :307)
    for windows (N <= 256 with ``heads`` given) and to
    ``relpos_attention_global`` (K4; JAX ``_attention_grouped``, :139)
    otherwise, and a bf16 or float16 window wider than the tensor-core K5
    takes to K4 (``relpos_route``);
  * ``windowed_attention_qkv`` (JAX :382): windows whose q, k, v are the
    components of one (W, 3, nh, N, hd) tensor, through
    ``relpos_attention_qkv`` (K7, a third entry point beside K4 and K5;
    JAX body ``_head_loop_kernel_qkv``, :285);
  * ``windowed_attention_fused`` (K6; JAX :646, body
    ``_window_strip_kernel`` :575): the windowed blocks of the ViT's
    ``fused_window_blocks`` path, windows read in place from the padded
    NHWC q, k, v, bias halves computed in the kernel.

Every geometry the JAX functions take runs a hand-written kernel on the
card: K2 at any kd and N, K4-K7 at any head width, K6 on any window, any
group count. Two kinds of body serve them, and ``attention_body`` says
which a call runs (the C entry points apply the same rule, ``csrc/
attention_general.cuh`` ``attention_tuned``):

  * the tuned instances, which every main path's shape takes: K2 at kd
    ``TUNED_KD`` and N <= ``TUNED_MAX_TOKENS``; K4-K7 at the head widths of
    ``TUNED_HEAD_DIMS`` (64 and 80, the ViTs', have instances of their own,
    the others run an instance at a padded width of 32, 96 or 128), bf16
    and float16 K5 / K7 windows with sides up to ``TUNED_WINDOW_SIDE`` and
    K6 windows of up to ``TUNED_STRIP_TOKENS`` tokens. In bf16 and float16
    K4, K5, K7 and K6 run on the tensor cores (``csrc/
    relpos_attention_tc.cuh``, one body for both 16-bit types, as JAX
    rounds float16 where it rounds bf16; K5, K7 and K6 share one
    ``mma.sync`` body), and so does K2 (``csrc/levit_attention_tc.cuh``).
    In float32 they run on the tensor cores with every product in three
    TF32 passes (``csrc/relpos_attention_f32tc.cuh``, one body). A tuned
    launch of more than 65535 groups is split into several by the C entry
    point;
  * the general body (``csrc/attention_general.cuh``; bf16 in
    ``attention_general.cu``, float16 in ``attention_general_f16.cu``,
    float32 in ``attention_general_f32.cu``): a run-time head width, keys
    in chunks of 64 or 32 copied asynchronously, any group count; a launch
    counts in its wrapper's ``launches`` and ``general_launches``.

The C entry points are ``csrc/relpos_attention.cu`` (K4, K5, K7),
``csrc/levit_attention.cu`` (K2) and ``csrc/window_strip_attention.cu``
(K6). Each wrapper passes every operand through ``kernel_operand`` (dense
and on 16 bytes; a copy only for a view that is not), except K6's q, k and
v, which it reads in place where their layout allows; the general body
then loads rows in the widest pieces their head width and strides allow.

The other kernels of the port are K1 and K3 (``ops/fused_norm.py``,
``csrc/fused_layer_norm.cu``) and K8, the shared-memory gather probe
(``tools/probe_smem_gather.py``, ``csrc/gather_probe.cu``).

On a CUDA tensor each wrapper launches its hand-written kernel; on a CPU
tensor it computes the plain PyTorch version (``levit_window_attention_plain``,
``attention_relpos_plain``, ``windowed_attention_qkv_plain``,
``windowed_attention_fused_plain``), which repeats the JAX kernels'
rounding. For K4, K5 and K7 the bias halves [q.rh | q.rw] are plain tensor
work outside the kernels, as in JAX (``_bias_halves``); K6 computes them.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..errors import DlimgError
from .cuda_build import (DTYPE_CODES, KERNEL_DTYPES, LIBRARY, check_launch,
                         kernel_operand)

# The tuned K2 instances' head width and largest window
# (csrc/levit_attention_tc.cuh, levit_attention_f32tc.cu); other kd and N
# run the general body.
TUNED_KD = 32
TUNED_MAX_TOKENS = 256
# Head widths the tuned K4, K5, K6 and K7 take: every multiple of 8 from 8
# to 128. SAM ViT-B/L (64) and ViT-H (80) have instances of their own; the
# others run an instance at a padded width of 32, 96 or 128
# (csrc/relpos_attention.cuh ``padded_head_width``).
TUNED_HEAD_DIMS = tuple(range(8, 129, 8))
# The largest window side the tuned bf16 and float16 K5 and K7 take
# (csrc/relpos_attention_tc.cuh kBiasSide: 16 bias columns a half, score rows
# of up to 256 keys); the routers send wider 16-bit windows to K4, the
# low-level wrappers to the general body.
TUNED_WINDOW_SIDE = 16
# The largest window the tuned K6 takes (the bf16 and float16 instances of
# csrc/relpos_attention_tc.cuh hold score rows of 208 keys): SAM's 14 x 14
# windows.
TUNED_STRIP_TOKENS = 208
# The groups a tuned K4 / K5 / K7 launch takes (gridDim.y); K7's launches
# are split by whole windows, so its heads must not exceed it.
TUNED_MAX_GROUPS = 65535
# The wrappers in the order of the C rule's kernel codes
# (csrc/attention_general.cuh ``AttentionKernel``).
ATTENTION_KERNELS = ("levit_window_attention", "relpos_attention_global",
                     "relpos_attention_windowed", "relpos_attention_qkv",
                     "windowed_attention_fused")


def attention_body(kernel: str, dtype: torch.dtype, hd: int, n: int = 0,
                   grid_h: int = 0, grid_w: int = 0, heads: int = 0) -> str:
    """"tuned" or "general": the CUDA body that ``kernel`` (a name of
    ``ATTENTION_KERNELS``) runs at this dtype and geometry. n: tokens of a
    group (K2); grid_h, grid_w: K4-K7's grid, K6's window (ws, ws); heads:
    K7's. The C entry points apply the same rule
    (``csrc/attention_general.cuh`` ``attention_tuned``); every main path's
    shape is tuned."""
    if kernel == "levit_window_attention":
        tuned = hd == TUNED_KD and 0 < n <= TUNED_MAX_TOKENS
    else:
        tuned = hd in TUNED_HEAD_DIMS
        if kernel in ("relpos_attention_windowed", "relpos_attention_qkv"):
            tuned = tuned and _window_fits(dtype, grid_h, grid_w)
        if kernel == "relpos_attention_qkv":
            tuned = tuned and heads <= TUNED_MAX_GROUPS
        if kernel == "windowed_attention_fused":
            tuned = tuned and grid_h * grid_w <= TUNED_STRIP_TOKENS
    return "tuned" if tuned else "general"


def _count(fn, body: str) -> None:
    """Count one launch of ``fn``'s kernel, and in ``general_launches`` too
    when ``body`` is "general"."""
    fn.launches += 1
    if body == "general":
        fn.general_launches += 1


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
                         f"{KERNEL_DTYPES} qkv and bias of one dtype, got "
                         f"{qkv.dtype} and {bias.dtype}")
    return kd


def levit_window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """Biased window attention for TinyViT (LeViT construction).

    qkv: (G, N, nh * 3 * kd), the qkv linear's output per window;
    bias: (nh, N, N), the gathered attention-bias table. Returns
    (G, N, nh * kd). CUDA tensors go through the K2 kernel, tuned at kd 32
    and N <= 256, else the general body (``attention_body``; one launch
    counted in ``levit_window_attention.launches``, and a general one in
    ``.general_launches`` too)."""
    kd = _check(qkv, bias, num_heads)
    if qkv.device.type == "cpu":
        return levit_window_attention_plain(qkv, bias, num_heads)
    if not qkv.is_cuda:
        raise DlimgError(f"levit_window_attention: unsupported device "
                         f"{qkv.device}")
    qkv, bias = kernel_operand(qkv), kernel_operand(bias)
    G, N, _ = qkv.shape
    out = torch.empty((G, N, num_heads * kd), dtype=qkv.dtype,
                      device=qkv.device)
    lib = LIBRARY.get()
    rc = lib.dlimg_levit_attention(
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), G, N, num_heads, kd,
        DTYPE_CODES[str(qkv.dtype)], float(kd ** -0.5),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    check_launch("levit_window_attention", rc, f"{G} windows of {N} tokens, "
                 f"{num_heads} heads of kd {kd}, {qkv.dtype}")
    _count(levit_window_attention,
           attention_body("levit_window_attention", qkv.dtype, kd, n=N))
    return out


levit_window_attention.launches = 0
levit_window_attention.general_launches = 0


# ---------------------------------------------------------------------------
# Rel-pos attention of the SAM ViT encoders (K4, K5)
# ---------------------------------------------------------------------------

def rel_pos_index(size: int, device=None) -> torch.Tensor:
    """The (size, size) int64 gather index of a raw (2*size-1, hd) rel-pos
    table, idx[i, j] = i - j + size - 1, made on ``device`` (JAX makes it a
    constant of the jitted program; made here, it needs no host copy)."""
    r = torch.arange(size, device=device)
    return r[:, None] - r[None, :] + (size - 1)


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def cached_rel_pos_index(size: int, device: torch.device) -> torch.Tensor:
    """``rel_pos_index`` made once per (size, device); by a graphed
    executable's eager warm-up, never inside its capture (a tensor first
    made there would live in the graph's memory pool and hold nothing
    until a replay)."""
    return rel_pos_index(size, device)


def _gathered_tables(rh: torch.Tensor, rw: torch.Tensor, grid_h: int,
                     grid_w: int, dtype: torch.dtype):
    """Raw (2*g-1, hd) tables -> gathered (g, g, hd) with
    rh_g[yi, yj] = rh[yi - yj + gh - 1]; likewise rw along x."""
    rh_g = rh[cached_rel_pos_index(grid_h, rh.device)]
    rw_g = rw[cached_rel_pos_index(grid_w, rw.device)]
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
        raise DlimgError(f"{name}: the CUDA kernel takes {KERNEL_DTYPES} "
                         f"inputs of one dtype")


def relpos_attention_global(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bhw: torch.Tensor, grid_h: int,
                            grid_w: int) -> torch.Tensor:
    """Rel-pos attention over G groups of N = grid_h * grid_w tokens (the
    ViT's global blocks). CUDA tensors go through K4, tuned or general
    (``attention_body``; one launch counted in
    ``relpos_attention_global.launches``, a general one also in
    ``.general_launches``); CPU tensors through ``attention_relpos_plain``."""
    name = "relpos_attention_global"
    _check_relpos(name, q, k, v, bhw, grid_h, grid_w)
    if q.device.type == "cpu":
        return attention_relpos_plain(q, k, v, bhw, grid_h, grid_w)
    if not q.is_cuda:
        raise DlimgError(f"{name}: unsupported device {q.device}")
    q, k, v, bhw = (kernel_operand(t) for t in (q, k, v, bhw))
    G, N, hd = q.shape
    out = torch.empty_like(q)
    rc = LIBRARY.get().dlimg_relpos_attention_global(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bhw.data_ptr(),
        out.data_ptr(), G, N, hd, grid_h, grid_w, DTYPE_CODES[str(q.dtype)],
        float(hd ** -0.5), torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(name, rc, f"{G} groups of a {grid_h} x {grid_w} grid, "
                 f"head width {hd}, {q.dtype}")
    _count(relpos_attention_global,
           attention_body(name, q.dtype, hd, N, grid_h, grid_w))
    return out


relpos_attention_global.launches = 0
relpos_attention_global.general_launches = 0


def relpos_attention_windowed(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bhw: torch.Tensor, grid_h: int,
                              grid_w: int, heads: int, folded: bool,
                              n_w: Optional[int] = None,
                              valid_rows: Optional[int] = None
                              ) -> torch.Tensor:
    """Rel-pos attention over windows: G = windows * heads groups, head
    fastest, with the folded bias when ``folded`` and the pad-query skip of
    the last ``n_w`` windows (only their first ``valid_rows`` window rows
    are computed; the rest are zero). CUDA tensors go through K5, tuned or
    general (``attention_body``: a bf16 or float16 window with a side above
    TUNED_WINDOW_SIDE runs the general body here; one launch counted in
    ``relpos_attention_windowed.launches``, a general one also in
    ``.general_launches``); CPU tensors through ``attention_relpos_plain``."""
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
    q, k, v, bhw = (kernel_operand(t) for t in (q, k, v, bhw))
    G, N, hd = q.shape
    g_skip, n_valid = _skip_rows(G, N, grid_h, grid_w, heads, n_w, valid_rows)
    out = torch.empty_like(q)
    rc = LIBRARY.get().dlimg_relpos_attention_windowed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bhw.data_ptr(),
        out.data_ptr(), G, N, hd, grid_h, grid_w, int(folded), g_skip,
        n_valid, DTYPE_CODES[str(q.dtype)], float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(name, rc, f"{G} groups of a {grid_h} x {grid_w} window, "
                 f"head width {hd}, {q.dtype}")
    _count(relpos_attention_windowed,
           attention_body(name, q.dtype, hd, N, grid_h, grid_w))
    return out


relpos_attention_windowed.launches = 0
relpos_attention_windowed.general_launches = 0


def _jax_window(G: int, N: int, heads: Optional[int]) -> bool:
    """JAX's condition for its windowed kernel (flash_attention.py:464)."""
    return heads is not None and N <= 256 and G % heads == 0


def _window_fits(dtype: torch.dtype, grid_h: int, grid_w: int) -> bool:
    """Whether the tuned K5 / K7 take a window of this grid: the bf16 and
    float16 body takes sides of at most TUNED_WINDOW_SIDE, float32 any."""
    return dtype == torch.float32 or max(grid_h, grid_w) <= TUNED_WINDOW_SIDE


def relpos_route(dtype: torch.dtype, G: int, grid_h: int, grid_w: int,
                 heads: Optional[int]) -> str:
    """The kernel ``flash_attention_relpos`` runs on G groups of a
    grid_h x grid_w grid: "windowed" (K5) where JAX routes to its windowed
    kernel and the window fits the tuned K5, else "global" (K4; its general
    bias path for a bf16 or float16 window with a side above
    TUNED_WINDOW_SIDE)."""
    if (_jax_window(G, grid_h * grid_w, heads)
            and _window_fits(dtype, grid_h, grid_w)):
        return "windowed"
    return "global"


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
    K4. The routing is JAX's (flash_attention.py:464), except that a bf16
    or float16 window with a side above TUNED_WINDOW_SIDE goes to K4
    (``relpos_route``): there the bias is unfolded (at hd 64 the scale 1/8
    is a power of two, so both forms round alike) and the skipped
    pad-query rows are zeroed afterwards, as JAX's windowed kernel leaves
    them."""
    G, N, hd = q.shape
    if rh.dim() == 2:
        rh_g, rw_g = _gathered_tables(rh, rw, grid_h, grid_w, q.dtype)
    else:
        rh_g, rw_g = rh.to(q.dtype), rw.to(q.dtype)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if relpos_route(q.dtype, G, grid_h, grid_w, heads) == "windowed":
        folded = hd + grid_h + grid_w <= 128
        bhw = _bias_halves(q, rh_g, rw_g, grid_h, grid_w,
                           out_scale=1.0 / hd ** -0.5 if folded else 1.0)
        return relpos_attention_windowed(q, k, v, bhw, grid_h, grid_w, heads,
                                         folded, n_w, valid_rows)
    bhw = _bias_halves(q, rh_g, rw_g, grid_h, grid_w)
    out = relpos_attention_global(q, k, v, bhw, grid_h, grid_w)
    if _jax_window(G, N, heads):
        g_skip, n_valid = _skip_rows(G, N, grid_h, grid_w, heads, n_w,
                                     valid_rows)
        out[g_skip:, n_valid:] = 0
    return out


# ---------------------------------------------------------------------------
# Windows of a combined qkv tensor (K7)
# ---------------------------------------------------------------------------

def windowed_attention_qkv_plain(qkv: torch.Tensor, bhw: torch.Tensor,
                                 grid_h: int, grid_w: int) -> torch.Tensor:
    """The plain version of K7: ``attention_relpos_plain`` (unfolded bias,
    no skipped rows) on the q, k, v components. Returns (W, nh, N, hd)."""
    W, _, nh, N, hd = qkv.shape
    q, k, v = (qkv[:, c].reshape(W * nh, N, hd) for c in range(3))
    return attention_relpos_plain(q, k, v, bhw, grid_h, grid_w).reshape(
        W, nh, N, hd)


def relpos_attention_qkv(qkv: torch.Tensor, bhw: torch.Tensor, grid_h: int,
                         grid_w: int) -> torch.Tensor:
    """Rel-pos attention over windows whose q, k, v are the components of
    one (W, 3, nh, N, hd) tensor, read in place; bhw: (W * nh, N, gh + gw)
    unfolded bias halves. Returns (W, nh, N, hd). CUDA tensors go through
    K7, tuned or general (``attention_body``; one launch counted in
    ``relpos_attention_qkv.launches``, a general one also in
    ``.general_launches``); CPU tensors through
    ``windowed_attention_qkv_plain``."""
    name = "relpos_attention_qkv"
    if qkv.dim() != 5 or qkv.shape[1] != 3:
        raise DlimgError(f"{name}: qkv must be (W, 3, nh, N, hd), got "
                         f"{tuple(qkv.shape)}")
    W, _, nh, N, hd = qkv.shape
    if N != grid_h * grid_w:
        raise DlimgError(f"{name}: N = {N} is not grid_h * grid_w = "
                         f"{grid_h} * {grid_w}")
    if tuple(bhw.shape) != (W * nh, N, grid_h + grid_w):
        raise DlimgError(f"{name}: bias halves {tuple(bhw.shape)} must be "
                         f"({W * nh}, {N}, {grid_h + grid_w})")
    if bhw.device != qkv.device:
        raise DlimgError(f"{name}: all inputs must share a device")
    if qkv.device.type == "cpu":
        return windowed_attention_qkv_plain(qkv, bhw, grid_h, grid_w)
    if not qkv.is_cuda:
        raise DlimgError(f"{name}: unsupported device {qkv.device}")
    if str(qkv.dtype) not in DTYPE_CODES or bhw.dtype != qkv.dtype:
        raise DlimgError(f"{name}: the CUDA kernel takes {KERNEL_DTYPES} "
                         f"inputs of one dtype")
    qkv, bhw = kernel_operand(qkv), kernel_operand(bhw)
    out = torch.empty((W, nh, N, hd), dtype=qkv.dtype, device=qkv.device)
    rc = LIBRARY.get().dlimg_relpos_attention_qkv(
        qkv.data_ptr(), bhw.data_ptr(), out.data_ptr(), W, nh, N, hd, grid_h,
        grid_w, DTYPE_CODES[str(qkv.dtype)], float(hd ** -0.5),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    check_launch(name, rc, f"{W} windows of {nh} heads of a {grid_h} x "
                 f"{grid_w} window, head width {hd}, {qkv.dtype}")
    _count(relpos_attention_qkv,
           attention_body(name, qkv.dtype, hd, N, grid_h, grid_w, nh))
    return out


relpos_attention_qkv.launches = 0
relpos_attention_qkv.general_launches = 0


def windowed_attention_qkv(qkv: torch.Tensor, rh: torch.Tensor,
                           rw: torch.Tensor, *, grid_h: int,
                           grid_w: int) -> torch.Tensor:
    """Head-fused windowed attention over a combined qkv tensor (JAX :382,
    which no path of either package calls; its docstring records why).

    qkv: (W, 3, nh, N, hd) window-major; rh / rw raw (2*g-1, hd) or
    gathered (g, g, hd) tables. Returns (W, nh, N, hd). The bias halves
    come from the q component, unscaled, outside the kernel (JAX :413-417);
    the attention is ``relpos_attention_qkv`` (K7), or for a bf16 or
    float16 window with a side above TUNED_WINDOW_SIDE K4's general bias path
    on the copied q, k, v components (the same function)."""
    W, _, nh, N, hd = qkv.shape
    if rh.dim() == 2:
        rh_g, rw_g = _gathered_tables(rh, rw, grid_h, grid_w, qkv.dtype)
    else:
        rh_g, rw_g = rh.to(qkv.dtype), rw.to(qkv.dtype)
    bhw = _bias_halves(qkv[:, 0].reshape(W * nh, N, hd), rh_g, rw_g, grid_h,
                       grid_w)
    if not _window_fits(qkv.dtype, grid_h, grid_w):
        q, k, v = (qkv[:, c].reshape(W * nh, N, hd) for c in range(3))
        return relpos_attention_global(q, k, v, bhw, grid_h, grid_w).reshape(
            W, nh, N, hd)
    return relpos_attention_qkv(qkv, bhw, grid_h, grid_w)


# ---------------------------------------------------------------------------
# Windows read in place from padded NHWC tensors (K6)
# ---------------------------------------------------------------------------

def _to_windows(t: torch.Tensor, ws: int, num_heads: int) -> torch.Tensor:
    """(B, Hp, Wp, C) -> (B * nWy * nWx, nh, ws * ws, hd)."""
    B, Hp, Wp, C = t.shape
    hd = C // num_heads
    t = t.reshape(B, Hp // ws, ws, Wp // ws, ws, num_heads, hd)
    return t.permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, num_heads, ws * ws, hd)


def _from_windows(t: torch.Tensor, B: int, Hp: int, Wp: int, ws: int
                  ) -> torch.Tensor:
    """The inverse of ``_to_windows``."""
    _, nh, _, hd = t.shape
    t = t.reshape(B, Hp // ws, Wp // ws, nh, ws, ws, hd)
    return t.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, Hp, Wp, nh * hd)


def _round_exact(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float64 ``x`` correctly rounded to ``dtype`` (to nearest, ties to
    even): for a 16-bit dtype through float32 rounded to odd (toward zero,
    the last bit set when inexact), whose rounding to 16 bits is then the
    correct rounding of ``x``."""
    f = x.float()
    if dtype == torch.float32:
        return f
    over = f.double().abs() > x.abs()
    f = torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)
    bits = f.view(torch.int32)
    bits = torch.where(f.double() != x, bits | 1, bits)
    return bits.view(torch.float32).to(dtype)


def windowed_attention_fused_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, rh: torch.Tensor,
                                   rw: torch.Tensor, *, ws: int,
                                   num_heads: int) -> torch.Tensor:
    """The plain version of K6, with the JAX strip kernel's rounding:
    bh[i, y] = sum_d q[i, d] rh[i // ws, y, d] and bw[i, x] (rw[i % ws])
    from the dtype's q and tables, each rounded to the dtype (in 16 bits the
    sum is taken in float64, exact for these products, and correctly
    rounded: a float32 sum, JAX's, rounds to the other side of a midpoint
    now and then, and its order is each implementation's own; in float32 a
    float32 sum); s = ((q.k) * scale + bh[i, y_j]) + bw[i, x_j] in float32;
    exact softmax, p rounded to the dtype before p.v, which accumulates in
    float32. Every token of the padded grid gets its output."""
    B, Hp, Wp, C = q.shape
    dtype = q.dtype
    hd = C // num_heads
    n = ws * ws
    qw, kw, vw = (_to_windows(t, ws, num_heads).float() for t in (q, k, v))
    tok = torch.arange(n, device=q.device)
    yi, xi = tok // ws, tok % ws
    rh_e = rh.to(dtype).float()[yi]   # (n, ws, hd): rh[y_i]
    rw_e = rw.to(dtype).float()[xi]   # (n, ws, hd): rw[x_i]
    wide = torch.float32 if dtype == torch.float32 else torch.float64
    qs = qw.to(wide)
    bh = _round_exact(torch.einsum("gnid,iyd->gniy", qs, rh_e.to(wide)).double(),
                      dtype).float()
    bw = _round_exact(torch.einsum("gnid,ixd->gnix", qs, rw_e.to(wide)).double(),
                      dtype).float()
    s = (qw @ kw.transpose(-1, -2)) * (hd ** -0.5)
    s = s + bh[..., yi]
    s = s + bw[..., xi]
    p = torch.softmax(s, dim=-1).to(dtype)
    out = (p.float() @ vw).to(dtype)
    return _from_windows(out, B, Hp, Wp, ws)


def _check_strip(name: str, q, k, v, rh, rw, ws: int, num_heads: int) -> int:
    """Check the shapes of K6's operands and return the head width."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise DlimgError(f"{name}: q, k, v must be (B, Hp, Wp, C) of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hp, Wp, C = q.shape
    if ws <= 0 or Hp % ws or Wp % ws:
        raise DlimgError(f"{name}: the grid {Hp}x{Wp} is not a multiple of "
                         f"the window {ws}")
    if num_heads <= 0 or C % num_heads:
        raise DlimgError(f"{name}: C = {C} is not a multiple of num_heads = "
                         f"{num_heads}")
    hd = C // num_heads
    for t, label in ((rh, "rh"), (rw, "rw")):
        if tuple(t.shape) != (ws, ws, hd):
            raise DlimgError(f"{name}: {label} must be the gathered "
                             f"({ws}, {ws}, {hd}) table, got {tuple(t.shape)}")
    if any(t.device != q.device for t in (k, v, rh, rw)):
        raise DlimgError(f"{name}: all inputs must share a device")
    return hd


def _strip_token_stride(q, k, v) -> Optional[int]:
    """The token stride at which K6 reads q, k, v in place, or None: (B,
    Hp, Wp, C) views with one set of strides, unit channel stride and dense
    rows (contiguous, or the channel slices of one (B, Hp, Wp, 3C) qkv
    tensor, token stride 3C), each starting on 16 bytes, the token stride a
    multiple of 16 bytes (the kernels' 16-byte loads). The wrapper makes q,
    k and v dense for any other layout."""
    B, Hp, Wp, C = q.shape
    st = q.stride()
    ts = st[2]
    if (k.stride() != st or v.stride() != st or st[3] != 1 or ts < C
            or st[1] != Wp * ts or (B > 1 and st[0] != Hp * Wp * ts)):
        return None
    if any(t.data_ptr() % 16 for t in (q, k, v)) or ts * q.element_size() % 16:
        return None
    return ts


def windowed_attention_fused(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, rh: torch.Tensor,
                             rw: torch.Tensor, *, ws: int,
                             num_heads: int) -> torch.Tensor:
    """Windowed rel-pos attention on padded NHWC tensors (JAX :646; the
    ViT's ``fused_window_blocks`` path).

    q, k, v: (B, Hp, Wp, C) with Hp % ws == Wp % ws == 0 and C = nh * hd,
    typically the three channel slices of the qkv linear's output; rh, rw:
    gathered (ws, ws, hd) tables. Returns (B, Hp, Wp, C), contiguous. CUDA
    tensors go through K6, which reads q, k, v in place where their layout
    allows (``_strip_token_stride``; else the three are made dense, token
    stride C), tuned or general (``attention_body``: any window and head
    width), one launch counted in ``windowed_attention_fused.launches``, a
    general one also in ``.general_launches``; CPU tensors through
    ``windowed_attention_fused_plain``."""
    name = "windowed_attention_fused"
    hd = _check_strip(name, q, k, v, rh, rw, ws, num_heads)
    if q.device.type == "cpu":
        return windowed_attention_fused_plain(q, k, v, rh, rw, ws=ws,
                                              num_heads=num_heads)
    if not q.is_cuda:
        raise DlimgError(f"{name}: unsupported device {q.device}")
    if str(q.dtype) not in DTYPE_CODES or any(t.dtype != q.dtype
                                              for t in (k, v)):
        raise DlimgError(f"{name}: the CUDA kernel takes {KERNEL_DTYPES} "
                         f"q, k, v of one dtype")
    B, Hp, Wp, C = q.shape
    ts = _strip_token_stride(q, k, v)
    if ts is None:
        q, k, v = (kernel_operand(t) for t in (q, k, v))
        ts = C
    rh_t, rw_t = (kernel_operand(t.to(q.dtype)) for t in (rh, rw))
    out = torch.empty((B, Hp, Wp, C), dtype=q.dtype, device=q.device)
    rc = LIBRARY.get().dlimg_window_strip_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rh_t.data_ptr(),
        rw_t.data_ptr(), out.data_ptr(), B, Hp, Wp, C, ts, ws, num_heads, hd,
        DTYPE_CODES[str(q.dtype)], float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(name, rc, f"a ({B}, {Hp}, {Wp}, {C}) grid of {ws} x {ws} "
                 f"windows, head width {hd}, {q.dtype}")
    _count(windowed_attention_fused,
           attention_body(name, q.dtype, hd, ws * ws, ws, ws, num_heads))
    return out


windowed_attention_fused.launches = 0
windowed_attention_fused.general_launches = 0


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
