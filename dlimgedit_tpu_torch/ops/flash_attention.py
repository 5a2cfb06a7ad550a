"""LeViT-style window attention with a static per-head bias — kernel K2.

Counterpart of the TinyViT part of dlimgedit_tpu/ops/flash_attention.py
(``levit_window_attention``, :531). On a CUDA tensor the wrapper launches
the hand-written kernel in ``csrc/levit_attention.cu``; on a CPU tensor it
computes the plain PyTorch version, ``levit_window_attention_plain``, which
is also TinyViT's attention when the kernel is switched off.
"""

from __future__ import annotations

import torch

from ..errors import DlimgError
from .cuda_build import DTYPE_CODES, LIBRARY, check_launch

# The CUDA kernel's head width and largest window (csrc/levit_attention.cu).
KERNEL_HEAD_DIM = 32
KERNEL_MAX_TOKENS = 256


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
