"""int8 quantisation of the SAM encoders' linears (counterpart of
dlimgedit_tpu/ops/quant.py), weight-only ("w8") and s8 x s8 ("w8a8").

The 2-D projection weights of the attention and MLP blocks (the modules
whose last path segment is in ``QUANT_KEYS``) are stored as int8 with one
float32 scale per output channel, taken from the float32 weights before
the encoder is cast to its compute dtype. Norms, biases, tables and convs
stay in full precision. ``models.common.linear`` dispatches on what a
module holds: ``w_q`` is dequantised per call into the product
(``dequantize_weight``), ``w_q8`` runs ``int8_linear``: the activations
are quantised per token, multiplied s8 x s8 -> s32 (``torch._int_mm``,
cuBLASLt on the card) and the product is dequantised and biased.

On a CUDA tensor the two passes over the activations of ``int8_linear``
are the port's kernels P2 ``quantize_rows_int8`` and P3 ``int8_epilogue``
(``csrc/quantize_rows.cu``; port-only, since XLA fuses them on the TPU);
on a CPU tensor they are their plain versions, JAX's
``quantize_activations_int8`` and the epilogue of its ``int8_linear``,
which the kernels equal bit for bit. The s8 x s8 product itself stays a
library call, as JAX leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..errors import DlimgError
from .cuda_build import DTYPE_CODES, LIBRARY, check_launch

# Module names (exact last path segment) eligible for quantisation: the 2-D
# matmul weights of the attention and MLP blocks. Exact matching, so that a
# module merely containing "proj" in its name is never caught.
QUANT_KEYS = frozenset({"qkv", "proj", "fc1", "fc2", "lin1", "lin2"})

# Row widths P2 is instantiated for (csrc/quantize_rows.cu): TinyViT's
# token widths (128, 160, 320) and MLP widths (512, 640, 1280), the SAM
# ViT-B, -L and -H widths (768, 1024, 1280) and MLP widths (3072, 4096,
# 5120).
QUANT_ROW_WIDTHS = (128, 160, 320, 512, 640, 768, 1024, 1280, 3072, 4096, 5120)


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as one IEEE division per element. ``t / 127.0`` is not: on
    CUDA PyTorch multiplies by the scalar's reciprocal, which may differ by
    one ulp from the quotient that JAX and the kernels compute."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def quantize_weight(w: torch.Tensor):
    """w: (in, out) float -> (w_q int8 (in, out), scale float32 (out,)).
    The scales always come from a float32 view of the weights, whatever
    their dtype, so quantising after a bf16 cast cannot go unnoticed in
    the numbers only."""
    w = w.float()
    scale = torch.clamp(_div127(w.abs().amax(dim=0)), min=1e-12)
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_q, scale


def dequantize_weight(w_q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """Dequantise in float32 and round once to ``dtype``."""
    return (w_q.float() * scale.float()).to(dtype)


def quantize_activations_int8(x: torch.Tensor):
    """Dynamic per-token symmetric int8 quantisation, P2's plain version.
    x: (..., C) float -> (q int8 (..., C), scale float32 (..., 1))."""
    x32 = x.float()
    scale = _div127(torch.clamp(x32.abs().amax(dim=-1, keepdim=True), min=1e-8))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_epilogue_plain(acc: torch.Tensor, x_scale: torch.Tensor,
                        w_scale: torch.Tensor, b: Optional[torch.Tensor],
                        dtype: torch.dtype) -> torch.Tensor:
    """P3's plain version, the order of JAX's int8_linear: the float32
    product ``(acc * x_scale) * w_scale`` rounded to ``dtype``, then the
    bias added in ``dtype``."""
    y = (acc.float() * x_scale * w_scale.float()).to(dtype)
    if b is not None:
        y = y + b.to(dtype)
    return y


def _check_cuda(name: str, tensors, dtype: torch.dtype) -> None:
    if str(dtype) not in DTYPE_CODES:
        raise DlimgError(f"{name}: the CUDA kernel takes float32 or bfloat16, "
                         f"not {dtype}")
    if any(t.device != tensors[0].device for t in tensors):
        raise DlimgError(f"{name}: all inputs must share a device")
    if not all(t.is_contiguous() for t in tensors):
        raise DlimgError(f"{name}: inputs must be contiguous")


def quantize_rows_int8(x: torch.Tensor):
    """Per-token int8 quantisation of x (..., C) -> (q int8 (..., C),
    scale float32 (..., 1)), JAX's ``quantize_activations_int8``.

    On a CUDA tensor it launches P2 (counted in
    ``quantize_rows_int8.launches``; C in ``QUANT_ROW_WIDTHS``, x
    contiguous); on a CPU tensor it runs ``quantize_activations_int8``."""
    if x.device.type == "cpu":
        return quantize_activations_int8(x)
    if not x.is_cuda:
        raise DlimgError(f"quantize_rows_int8: unsupported device {x.device}")
    _check_cuda("quantize_rows_int8", (x,), x.dtype)
    C = x.shape[-1]
    if C not in QUANT_ROW_WIDTHS:
        raise DlimgError(f"quantize_rows_int8: no CUDA kernel for width {C} "
                         f"(have {QUANT_ROW_WIDTHS})")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    rc = LIBRARY.get().dlimg_quantize_rows_int8(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), x.numel() // C, C,
        DTYPE_CODES[str(x.dtype)],
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("quantize_rows_int8", rc)
    quantize_rows_int8.launches += 1
    return q, scale


quantize_rows_int8.launches = 0


def int8_epilogue(acc: torch.Tensor, x_scale: torch.Tensor,
                  w_scale: torch.Tensor, b: Optional[torch.Tensor],
                  dtype: torch.dtype) -> torch.Tensor:
    """acc (M, N) int32, x_scale (M, 1) and w_scale (N,) float32, b (N,)
    or None -> y (M, N) in ``dtype`` (see ``int8_epilogue_plain``).

    On a CUDA tensor it launches P3 (counted in ``int8_epilogue.launches``;
    N a multiple of 4, acc 16-byte aligned, b cast to ``dtype``); on a CPU
    tensor it runs ``int8_epilogue_plain``."""
    M, N = acc.shape
    if tuple(x_scale.shape) != (M, 1) or tuple(w_scale.shape) != (N,):
        raise DlimgError(f"int8_epilogue: x_scale {tuple(x_scale.shape)} must "
                         f"be ({M}, 1) and w_scale {tuple(w_scale.shape)} ({N},)")
    if b is not None and tuple(b.shape) != (N,):
        raise DlimgError(f"int8_epilogue: b {tuple(b.shape)} must be ({N},)")
    if acc.device.type == "cpu":
        return int8_epilogue_plain(acc, x_scale, w_scale, b, dtype)
    if not acc.is_cuda:
        raise DlimgError(f"int8_epilogue: unsupported device {acc.device}")
    if b is not None:
        b = b.to(dtype)
    tensors = (acc, x_scale, w_scale) + (() if b is None else (b,))
    _check_cuda("int8_epilogue", tensors, dtype)
    if (acc.dtype != torch.int32 or x_scale.dtype != torch.float32
            or w_scale.dtype != torch.float32):
        raise DlimgError("int8_epilogue: acc must be int32, x_scale and "
                         "w_scale float32")
    if N % 4 or acc.data_ptr() % 16:
        raise DlimgError(f"int8_epilogue: N ({N}) must be a multiple of 4 and "
                         f"acc 16-byte aligned")
    y = torch.empty((M, N), dtype=dtype, device=acc.device)
    rc = LIBRARY.get().dlimg_int8_epilogue(
        acc.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
        None if b is None else b.data_ptr(), y.data_ptr(), M, N,
        DTYPE_CODES[str(dtype)],
        torch.cuda.current_stream(acc.device).cuda_stream)
    check_launch("int8_epilogue", rc)
    int8_epilogue.launches += 1
    return y


int8_epilogue.launches = 0


# cuBLASLt's int8 product on the card takes only M > 16 rows.
INT8_MM_MIN_ROWS = 17


def pad_rows(q: torch.Tensor, rows: int = INT8_MM_MIN_ROWS) -> torch.Tensor:
    """``q`` (M, K) with zero rows appended up to ``rows`` (``q`` itself
    when it has that many). The rows of a product are independent, so
    ``(pad_rows(q) @ w)[:M]`` equals ``q @ w`` exactly."""
    M = q.shape[0]
    if M >= rows:
        return q
    return torch.cat([q, q.new_zeros((rows - M,) + tuple(q.shape[1:]))])


def int8_mm(q: torch.Tensor, w_q8: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact. On the card
    cuBLASLt's int8 product needs M > 16, so fewer rows are padded with
    zero rows and the result sliced back (``pad_rows``); K and N must be
    multiples of 8, and another shape raises here rather than falling
    back to a float product. It is fast only with ``w_q8`` column-major,
    as ``QuantLinear`` stores it."""
    M, K = q.shape
    N = w_q8.shape[1]
    if not q.is_cuda:
        return torch._int_mm(q, w_q8)
    if K % 8 or N % 8:
        raise DlimgError(f"int8_mm: the CUDA int8 product needs K and N "
                         f"multiples of 8, got ({M}, {K}) x ({K}, {N})")
    return torch._int_mm(pad_rows(q), w_q8)[:M]


def int8_linear(params: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """s8 x s8 -> s32 linear with dynamic per-token activation scales:
    y = (q_x @ w_q8) * x_scale * w_scale + b, in x's dtype. ``params``
    holds ``w_q8`` (int8 (in, out)), ``w_scale`` (float32 (out,)) and
    optionally ``b``. The output is contiguous (..., out)."""
    C = x.shape[-1]
    q, x_scale = quantize_rows_int8(x.reshape(-1, C).contiguous())
    acc = int8_mm(q, params.w_q8)
    y = int8_epilogue(acc, x_scale, params.w_scale, getattr(params, "b", None),
                      x.dtype)
    return y.reshape(x.shape[:-1] + (y.shape[-1],))


def quantize_encoder(encoder: nn.Module, act_int8: bool = False) -> nn.Module:
    """Swap, in place, every ``Linear`` of ``encoder`` whose last path
    segment is in ``QUANT_KEYS`` for a ``QuantLinear`` holding ``w_q``
    (weight-only int8) or, with ``act_int8``, ``w_q8`` (int8 weights and
    activations), and ``w_scale``. Call it before casting the encoder to
    its compute dtype. Modules already quantised are left alone. Returns
    ``encoder``."""
    from ..models.common import QuantLinear

    swaps = []
    for path, mod in encoder.named_modules():
        w = getattr(mod, "w", None)
        if (path and path.rsplit(".", 1)[-1] in QUANT_KEYS
                and isinstance(w, torch.Tensor) and w.ndim == 2):
            swaps.append((path, mod))
    for path, mod in swaps:
        w_q, scale = quantize_weight(mod.w.detach())
        b = getattr(mod, "b", None)
        encoder.set_submodule(path, QuantLinear(
            w_q, scale, None if b is None else b.detach(), act_int8))
    return encoder


def quant_mode(encoder: nn.Module) -> str:
    """"w8a8" if a linear of ``encoder`` holds ``w_q8``, else "w8" if one
    holds ``w_q``, else "none"."""
    names = {n.rsplit(".", 1)[-1] for n, _ in encoder.named_parameters()}
    return "w8a8" if "w_q8" in names else "w8" if "w_q" in names else "none"


def quantized_bytes(module: nn.Module) -> int:
    """Bytes of a module's parameters and persistent buffers (the leaves of
    the JAX tree)."""
    return sum(t.numel() * t.element_size()
               for t in module.state_dict().values())
