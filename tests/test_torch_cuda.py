"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: skipped where no CUDA device is present (the decision is
taken inside the tests, never at import). This file imports neither jax
nor the JAX package, so on a GPU machine without JAX it runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

chip_smoke.py runs the same comparisons at the main path's full shapes.
Tolerances as there: float32 atol 1e-5 (LayerNorm) / 2e-5 (attention),
bf16 atol 2e-2. K3's s must equal the plain x + d bit for bit, and K8
(the gather probe) its plain version: both sum in the same order.

K2's large-bias case (bias of scale 4, bf16) fails at 2e-2 if the bias is
added before the scale (max |diff| ~3) or the biased score is rounded to
bf16 (~0.045), both checked on the CPU against such variants of the plain
version.

The executable cache's CUDA graphs (the ``graph`` tests): at small
sizes, for every key kind (embed, decode with and without
largest_component, multimask decode, decode_batch), a replay must equal
the key's eager program on the same inputs bit for bit (the same kernels
run in the same order; with largest_component the labelling runs eagerly
between two graphs). Also: a `process` in the
same bucket leaves an earlier embedding and its masks alone, two threads
on one key each get their own answer, and a capture that fails raises
instead of running eagerly.

The greedy box NMS kernel (``greedy_nms``, csrc/greedy_nms.cu: an IoU
bitmask, then a one-warp scan, one call) must keep the plain row loop's
flags bit for bit, at M = 256, 2304, 9216 (grid 64's pool) and 14400, at
M = 1, 63, 64 and 65 (the edges of its 64-bit words) with boxes at IoU
exactly the threshold (kept: the test is >), exact duplicates and scores
at 0 and below, and a CUDA graph of it must read the threshold's current
value. K8 (``smem_gather``) holds its plain version also at row counts
that fill no whole row chunk, slabs cut short by the lanes and bf16
widths whose rows are not 16-byte multiples.

``compute_mask_batch`` (C5): JAX's contract at the main path's size,
full-width MobileSAM at 1024 in bf16 on a 1024x768 image: 16 seeded
points and boxes, every batch size 1-8 with each prompt at every
position, each mask byte-equal to `compute_mask` of its prompt, with
largest_region_object on and off (tools/probe_batch_masks.py; on a
failure the message gives the flipped pixels and the largest |logit|
under a flip).

The float32 precision repair (``tf32``): with cuDNN's TF32 flag on (its
default) and the caller's matmul TF32 flag on too, a float32 MobileSAM
`process` matches the CPU port (relative L2 1e-5), a float32 slim
BiRefNet `segment_objects` within 1 quantum, one conv of the port's
conv2d as an executable (warm-up, eager, replays) within relative L2
1e-5, and the caller's flags stay as they were.
BiRefNet's graphs (``birefnet``): three rounds over two buckets and an
escalated image, every replay bit-equal to its key's eager program.

The int8 kernels (``quant``): P2 ``quantize_rows_int8`` at every row
width it has (row counts that do not fill a block, a row of zeros) and P3
``int8_epilogue`` at the encoders' output widths, with and without a
bias, bit for bit against their plain versions in float32 and bf16; the
s8 x s8 ``int8_linear`` on the card bit for bit against the CPU's; a CUDA
tensor never reaches a plain version (both are patched to raise); an
int8 product cuBLASLt cannot take (16 rows) raises; and quantised
``process`` calls (w8 and w8a8, MobileSAM at 256 and a narrow ViT-B)
replay bit-equal to their eager programs, with P2 and P3 launched once
per quantised linear under w8a8 and never under w8.

K6's large-table case holds the rounding of its bias halves: q and the
tables are multiples of 1/4 (rh, rw of scale ~3), so every float32 sum of
their products is exact in any order and the halves (~24 in size, bf16
steps of 1/8) round the same on both sides; rounding bh + bw together, or
scaling before rounding, moves scores by up to half such a step and the
output by more than the tolerance.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import dlimgedit_tpu_torch as dl
from dlimgedit_tpu_torch.errors import DlimgError
from dlimgedit_tpu_torch.models import sam, vit_sam
from dlimgedit_tpu_torch.models.common import QuantLinear
from dlimgedit_tpu_torch.ops.amg import box_iou_matrix, greedy_nms, greedy_nms_plain
from dlimgedit_tpu_torch.ops.flash_attention import (
    _bias_halves,
    attention_relpos_plain,
    flash_attention_relpos,
    levit_window_attention,
    levit_window_attention_plain,
    relpos_attention_global,
    relpos_attention_qkv,
    relpos_attention_windowed,
    windowed_attention_fused,
    windowed_attention_fused_plain,
    windowed_attention_qkv,
    windowed_attention_qkv_plain,
)
from dlimgedit_tpu_torch.ops.fused_norm import (
    fused_add_layer_norm,
    fused_add_layer_norm_plain,
    fused_layer_norm,
    layer_norm_plain,
)
from dlimgedit_tpu_torch.ops import quant
from dlimgedit_tpu_torch.tools import probe_batch_masks
from dlimgedit_tpu_torch.tools.probe_smem_gather import (
    probe_inputs,
    smem_gather,
    smem_gather_plain,
)
from dlimgedit_tpu_torch.runtime.environment import COUNTED_KERNELS, SamModelBundle

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (2e-2, 2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,eps", [((3 * 49, 128), 1e-5), ((2, 7, 160), 1e-5),
                                       ((33, 320), 1e-5), ((1, 4, 4, 256), 1e-6),
                                       ((1, 9, 7, 768), 1e-6), ((37, 1024), 1e-6),
                                       ((65, 1280), 1e-6)])
def test_fused_layer_norm_kernel_matches_plain(dev, shape, eps, dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    C = shape[-1]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    scale = (0.25 + 0.5 * torch.rand(C, generator=g, device=dev)).to(dtype)
    bias = (0.5 * torch.rand(C, generator=g, device=dev) - 0.25).to(dtype)
    before = fused_layer_norm.launches
    got = fused_layer_norm(x, scale, bias, eps)
    torch.cuda.synchronize()
    assert fused_layer_norm.launches == before + 1
    want = layer_norm_plain(x, scale, bias, eps)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype][0],
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,N,nh", [(3, 49, 4), (2, 196, 5), (5, 17, 2), (1, 256, 1)])
def test_levit_attention_kernel_matches_plain(dev, G, N, nh, dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn((G, N, nh * 96), generator=g, device=dev).to(dtype)
    bias = (0.5 * torch.randn((nh, N, N), generator=g, device=dev)).to(dtype)
    before = levit_window_attention.launches
    got = levit_window_attention(qkv, bias, nh)
    torch.cuda.synchronize()
    assert levit_window_attention.launches == before + 1
    want = levit_window_attention_plain(qkv, bias, nh)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype][1],
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1, 17, 48, 49, 64, 65, 196, 208, 256])
def test_levit_attention_kernel_every_window_size(dev, N, dtype):
    """bf16 K2 on the tensor cores (instances of 64, 208 and 256 keys; N
    above 64 splits a (window, head) group's 16-row stripes over blocks of
    4) and float32 K2 on the CUDA cores; qkv a view that starts 16 bytes
    into its storage and, for bf16, one that does not start on 16 bytes."""
    g = torch.Generator(device=dev).manual_seed(10)
    G, nh = 3, 2
    base = torch.randn((G * N * nh * 96 + 8,), generator=g, device=dev).to(dtype)
    bias = (0.5 * torch.randn((nh, N, N), generator=g, device=dev)).to(dtype)
    views = [base[16 // base.element_size():][:G * N * nh * 96]]
    if dtype == torch.bfloat16:
        views.append(base[1:][:G * N * nh * 96])
    for flat in views:
        qkv = flat.view(G, N, nh * 96)
        before = levit_window_attention.launches
        got = levit_window_attention(qkv, bias, nh)
        torch.cuda.synchronize()
        assert levit_window_attention.launches == before + 1
        want = levit_window_attention_plain(qkv, bias, nh)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype][1], rtol=0)


@pytest.mark.parametrize("N", [49, 196])
def test_levit_attention_kernel_large_bias(dev, N):
    """bf16, bias of scale 4: the bias must be added after the scale and
    the score kept in float32 (see the module note)."""
    g = torch.Generator(device=dev).manual_seed(11)
    G, nh = 8, 2
    qkv = torch.randn((G, N, nh * 96), generator=g, device=dev).to(torch.bfloat16)
    bias = (4.0 * torch.randn((nh, N, N), generator=g, device=dev)).to(torch.bfloat16)
    got = levit_window_attention(qkv, bias, nh)
    torch.cuda.synchronize()
    want = levit_window_attention_plain(qkv, bias, nh)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[torch.bfloat16][1], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 9, 7, 768), (37, 1024), (65, 1280)])
def test_fused_add_layer_norm_kernel_matches_plain(dev, shape, dtype):
    g = torch.Generator(device=dev).manual_seed(2)
    C = shape[-1]
    x, d = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(2))
    scale = (0.25 + 0.5 * torch.rand(C, generator=g, device=dev)).to(dtype)
    bias = (0.5 * torch.rand(C, generator=g, device=dev) - 0.25).to(dtype)
    before = fused_add_layer_norm.launches
    s, y = fused_add_layer_norm(x, d, scale, bias, 1e-6)
    torch.cuda.synchronize()
    assert fused_add_layer_norm.launches == before + 1
    want_s, want_y = fused_add_layer_norm_plain(x, d, scale, bias, 1e-6)
    torch.testing.assert_close(s, want_s, atol=0, rtol=0)
    torch.testing.assert_close(y.float(), want_y.float(), atol=TOL[dtype][0],
                               rtol=0)


def _relpos_inputs(dev, G, gh, gw, hd, dtype, out_scale, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    N = gh * gw
    q, k, v = (torch.randn((G, N, hd), generator=g, device=dev).to(dtype)
               for _ in range(3))
    rh = 0.3 * torch.randn((gh, gh, hd), generator=g, device=dev)
    rw = 0.3 * torch.randn((gw, gw, hd), generator=g, device=dev)
    return q, k, v, _bias_halves(q, rh, rw, gh, gw, out_scale=out_scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,gh,gw,hd", [(2, 20, 20, 64), (3, 32, 32, 80),
                                        (1, 7, 9, 64), (2, 64, 64, 64),
                                        (1, 24, 40, 80),   # gw vs the 64-key tile
                                        (2, 32, 32, 64)])  # ViT-B at 512
def test_relpos_global_kernel_matches_plain(dev, G, gh, gw, hd, dtype):
    q, k, v, bhw = _relpos_inputs(dev, G, gh, gw, hd, dtype, 1.0, 3)
    before = relpos_attention_global.launches
    got = relpos_attention_global(q, k, v, bhw, gh, gw)
    torch.cuda.synchronize()
    assert relpos_attention_global.launches == before + 1
    want = attention_relpos_plain(q, k, v, bhw, gh, gw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype][1],
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W,heads,hd,folded,n_w,valid_rows", [
    (25, 12, 64, True, 5, 8),     # ViT-B at 1024
    (25, 16, 80, True, 5, 8),     # ViT-H at 1024
    (9, 2, 64, False, 3, 4),      # the unfolded bias
    (4, 3, 80, True, None, None),
    (6, 2, 80, False, 2, 3),      # 42 kept rows straddle a 16-row stripe
])
def test_relpos_windowed_kernel_matches_plain(dev, W, heads, hd, folded, n_w,
                                              valid_rows, dtype):
    q, k, v, bhw = _relpos_inputs(dev, W * heads, 14, 14, hd, dtype,
                                  (1.0 / hd ** -0.5) if folded else 1.0, 4)
    before = relpos_attention_windowed.launches
    got = relpos_attention_windowed(q, k, v, bhw, 14, 14, heads, folded, n_w,
                                    valid_rows)
    torch.cuda.synchronize()
    assert relpos_attention_windowed.launches == before + 1
    want = attention_relpos_plain(q, k, v, bhw, 14, 14, folded=folded,
                                  heads=heads, n_w=n_w, valid_rows=valid_rows)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype][1],
                               rtol=0)
    if n_w:
        assert not got[-n_w * heads:, valid_rows * 14:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ws,hd", [(15, 64), (16, 80)])
def test_relpos_windowed_kernel_wide_windows(dev, ws, hd, dtype):
    """Windows of more than 208 tokens (the bf16 kernel's 256-key rows)."""
    q, k, v, bhw = _relpos_inputs(dev, 6, ws, ws, hd, dtype,
                                  1.0 / hd ** -0.5, 7)
    got = relpos_attention_windowed(q, k, v, bhw, ws, ws, 2, True, 1, 5)
    torch.cuda.synchronize()
    want = attention_relpos_plain(q, k, v, bhw, ws, ws, folded=True, heads=2,
                                  n_w=1, valid_rows=5)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype][1],
                               rtol=0)
    assert not got[-2:, 5 * ws:].any()


@pytest.mark.parametrize("hd", [64, 80])
def test_wide_bf16_windows_route_to_the_global_kernel(dev, hd):
    """A bf16 8 x 32 window (a side above the tensor-core K5's 16) goes
    through K4 from both routers and matches the same call on the CPU (the
    plain versions), with the skipped pad-query rows zero."""
    gh, gw, heads, W = 8, 32, 2, 3
    q, k, v, _ = _relpos_inputs(dev, W * heads, gh, gw, hd, torch.bfloat16,
                                1.0, 12)
    g = torch.Generator(device=dev).manual_seed(13)
    rh = (0.3 * torch.randn((2 * gh - 1, hd), generator=g, device=dev)).to(torch.bfloat16)
    rw = (0.3 * torch.randn((2 * gw - 1, hd), generator=g, device=dev)).to(torch.bfloat16)
    counts = (relpos_attention_global.launches,
              relpos_attention_windowed.launches, relpos_attention_qkv.launches)
    got = flash_attention_relpos(q, k, v, rh, rw, grid_h=gh, grid_w=gw,
                                 heads=heads, n_w=1, valid_rows=5)
    qkv = torch.stack([t.view(W, heads, gh * gw, hd) for t in (q, k, v)], 1)
    got_qkv = windowed_attention_qkv(qkv, rh, rw, grid_h=gh, grid_w=gw)
    torch.cuda.synchronize()
    assert (relpos_attention_global.launches,
            relpos_attention_windowed.launches,
            relpos_attention_qkv.launches) == (counts[0] + 2, *counts[1:])
    cpu = [t.cpu() for t in (q, k, v, rh, rw)]
    want = flash_attention_relpos(*cpu, grid_h=gh, grid_w=gw, heads=heads,
                                  n_w=1, valid_rows=5)
    torch.testing.assert_close(got.cpu().float(), want.float(),
                               atol=TOL[torch.bfloat16][1], rtol=0)
    assert not got[-heads:, 5 * gw:].any()
    want_qkv = windowed_attention_qkv(qkv.cpu(), cpu[3], cpu[4], grid_h=gh,
                                      grid_w=gw)
    torch.testing.assert_close(got_qkv.cpu().float(), want_qkv.float(),
                               atol=TOL[torch.bfloat16][1], rtol=0)


def test_kernels_raise_instead_of_falling_back(dev):
    x = torch.zeros(4, 96, device=dev)  # no kernel for C = 96
    with pytest.raises(DlimgError):
        fused_layer_norm(x, torch.ones(96, device=dev), torch.zeros(96, device=dev))
    qkv = torch.zeros(2, 49, 4 * 3 * 16, device=dev)  # head width 16
    with pytest.raises(DlimgError):
        levit_window_attention(qkv, torch.zeros(4, 49, 49, device=dev), 4)
    x = torch.zeros(4, 128, device=dev, dtype=torch.float16)
    with pytest.raises(DlimgError):
        fused_layer_norm(x, torch.ones(128, device=dev, dtype=torch.float16),
                         torch.zeros(128, device=dev, dtype=torch.float16))
    x = torch.zeros(4, 96, device=dev)
    with pytest.raises(DlimgError):
        fused_add_layer_norm(x, x, torch.ones(96, device=dev),
                             torch.zeros(96, device=dev))
    q = torch.zeros(2, 49, 32, device=dev)  # head width 32: no K4 / K5
    bhw = torch.zeros(2, 49, 14, device=dev)
    with pytest.raises(DlimgError):
        relpos_attention_global(q, q, q, bhw, 7, 7)
    with pytest.raises(DlimgError):
        relpos_attention_windowed(q, q, q, bhw, 7, 7, 2, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,grid,heads,hd,ws", [
    (1, 70, 12, 64, 14),   # ViT-B at 1024, q, k, v slices of the qkv output
    (1, 70, 16, 80, 14),   # ViT-H at 1024
    (2, 28, 2, 64, 14),    # two images
    (1, 21, 3, 80, 7),     # smaller windows
])
def test_window_strip_kernel_matches_plain(dev, B, grid, heads, hd, ws, dtype):
    g = torch.Generator(device=dev).manual_seed(5)
    C = heads * hd
    qkv = torch.randn((B, grid, grid, 3 * C), generator=g, device=dev).to(dtype)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    rh, rw = (0.3 * torch.randn((ws, ws, hd), generator=g, device=dev)
              for _ in range(2))
    before = windowed_attention_fused.launches
    got = windowed_attention_fused(q, k, v, rh, rw, ws=ws, num_heads=heads)
    torch.cuda.synchronize()
    assert windowed_attention_fused.launches == before + 1
    want = windowed_attention_fused_plain(q, k, v, rh, rw, ws=ws,
                                          num_heads=heads)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype][1],
                               rtol=0)


def _strip_operands(qkv, layout):
    """q, k, v as the channel slices of qkv (token stride 3C) or as three
    contiguous tensors (token stride C)."""
    C = qkv.shape[-1] // 3
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    if layout == "contiguous":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,grid,heads,hd,ws", [(1, 70, 12, 64, 14),
                                                (2, 28, 2, 80, 14)])
def test_window_strip_kernel_contiguous_operands(dev, B, grid, heads, hd, ws,
                                                 dtype):
    """q, k, v as three contiguous tensors (token stride C); the tables as
    views that do not start on 16 bytes (the kernel reads 16-byte chunks of
    their rows; the wrapper copies such a table)."""
    g = torch.Generator(device=dev).manual_seed(8)
    C = heads * hd
    qkv = torch.randn((B, grid, grid, 3 * C), generator=g, device=dev).to(dtype)
    q, k, v = _strip_operands(qkv, "contiguous")
    rh, rw = (torch.empty(ws * ws * hd + 1, device=dev, dtype=dtype)[1:]
              .view(ws, ws, hd).copy_(0.3 * torch.randn((ws, ws, hd), generator=g,
                                                         device=dev))
              for _ in range(2))
    before = windowed_attention_fused.launches
    got = windowed_attention_fused(q, k, v, rh, rw, ws=ws, num_heads=heads)
    torch.cuda.synchronize()
    assert windowed_attention_fused.launches == before + 1
    want = windowed_attention_fused_plain(q, k, v, rh, rw, ws=ws,
                                          num_heads=heads)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype][1],
                               rtol=0)


@pytest.mark.parametrize("layout", ["slices", "contiguous"])
@pytest.mark.parametrize("hd", [64, 80])
def test_window_strip_kernel_large_tables(dev, hd, layout):
    """bf16, rel-pos tables of scale ~3 on values whose bias sums are
    exact (see the module note): the halves' rounding order decides."""
    g = torch.Generator(device=dev).manual_seed(9)
    B, grid, heads, ws = 1, 42, 4, 14
    C = heads * hd

    def quarters(shape, std, limit):
        x = std * torch.randn(shape, generator=g, device=dev)
        return (torch.round(x * 4) / 4).clamp(-limit, limit)

    qkv = torch.randn((B, grid, grid, 3 * C), generator=g, device=dev)
    qkv[..., :C] = quarters((B, grid, grid, C), 1.0, 4.0)
    q, k, v = _strip_operands(qkv.to(torch.bfloat16), layout)
    rh, rw = (quarters((ws, ws, hd), 3.0, 12.0).to(torch.bfloat16)
              for _ in range(2))
    got = windowed_attention_fused(q, k, v, rh, rw, ws=ws, num_heads=heads)
    torch.cuda.synchronize()
    want = windowed_attention_fused_plain(q, k, v, rh, rw, ws=ws,
                                          num_heads=heads)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[torch.bfloat16][1], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W,heads,hd,g", [(25, 12, 64, 14), (25, 16, 80, 14),
                                          (3, 2, 64, 5), (2, 3, 80, 14)])
def test_relpos_qkv_kernel_matches_plain(dev, W, heads, hd, g, dtype):
    gen = torch.Generator(device=dev).manual_seed(6)
    qkv = torch.randn((W, 3, heads, g * g, hd), generator=gen,
                      device=dev).to(dtype)
    rh, rw = (0.3 * torch.randn((g, g, hd), generator=gen, device=dev)
              for _ in range(2))
    bhw = _bias_halves(qkv[:, 0].reshape(W * heads, g * g, hd), rh, rw, g, g)
    before = relpos_attention_qkv.launches
    got = relpos_attention_qkv(qkv, bhw, g, g)
    torch.cuda.synchronize()
    assert relpos_attention_qkv.launches == before + 1
    want = windowed_attention_qkv_plain(qkv, bhw, g, g)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype][1],
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["row-replicated", "per-lane"])
@pytest.mark.parametrize("reps", [1, 8, 16])
def test_smem_gather_kernel_matches_plain(dev, layout, reps, dtype):
    table, layouts = probe_inputs(dev, dtype)
    before = smem_gather.launches
    got = smem_gather(table, layouts[layout], reps)
    torch.cuda.synchronize()
    assert smem_gather.launches == before + 1
    want = smem_gather_plain(table, layouts[layout], reps)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,lanes", [(1, 16), (37, 40), (1000, 36),
                                        (4095, 24), (4097, 128), (7264, 16)])
def test_smem_gather_kernel_ragged_shapes(dev, rows, lanes, dtype):
    """Row counts that fill no whole row chunk, slabs cut short by the
    lanes (40, 36, 24), widths whose rows are not 16-byte multiples in
    bf16 (the scalar staging), and indices outside [0, rows), negative
    too: bit-equal to the plain version at reps 1, 8 and 16."""
    gen = torch.Generator(device=dev).manual_seed(rows + lanes)
    table = torch.randn((rows, lanes), generator=gen, device=dev).to(dtype)
    idx = torch.randint(-3 * rows, 3 * rows, (rows, lanes), generator=gen,
                        device=dev, dtype=torch.int32)
    for reps in (1, 8, 16):
        got = smem_gather(table, idx, reps)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, smem_gather_plain(table, idx, reps),
                                   atol=0, rtol=0)


def test_new_kernels_raise_instead_of_falling_back(dev):
    x = torch.zeros(1, 28, 28, 3 * 96, device=dev)  # head width 48: no K6
    q, k, v = x[..., :96], x[..., 96:192], x[..., 192:]
    rh = torch.zeros(14, 14, 48, device=dev)
    with pytest.raises(DlimgError):
        windowed_attention_fused(q, k, v, rh, rh, ws=14, num_heads=2)
    qkv = torch.zeros(2, 3, 2, 49, 32, device=dev)  # head width 32: no K7
    with pytest.raises(DlimgError):
        relpos_attention_qkv(qkv, torch.zeros(4, 49, 14, device=dev), 7, 7)
    # bf16 windows with a side above 16 (the tensor-core body's bias
    # columns): the low-level wrappers refuse them; flash_attention_relpos
    # and windowed_attention_qkv route them to K4 (see above)
    qkv = torch.zeros(2, 3, 2, 8 * 32, 64, device=dev, dtype=torch.bfloat16)
    bhw = torch.zeros(4, 8 * 32, 40, device=dev, dtype=torch.bfloat16)
    with pytest.raises(DlimgError):
        relpos_attention_qkv(qkv, bhw, 8, 32)
    q = qkv[:, 0].reshape(4, 8 * 32, 64)
    with pytest.raises(DlimgError):
        relpos_attention_windowed(q, q, q, bhw, 8, 32, 2, False)
    table = torch.zeros(8000, 16, device=dev)  # 8000 rows: no slab fits
    with pytest.raises(DlimgError):
        smem_gather(table, torch.zeros(8000, 16, dtype=torch.int32,
                                       device=dev), 2)


# -- the executable cache as CUDA graphs ------------------------------------

GRAPH_SIZES = {"mobile_sam": 64, "vit_b": 256}


def _graph_env(variant, dtype):
    """A card Environment at a small image size; for vit_b a narrow
    injected bundle (width 128, 2 heads of 64, one windowed and one global
    block) with nonzero rel-pos tables and qkv biases."""
    size = GRAPH_SIZES[variant]
    env = dl.Environment(dl.Options(
        allow_random_weights=True, compute_dtype=dtype, sam_variant=variant,
        sam_image_size=size, largest_region_object=True,
        model_directory="no-such-directory"))
    if variant == "vit_b":
        enc = vit_sam.SamViTConfig(img_size=size, embed_dim=128, depth=2,
                                   num_heads=2, global_attn_indexes=(1,),
                                   use_flash_attention=True)
        cfg = dataclasses.replace(sam.make_config("vit_b", size),
                                  encoder_vit=enc)
        model = sam.init_sam(torch.Generator().manual_seed(3), cfg)
        gen = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for name, p in model.encoder.named_parameters():
                if name.endswith(("rel_pos_h", "rel_pos_w", "qkv.b")):
                    p.copy_(0.3 * torch.randn(p.shape, generator=gen))
        model.encoder.to(env.compute_dtype)
        bundle = SamModelBundle(cfg, model.to(env.device), env.compute_dtype)
        assert env._sam_models["vit_b"].get_or_create(lambda: bundle) is bundle
    return env


def _image(w, h, seed):
    px = np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)
    return dl.Image(dl.Extent(w, h), dl.Channels.rgba, px)


def _queries(seg):
    w, h = seg.extent.width, seg.extent.height
    region = dl.Region(dl.Point(w // 8, h // 8), dl.Point(w * 7 // 8, h * 7 // 8))
    return ([seg.compute_mask(dl.Point(w // 2, h // 2)).pixels,
             seg.compute_mask(region).pixels,
             seg.compute_mask(region, largest_component=False).pixels]
            + [m.image.pixels for m in seg.compute_masks(dl.Point(w // 3, h // 2))]
            + [m.image.pixels for m in seg.compute_mask_batch(
                [dl.Point(w // 2, h // 2), region, dl.Point(w // 4, h // 4)])])


@pytest.mark.parametrize("variant,dtype", [("mobile_sam", "float32"),
                                           ("mobile_sam", "bfloat16"),
                                           ("vit_b", "float32"),
                                           ("vit_b", "bfloat16")])
def test_graph_replay_equals_eager(dev, variant, dtype):
    env = _graph_env(variant, dtype)
    for img in (_image(100, 80, 1), _image(400, 300, 2)):  # buckets 256, 512
        segs = [dl.Segmentation.process(img, env) for _ in range(3)]
        first = _queries(segs[0])
        for _ in range(2):
            again = _queries(segs[0])
            assert all(np.array_equal(a, b) for a, b in zip(first, again))
        for seg in segs[1:]:
            assert torch.equal(seg.embedding, segs[0].embedding)
        kinds = {key[0] for key in env.executables}
        assert kinds == {"embed", "decode", "decode_batch"}
        for key, exe in env.executables.items():
            assert exe.graphed and exe.captured, key
            got, want = exe.replay_against_eager()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (
                    f"{key}: max|diff| {(g.float() - w.float()).abs().max()}")
    # Both largest_component kinds were captured, the labelled one as two
    # graphs around the eager labelling.
    assert {k[4] for k in env.executables if k[0] == "decode"} == {True, False}
    assert {len(e._stages) for e in env.executables.values()} == {1, 3}


@pytest.mark.parametrize("variant", ["mobile_sam", "vit_b"])
def test_graph_results_do_not_alias(dev, variant):
    env = _graph_env(variant, "bfloat16")
    size = GRAPH_SIZES[variant]
    a_img, b_img = _image(size * 3 // 2, size, 5), _image(size * 3 // 2, size, 6)
    for _ in range(2):  # captured, then replayed
        dl.Segmentation.process(a_img, env)
    a = dl.Segmentation.process(a_img, env)
    a_emb = a.embedding.clone()
    a_masks = _queries(a)
    b = dl.Segmentation.process(b_img, env)
    assert not torch.equal(b.embedding, a_emb)
    assert torch.equal(a.embedding, a_emb)
    assert all(np.array_equal(x, y) for x, y in zip(_queries(a), a_masks))


def test_graph_two_threads_on_one_key(dev):
    env = _graph_env("mobile_sam", "bfloat16")
    imgs = [_image(96, 64, 7), _image(96, 64, 8)]
    segs = [dl.Segmentation.process(img, env) for img in imgs]
    points = [dl.Point(20, 20), dl.Point(70, 40)]
    want_emb = [s.embedding.clone() for s in segs]
    want = [s.compute_mask(p).pixels for s, p in zip(segs, points)]
    errors = []

    def work(i):
        try:
            for _ in range(20):
                seg = dl.Segmentation.process(imgs[i], env)
                if not torch.equal(seg.embedding, want_emb[i]):
                    errors.append(f"thread {i}: embedding")
                if not np.array_equal(seg.compute_mask(points[i]).pixels, want[i]):
                    errors.append(f"thread {i}: mask")
        except Exception as e:  # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors


@pytest.mark.parametrize("largest_region_object", [True, False])
def test_compute_mask_batch_equals_compute_mask_at_the_main_size(
        dev, largest_region_object):
    """JAX's contract (tests/test_segmentation.py::
    test_compute_mask_batch_matches_individual) on the card, at the main
    path's size: full-width MobileSAM at 1024 in bf16 (the decoder
    float32), a 1024x768 image, 16 seeded points and boxes, every batch
    size 1-8 with each prompt at every position, each mask byte-equal to
    `compute_mask` of its prompt."""
    env, seg = probe_batch_masks.main_path_segmentation(dl, largest_region_object)
    prompts = probe_batch_masks.batch_prompts(dl, seg.extent)
    report = probe_batch_masks.hold_batches(dl, seg, prompts)
    assert report["calls"] == 8 * len(prompts)
    assert not report["differ"], probe_batch_masks.describe(report)


def test_graph_capture_failure_raises(dev):
    env = _graph_env("mobile_sam", "float32")
    ran = []

    def build():
        def run(x):
            ran.append(1)
            return x * float(x.sum().item())  # a host read: not capturable
        return run

    exe = env.executable(("host_read",), build, lambda t: t.clone())
    x = torch.ones(4, device=dev)
    for _ in range(2):
        ran.clear()
        with pytest.raises(DlimgError, match="host_read"):
            exe(x)
        assert len(ran) == 2  # the warm-up, then the capture attempt
    # The caller's stream and the rest of the Environment still work.
    assert torch.cuda.current_stream(dev) == torch.cuda.default_stream(dev)
    seg = dl.Segmentation.process(_image(96, 64, 9), env)
    assert seg.compute_mask(dl.Point(10, 10)).pixels.shape == (64, 96, 1)


# -- the greedy box NMS kernel ----------------------------------------------


def _nms_inputs(dev, M, seed):
    """Score-sorted overlapping boxes on a 256 grid (the low-res mask grid
    at image size 1024), with duplicates, and an invalid (-1) tail."""
    gen = torch.Generator().manual_seed(seed)
    xy = torch.randint(0, 200, (M, 2), generator=gen)
    wh = torch.randint(1, 80, (M, 2), generator=gen)
    boxes = torch.cat([xy, xy + wh - 1], dim=1).float()
    dup = torch.randint(0, M, (M // 8,), generator=gen)
    boxes[M - M // 8:] = boxes[dup]
    boxes = boxes[torch.randperm(M, generator=gen)]
    scores = torch.sort(torch.rand(M, generator=gen), descending=True).values
    scores[M - M // 10:] = -1.0
    return boxes.to(dev), scores.to(dev)


@pytest.mark.parametrize("M", [256, 2304, 9216, 14400])
def test_greedy_nms_kernel_matches_plain(dev, M):
    boxes, scores = _nms_inputs(dev, M, M)
    for t in (0.3, 0.7, 1.0):
        thresh = torch.tensor([t], device=dev)
        before = greedy_nms.launches
        got = greedy_nms(boxes, scores, thresh)
        assert greedy_nms.launches == before + 1
        want = greedy_nms_plain(boxes, scores, thresh)
        assert got.dtype == torch.bool and torch.equal(got, want), (
            f"M {M} thresh {t}: {int((got != want).sum())} flags differ")
        if t < 1.0:
            assert 0 < int(want.sum()) < int((scores > 0).sum())
        else:
            assert torch.equal(want, scores > 0)


def test_greedy_nms_graph_reads_the_current_threshold(dev):
    boxes, scores = _nms_inputs(dev, 2304, 7)
    thresh = torch.tensor([0.5], device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        greedy_nms(boxes, scores, thresh)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        keep = greedy_nms(boxes, scores, thresh)
    for t in (0.5, 0.2, 0.9):
        thresh.fill_(t)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(keep, greedy_nms_plain(boxes, scores, thresh)), t


@pytest.mark.parametrize("M", [1, 63, 64, 65, 2304, 14400])
def test_greedy_nms_kernel_word_edges_and_exact_ties(dev, M):
    """Row counts around the kernel's 64-bit words, pairs of boxes at IoU
    exactly 0.5 (both kept at threshold 0.5: the test is >) and exact
    duplicates (IoU 1.0, kept at threshold 1.0), scores at 0 and below
    (never kept, never suppressing), and the threshold changed between
    replays of one CUDA graph: keep flags bit-equal to the plain loop."""
    boxes, scores = _nms_inputs(dev, M, M + 1)
    boxes, scores = boxes.cpu(), scores.cpu()
    for i in range(0, M - 1, 61):  # a pair in every 64-row block or across two
        boxes[i] = torch.tensor([10.0, 10.0, 19.0, 19.0])  # area 100
        boxes[i + 1] = torch.tensor([10.0, 10.0, 19.0, 29.0])  # 200, inter 100
    scores[torch.arange(M) % 7 == 3] = 0.0
    scores[torch.arange(M) % 11 == 5] = -0.25
    boxes, scores = boxes.to(dev), scores.to(dev)
    if M > 1:
        iou = box_iou_matrix(boxes[:2])
        assert float(iou[0, 1]) == 0.5
    thresh = torch.tensor([0.5], device=dev)
    want = greedy_nms_plain(boxes, scores, thresh)
    if M > 1:
        assert bool(want[0]) and bool(want[1])  # IoU == thresh: both kept
    assert not bool((want & (scores <= 0)).any())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        before = greedy_nms.launches
        eager = greedy_nms(boxes, scores, thresh)
        assert greedy_nms.launches == before + 1  # one call, two launches
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(eager, want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        keep = greedy_nms(boxes, scores, thresh)
    for t in (1.0, 0.3, 0.5, 0.0):
        thresh.fill_(t)
        graph.replay()
        torch.cuda.synchronize()
        want = greedy_nms_plain(boxes, scores, thresh)
        assert torch.equal(keep, want), (
            f"M {M} thresh {t}: {int((keep != want).sum())} flags differ")
        if t == 1.0:
            assert torch.equal(keep, scores > 0)


def test_greedy_nms_raises_instead_of_falling_back(dev):
    boxes, scores = _nms_inputs(dev, 64, 1)
    with pytest.raises(DlimgError):
        greedy_nms(boxes, scores, 0.5)  # a host float would be baked in
    with pytest.raises(DlimgError):
        greedy_nms(boxes, scores, torch.tensor([0.5]))  # on the host
    with pytest.raises(DlimgError):
        greedy_nms(boxes.double(), scores, torch.tensor([0.5], device=dev))
    with pytest.raises(DlimgError):
        greedy_nms(boxes.view(-1)[1:-3].reshape(-1, 4), scores[1:],
                   torch.tensor([0.5], device=dev))  # not 16-byte aligned


# ---------------------------------------------------------------------------
# The float32 precision repair and BiRefNet on the card
# ---------------------------------------------------------------------------

def _slim_birefnet_env(monkeypatch, backend, dtype):
    """The slim BiRefNet at resolution 64 with seeded nonzero offset and
    modulator convs and biases (the same weights on every backend)."""
    from dlimgedit_tpu_torch.models.birefnet import seed_nonzero_init

    monkeypatch.setenv("DLIMG_BIREFNET_TEST_SLIM", "1")
    monkeypatch.setenv("DLIMG_BIREFNET_RESOLUTION", "64")
    env = dl.Environment(dl.Options(backend=backend, allow_random_weights=True,
                                    compute_dtype=dtype,
                                    model_directory="no-such-directory"))
    seed_nonzero_init(env.birefnet_model("general").model)
    return env


@pytest.mark.parametrize("path", ["mobile_sam", "birefnet"])
def test_float32_under_tf32_flags_matches_cpu(dev, monkeypatch, path):
    """cuDNN's default TF32 flag on and the caller's matmul TF32 on as well:
    a float32 `process` (MobileSAM at 64: relative L2 1e-5) or
    `segment_objects` (slim BiRefNet at 64: within 1 quantum) on the card
    matches the CPU port, and the caller's flags are as they were."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    img = _image(96, 64, 42)
    if path == "mobile_sam":
        envs = [dl.Environment(dl.Options(
            backend=b, allow_random_weights=True, compute_dtype="float32",
            sam_image_size=64, model_directory="no-such-directory"))
            for b in (dl.Backend.cpu, dl.Backend.gpu)]
        cpu, card = (dl.Segmentation.process(img, e).embedding.float().cpu()
                     for e in envs)
        rel = (torch.linalg.vector_norm(card - cpu)
               / torch.linalg.vector_norm(cpu)).item()
        assert rel <= 1e-5, rel
    else:
        envs = [_slim_birefnet_env(monkeypatch, b, "float32")
                for b in (dl.Backend.cpu, dl.Backend.gpu)]
        cpu, card = (dl.segment_objects(img, e).pixels.astype(np.int32)
                     for e in envs)
        assert np.abs(cpu - card).max() <= 1
    assert torch.backends.cudnn.allow_tf32 is True
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_float32_conv_executable_ignores_tf32_flags(dev, monkeypatch):
    """One float32 conv of the port's conv2d as an executable, with cuDNN's
    and cuBLAS's TF32 flags on: its warm-up, its eager program and its
    graph's replays at full precision against the CPU (relative L2 1e-5),
    while the same conv called outside any executable takes the caller's
    TF32 (its error is printed); the caller's flags stay as they were."""
    from dlimgedit_tpu_torch.models.common import conv2d

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 64, 64, 256), generator=g)
    w = torch.randn((256, 256, 3, 3), generator=g) * 0.05
    want = conv2d(x, w, padding=1)

    def rel(got):
        return (torch.linalg.vector_norm(got.cpu() - want)
                / torch.linalg.vector_norm(want)).item()

    env = _graph_env("mobile_sam", "float32")
    exe = env.executable(("conv",), lambda: lambda a, b: conv2d(a, b, padding=1),
                         lambda t: t.clone())
    xd, wd = x.to(dev), w.to(dev)
    errs = [rel(exe(xd, wd)) for _ in range(3)] + [rel(exe.eager(xd, wd))]
    assert exe.captured
    assert max(errs) <= 1e-5, errs
    print(f"outside any executable: relative L2 {rel(conv2d(xd, wd, padding=1))}")
    assert torch.backends.cudnn.allow_tf32 is True
    assert torch.backends.cuda.matmul.allow_tf32 is True


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_birefnet_graph_replay_equals_eager(dev, monkeypatch, dtype):
    """segment_objects as one CUDA graph per ("birefnet", kind, bucket):
    three rounds over two buckets and an escalated image, every replay
    bit-equal to the key's eager program and to round 1."""
    env = _slim_birefnet_env(monkeypatch, dl.Backend.gpu, dtype)
    imgs = (_image(100, 80, 1), _image(400, 300, 2), _image(1600, 90, 3))
    first = [dl.segment_objects(img, env).pixels for img in imgs]
    for _ in range(2):
        for img, want in zip(imgs, first):
            assert np.array_equal(dl.segment_objects(img, env).pixels, want)
    assert sorted(env.executables) == [("birefnet", "general", 256),
                                       ("birefnet", "general", 512),
                                       ("birefnet", "high_res", 2048)]
    for key, exe in env.executables.items():
        assert exe.graphed and exe.captured, key
        got, want = exe.replay_against_eager()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), key


# -- int8 quantisation: P2, P3 and the quantised encoders -----------------

# The encoders' linear output widths (TinyViT qkv / proj / fc1, the ViTs'
# qkv / proj / lin1 at B, L, H).
EPILOGUE_WIDTHS = (384, 480, 960, 128, 640, 1280, 2304, 768, 3072, 4096, 5120,
                   3840)


def _activations(dev, rows, C, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, C), generator=g, device=dev)
    x = x * torch.exp(2 * torch.randn((rows, 1), generator=g, device=dev))
    x[rows // 2] = 0  # the 1e-8 floor of the scale
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", quant.QUANT_ROW_WIDTHS)
def test_quant_rows_kernel_bit_equal_to_plain(dev, C, dtype):
    for rows, seed in ((3, 0), (37, 1), (4900, 2)):
        x = _activations(dev, rows, C, dtype, seed)
        before = quant.quantize_rows_int8.launches
        q, s = quant.quantize_rows_int8(x)
        torch.cuda.synchronize()
        assert quant.quantize_rows_int8.launches == before + 1
        q_want, s_want = quant.quantize_activations_int8(x)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert torch.equal(s, s_want), (rows, (s - s_want).abs().max())
        assert torch.equal(q, q_want), (rows, int((q != q_want).sum()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", EPILOGUE_WIDTHS)
def test_quant_epilogue_kernel_bit_equal_to_plain(dev, N, dtype):
    g = torch.Generator(device=dev).manual_seed(N)
    for rows, bias in ((17, True), (4096, True), (300, False)):
        acc = torch.randint(-2**24, 2**24, (rows, N), generator=g, device=dev,
                            dtype=torch.int32)
        xs = torch.rand((rows, 1), generator=g, device=dev) * 1e-2
        ws = torch.rand((N,), generator=g, device=dev) * 1e-3
        b = (torch.randn((N,), generator=g, device=dev).to(dtype)
             if bias else None)
        before = quant.int8_epilogue.launches
        y = quant.int8_epilogue(acc, xs, ws, b, dtype)
        torch.cuda.synchronize()
        assert quant.int8_epilogue.launches == before + 1
        want = quant.int8_epilogue_plain(acc, xs, ws, b, dtype)
        assert y.dtype == dtype and torch.equal(y, want), (
            rows, bias, (y.float() - want.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", [(320, 960), (640, 160), (768, 3072), (5120, 1280)])
def test_quant_int8_linear_on_card_equals_cpu(dev, K, N, dtype):
    """The s8 x s8 linear on the card (P2, cuBLASLt's int8 product, P3)
    equals the CPU's plain path bit for bit on the same inputs."""
    g = torch.Generator().manual_seed(K + N)
    w_q, w_scale = quant.quantize_weight(0.05 * torch.randn((K, N), generator=g))
    lin = QuantLinear(w_q, w_scale, 0.1 * torch.randn(N, generator=g),
                      act_int8=True)
    x = torch.randn((2, 77, K), generator=g).to(dtype)
    lin.b.data = lin.b.data.to(dtype)
    want = quant.int8_linear(lin, x)
    got = quant.int8_linear(lin.to(dev), x.to(dev))
    assert got.is_contiguous() and got.shape == (2, 77, N)
    assert torch.equal(got.cpu(), want)


def test_quant_cuda_tensor_never_takes_the_plain_path(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(quant, "quantize_activations_int8", refuse)
    monkeypatch.setattr(quant, "int8_epilogue_plain", refuse)
    x = torch.randn((40, 320), device=dev, dtype=torch.bfloat16)
    q, s = quant.quantize_rows_int8(x)
    acc = torch.zeros((40, 960), dtype=torch.int32, device=dev)
    quant.int8_epilogue(acc, s, torch.ones(960, device=dev), None, x.dtype)
    torch.cuda.synchronize()
    with pytest.raises(DlimgError, match="no CUDA kernel for width"):
        quant.quantize_rows_int8(torch.randn((40, 96), device=dev))
    with pytest.raises(DlimgError, match="multiples of 8"):
        quant.int8_mm(torch.zeros((32, 324), dtype=torch.int8, device=dev),
                      torch.zeros((324, 960), dtype=torch.int8, device=dev))
    # Fewer than 17 rows are padded for cuBLASLt and sliced back: exact.
    gen = torch.Generator().manual_seed(0)
    for M in (1, 4, 16):
        q = torch.randint(-127, 128, (M, 320), generator=gen, dtype=torch.int8)
        w = torch.randint(-127, 128, (320, 960), generator=gen,
                          dtype=torch.int8)
        got = quant.int8_mm(q.to(dev), w.to(dev).t().contiguous().t())
        assert got.shape == (M, 960)
        assert torch.equal(got.cpu(), torch._int_mm(q, w))


def _quant_env(variant, mode, dtype="bfloat16"):
    """A card Environment with an int8 encoder: MobileSAM at 256 (every
    linear has more than 16 tokens), or the narrow ViT-B of _graph_env,
    quantised as ``_load_sam`` does (before the cast)."""
    opts = dict(quantize_encoder=True, quantize_activations=mode == "w8a8")
    env = dl.Environment(dl.Options(
        allow_random_weights=True, compute_dtype=dtype, sam_variant=variant,
        sam_image_size=256, largest_region_object=True,
        model_directory="no-such-directory", **opts))
    if variant == "vit_b":
        enc = vit_sam.SamViTConfig(img_size=256, embed_dim=128, depth=2,
                                   num_heads=2, global_attn_indexes=(1,),
                                   use_flash_attention=True)
        cfg = dataclasses.replace(sam.make_config("vit_b", 256), encoder_vit=enc)
        model = sam.init_sam(torch.Generator().manual_seed(3), cfg)
        bundle = SamModelBundle(cfg, model, env.compute_dtype,
                                quantize=True, quantize_activations=mode == "w8a8")
        bundle.model.to(env.device)
        assert env._sam_models["vit_b"].get_or_create(lambda: bundle) is bundle
    return env


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
@pytest.mark.parametrize("variant", ["mobile_sam", "vit_b"])
def test_quant_process_replays_equal_eager(dev, variant, mode):
    env = _quant_env(variant, mode)
    bundle = env.sam_model(variant)
    assert bundle.quant == mode
    blocks = 10 if variant == "mobile_sam" else 2
    img = _image(300, 200, 7)
    counts = []
    for _ in range(3):
        before = (quant.quantize_rows_int8.launches, quant.int8_epilogue.launches)
        seg = dl.Segmentation.process(img, env)
        seg.compute_mask(dl.Point(150, 100))
        torch.cuda.synchronize()
        counts.append((quant.quantize_rows_int8.launches - before[0],
                       quant.int8_epilogue.launches - before[1]))
    per = 4 * blocks if mode == "w8a8" else 0
    assert counts == [(per, per)] * 3
    assert env.executables[("embed", variant, 512, mode)].captured
    for k, exe in env.executables.items():
        got, want = exe.replay_against_eager()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), k


@pytest.mark.parametrize("variant", ["mobile_sam", "vit_b"])
def test_encode_frames_graph_replay_equals_eager(dev, variant):
    """encode_frames on the card: one CUDA graph per batch shape, its
    replay bit-equal to the eager program and to the first call, the
    kernels launched (K5 without the pad-query skip for ViT-B's batch),
    results that the next call does not overwrite, each frame within
    relative L2 2e-2 of a call on it alone (bf16)."""
    from dlimgedit_tpu_torch.parallel import batch as pbatch

    env = _graph_env(variant, "bfloat16")
    bundle = env.sam_model(variant)
    size = GRAPH_SIZES[variant]
    gen = torch.Generator(device=dev).manual_seed(7)
    frames = torch.randn((3, size, size, 3), generator=gen,
                         device=dev).to(torch.bfloat16)
    before = {k.__name__: k.launches for k in COUNTED_KERNELS}
    first = pbatch.encode_frames(bundle.model, bundle.cfg, frames)
    kept = first.clone()
    second = pbatch.encode_frames(bundle.model, bundle.cfg, frames)
    assert torch.equal(first, kept) and torch.equal(second, first)
    launched = {k.__name__: k.launches - before[k.__name__]
                for k in COUNTED_KERNELS}
    assert sum(launched.values()) > 0
    exe = next(e for key, e in pbatch._GRAPH_CACHE.items()
               if key[1] is bundle.model and key[3] == tuple(frames.shape))
    assert exe.captured
    got, want = exe.replay_against_eager()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for i in range(3):
        one = pbatch.encode_frames(bundle.model, bundle.cfg, frames[i:i + 1])
        rel = float((first[i].float() - one[0].float()).norm()
                    / one[0].float().norm())
        assert rel <= 2e-2, rel


def test_prefetch_to_device_on_the_card(dev):
    """Batches arrive on cuda:0 in order, from a copy stream, and a step's
    work on them sees every byte (the consumer waits on the copy's
    event)."""
    from dlimgedit_tpu_torch.train.data import prefetch_to_device

    host = [{"x": np.full((256, 1024), i, np.float32), "y": [np.arange(8) + i]}
            for i in range(6)]
    out = []
    for b in prefetch_to_device(iter(host), depth=3):
        assert b["x"].device == dev and b["x"].is_cuda
        out.append((float(b["x"].sum()), b["y"][0].cpu().numpy()))
    assert [o[0] for o in out] == [float(i * 256 * 1024) for i in range(6)]
    assert all(np.array_equal(o[1], np.arange(8) + i) for i, o in enumerate(out))
