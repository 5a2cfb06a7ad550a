"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: skipped where no CUDA device is present (the decision is
taken inside the tests, never at import). This file imports neither jax
nor the JAX package, so on a GPU machine without JAX it runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

chip_smoke.py runs the same comparisons at the main path's full shapes.
Tolerances as there: float32 atol 1e-5 (LayerNorm) / 2e-5 (attention),
bf16 atol 2e-2. K1 runs at every width in both dtypes at row counts that
its row groups, blocks and waves split unevenly; K1 and K3 also at widths
without instances of their own (C 1-4100: a masked last chunk, rows wider
than a warp holds), and on strided views and views that do not start on
16 bytes, which the wrappers copy (``kernel_operand``) while the C entry
point still refuses them. K3's s must equal the plain x + d bit for bit,
and K8 (the gather probe) its plain version: both sum in the same order.
K4-K7 run at every head width other than 64 and 80 that is a multiple of
8 up to 128 (the padded instances). Every other geometry the JAX
functions take (K2 at any kd and N, K4-K7 at any head width, 16-bit K5 /
K7 windows with a side above 16, K6 on any window, more than 65535
groups) launches the general body (csrc/attention_general.cuh) and holds
the plain version at these tolerances, each call counted in its
wrapper's ``general_launches``; no main path's shape reaches it. A
float64 input raises (no plain path and no cast on the card).

Float16 (``-k float16``): every kernel the JAX functions run in float16
(K1-K8, P2, P3) at the main paths' shapes, one launch each, against its
plain version on the same inputs within two float16 steps at |out| < 4
(atol 4e-3; K6 5e-3, whose bias halves round apart now and then), the
attention kernels' mean |diff| within F16_MEAN_ATOL (a body that rounds
p to bf16 exceeds it), K3's s, K8, P2 and P3 bit for bit. The int8
linears at in / out widths that are not multiples of 8 (``-k any_width``):
P2, cuBLASLt's product on the zero-padded operands and P3, the int32
product equal to the plain one and the output to the CPU's bit for bit.

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

Float32 K4, K5 and K6 (csrc/relpos_attention_f32tc.cu) and float32 K2
(csrc/levit_attention_f32tc.cu): every product in three TF32 passes on the
tensor cores. K4 and K5 hold the plain version at 2e-5 at hd 64 and 80, N
= 196 (the ragged last key chunk), 4096 and 16384 (K4 on a grid whose bias
halves leave no room in shared memory and are read in place), folded and
plain bias, with and without the pad-query skip (skipped rows exactly
zero), G = 1 and 25 x 16, and on scores of large range (q of scale 4),
where a single TF32 pass is off by ~4e-3 (tests/test_torch_tf32x3.py
emulates K2, K4, K5 and K6 on the CPU); K2 at every N from 1 to 256, K6
with q, k, v as slices and contiguous and with large tables. A float32 q,
k, v (K2: qkv) that does not start on 16 bytes is copied by the wrapper and
gives the aligned input's result bit for bit; the C entry points refuse it.

The bf16 K4 on grids whose rows are not 64 keys (C8): a 128 x 128 grid at
hd 64 (bias rows in shared memory, each key's (y, x) computed from its
index) and hd 80 (the bias rows read in place), and a 96 x 96 grid at hd
80, where the old key table overflowed shared memory (cudaError 1).

K6's large-table case holds the rounding of its bias halves: q and the
tables are multiples of 1/4 (rh, rw of scale ~3), so every float32 sum of
their products is exact in any order and the halves (~24 in size, bf16
steps of 1/8) round the same on both sides; rounding bh + bw together, or
scaling before rounding, moves scores by up to half such a step and the
output by more than the tolerance. In float32 the same inputs hold the
order of the score's terms, ((q.k) scale + bh) + bw, with exact halves.
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
    ATTENTION_KERNELS,
    _bias_halves,
    attention_body,
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
from dlimgedit_tpu_torch.ops.cuda_build import DTYPE_CODES, LIBRARY, kernel_operand
from dlimgedit_tpu_torch.ops.fused_norm import (
    KERNEL_WIDTHS,
    fused_add_layer_norm,
    fused_add_layer_norm_plain,
    fused_layer_norm,
    layer_norm_plain,
)
from dlimgedit_tpu_torch.ops import quant
from dlimgedit_tpu_torch.tools import k6_draws, probe_batch_masks
from dlimgedit_tpu_torch.tools.probe_smem_gather import (
    probe_inputs,
    smem_gather,
    smem_gather_plain,
)
from dlimgedit_tpu_torch.runtime.environment import COUNTED_KERNELS, SamModelBundle

pytestmark = pytest.mark.cuda

# (LayerNorm, attention) atol by dtype. float16: two float16 steps at
# |out| < 4 (2^-9 each); the LayerNorms' outputs reach 4, where one step is
# 3.9e-3.
TOL = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (2e-2, 2e-2),
       torch.float16: (4e-3, 4e-3)}
# K6 in float16: its bias halves, summed in another order than the plain
# version's, now and then round to float16 apart and move a logit by one
# step at |bias| ~ 8 (4.4e-3 measured on an H100).
F16_STRIP_ATOL = 5e-3
# The float16 attention kernels' mean |kernel - plain|: a float16 body that
# rounds p to bf16 moves most outputs by a step (on an H100: the bodies'
# mean 1.3e-7 to 1.4e-6, with p rounded to bf16 1.7e-4 to 5.6e-4;
# tools/f16_rounding_check.py).
F16_MEAN_ATOL = 2e-5


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
                                       ((65, 1280), 1e-6)] + [
    # every width at row counts of 1 and 7 (a part of one row group), the sp
    # shards' 1372 and 2548, MobileSAM's 17689 (more rows than a wave holds
    # at the ViT widths: each warp walks several row groups), and 4097 and
    # 70757, one past a multiple of any block's rows (at most 32) and, for
    # 70757, more than a wave holds at every width
    ((rows, C), 1e-6) for C in KERNEL_WIDTHS
    for rows in (1, 7, 1372, 2548, 4097, 17689, 70757)])
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
@pytest.mark.parametrize("N", range(1, 257))
def test_levit_attention_kernel_every_window_size(dev, N, dtype):
    """K2 on the tensor cores, bf16 and float32 (three TF32 passes), at
    every N its entry point takes (instances of 64, 208 and 256 keys; N
    above 64 splits a (window, head) group's 16-row stripes over blocks of
    4); qkv a view that starts 16 bytes into its storage and, for bf16, one
    that does not start on 16 bytes."""
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


def _relpos_inputs(dev, G, gh, gw, hd, dtype, out_scale, seed, q_scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    N = gh * gw
    q, k, v = (torch.randn((G, N, hd), generator=g, device=dev).to(dtype)
               for _ in range(3))
    q = q * q_scale
    rh = 0.3 * torch.randn((gh, gh, hd), generator=g, device=dev)
    rw = 0.3 * torch.randn((gw, gw, hd), generator=g, device=dev)
    return q, k, v, _bias_halves(q, rh, rw, gh, gw, out_scale=out_scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,gh,gw,hd", [(2, 20, 20, 64), (3, 32, 32, 80),
                                        (1, 7, 9, 64), (2, 64, 64, 64),
                                        (1, 24, 40, 80),   # gw vs the 64-key tile
                                        (2, 32, 32, 64),   # ViT-B at 512
                                        (1, 64, 64, 80),   # ViT-H's global grid
                                        (1, 14, 14, 80),   # a ragged last chunk
                                        # C8: a ViT at 2048 and at 1536
                                        (1, 128, 128, 64), (1, 128, 128, 80),
                                        (1, 96, 96, 80)])
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
    (1, 1, 64, True, None, None),  # one group
    (25, 16, 80, False, 5, 8),    # ViT-H's windows, the unfolded bias
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


@pytest.mark.parametrize("kernel,W,heads,grid,hd,folded,n_w,valid_rows", [
    ("global", 1, 1, 64, 64, False, None, None),
    ("global", 1, 2, 64, 80, False, None, None),
    ("global", 1, 3, 14, 80, False, None, None),
    ("windowed", 25, 16, 14, 80, True, 5, 8),   # ViT-H's windows
    ("windowed", 25, 12, 14, 64, False, 5, 8),  # ViT-B's, the unfolded bias
    ("windowed", 9, 2, 14, 64, True, None, None),
])
def test_relpos_f32_kernels_large_range(dev, kernel, W, heads, grid, hd, folded,
                                        n_w, valid_rows):
    """Float32 K4 and K5 on scores of large range (q of scale 4): three
    TF32 passes hold 2e-5 where one pass is off by ~4e-3."""
    G = W * heads
    scale = hd ** -0.5
    q, k, v, bhw = _relpos_inputs(dev, G, grid, grid, hd, torch.float32,
                                  1.0 / scale if folded else 1.0, 14,
                                  q_scale=4.0)
    if kernel == "global":
        got = relpos_attention_global(q, k, v, bhw, grid, grid)
        want = attention_relpos_plain(q, k, v, bhw, grid, grid)
    else:
        got = relpos_attention_windowed(q, k, v, bhw, grid, grid, heads,
                                        folded, n_w, valid_rows)
        want = attention_relpos_plain(q, k, v, bhw, grid, grid, folded=folded,
                                      heads=heads, n_w=n_w,
                                      valid_rows=valid_rows)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=TOL[torch.float32][1], rtol=0)
    if n_w:
        assert not got[-n_w * heads:, valid_rows * grid:].any()


@pytest.mark.parametrize("hd", [64, 80])
def test_relpos_f32_global_kernel_bias_halves_in_place(dev, hd):
    """Float32 K4 on a 128 x 128 grid, whose 128 rows of bias halves leave
    no room beside the key chunks in shared memory: they are read in place
    from device memory."""
    q, k, v, bhw = _relpos_inputs(dev, 1, 128, 128, hd, torch.float32, 1.0, 17)
    got = relpos_attention_global(q, k, v, bhw, 128, 128)
    torch.cuda.synchronize()
    want = attention_relpos_plain(q, k, v, bhw, 128, 128)
    torch.testing.assert_close(got, want, atol=TOL[torch.float32][1], rtol=0)


def _shifted(t, elems=1):
    """A copy of t as a contiguous view that starts `elems` elements into
    its storage (4 bytes in float32, 2 in bf16: off 16 bytes)."""
    flat = torch.zeros(t.numel() + elems, device=t.device, dtype=t.dtype)
    out = flat[elems:].view_as(t)
    out.copy_(t)
    assert out.data_ptr() % 16
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relpos_kernels_take_unaligned_inputs(dev, dtype):
    """K4 and K5 read q, k, v rows in 16-byte pieces: a view that starts 4
    bytes (bf16: 2) into its storage is copied by ``kernel_operand`` (one
    copy counted each), the kernel launches, and the result equals the
    aligned input's bit for bit."""
    q, k, v, bhw = _relpos_inputs(dev, 2, 14, 14, 64, dtype, 1.0, 16)
    shifted = _shifted(q)
    want_g = relpos_attention_global(q, k, v, bhw, 14, 14)
    want_w = relpos_attention_windowed(q, k, v, bhw, 14, 14, 2, False)
    copies = kernel_operand.copies
    launches = (relpos_attention_global.launches,
                relpos_attention_windowed.launches)
    got_g = relpos_attention_global(shifted, k, v, bhw, 14, 14)
    got_w = relpos_attention_windowed(q, _shifted(k), v, bhw, 14, 14, 2, False)
    torch.cuda.synchronize()
    assert (relpos_attention_global.launches,
            relpos_attention_windowed.launches) == (launches[0] + 1,
                                                    launches[1] + 1)
    assert kernel_operand.copies == copies + 2
    torch.testing.assert_close(got_g, want_g, atol=0, rtol=0)
    torch.testing.assert_close(got_w, want_w, atol=0, rtol=0)


def test_relpos_qkv_f32_kernel_takes_unaligned_input(dev):
    """Float32 K7 reads q, k, v rows of its qkv in 16-byte pieces: a qkv
    view that starts 4 bytes into its storage is copied by the wrapper and
    the kernel launches, equal to the aligned input's result; the C entry
    point, which the C++ serving library calls without the wrapper, still
    returns an error instead of reading it."""
    gen = torch.Generator(device=dev).manual_seed(19)
    W, heads, hd, g = 2, 2, 64, 14
    n = g * g
    flat = torch.randn(W * 3 * heads * n * hd + 1, generator=gen, device=dev)
    qkv = flat[1:].view(W, 3, heads, n, hd)
    bhw = torch.randn((W * heads, n, 2 * g), generator=gen, device=dev)
    before = relpos_attention_qkv.launches
    got = relpos_attention_qkv(qkv, bhw, g, g)
    want = relpos_attention_qkv(qkv.clone(), bhw, g, g)
    torch.cuda.synchronize()
    assert relpos_attention_qkv.launches == before + 2
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    out = torch.empty((W, heads, n, hd), device=dev)
    assert LIBRARY.get().dlimg_relpos_attention_qkv(
        qkv.data_ptr(), bhw.data_ptr(), out.data_ptr(), W, heads, n, hd, g, g,
        DTYPE_CODES["torch.float32"], hd ** -0.5,
        torch.cuda.current_stream().cuda_stream) != 0


def test_levit_and_window_strip_f32_kernels_take_unaligned_inputs(dev):
    """Float32 K2 and K6 read their operands in 16-byte pieces: on a view
    that starts 4 bytes into its storage the wrapper copies (K6: q, k and
    v made dense, token stride C) and the kernel launches, equal to the
    aligned input's result; the C entry points, which the C++ serving
    library calls without the wrappers, still return an error instead of
    reading it."""
    g = torch.Generator(device=dev).manual_seed(18)
    stream = torch.cuda.current_stream().cuda_stream
    G, N, nh = 2, 49, 2
    flat = torch.randn(G * N * nh * 96 + 1, generator=g, device=dev)
    qkv = flat[1:].view(G, N, nh * 96)
    bias = torch.randn((nh, N, N), generator=g, device=dev)
    before = levit_window_attention.launches
    got = levit_window_attention(qkv, bias, nh)
    want = levit_window_attention(qkv.clone(), bias, nh)
    torch.cuda.synchronize()
    assert levit_window_attention.launches == before + 2
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    out = torch.empty((G, N, nh * 32), device=dev)
    assert LIBRARY.get().dlimg_levit_attention(
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), G, N, nh, 32,
        DTYPE_CODES["torch.float32"], 32 ** -0.5, stream) != 0

    B, grid, heads, hd, ws = 1, 14, 2, 64, 14
    C = heads * hd
    flat = torch.randn(B * grid * grid * 3 * C + 1, generator=g, device=dev)
    qkv = flat[1:].view(B, grid, grid, 3 * C)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    rh, rw = (0.3 * torch.randn((ws, ws, hd), generator=g, device=dev)
              for _ in range(2))
    before = windowed_attention_fused.launches
    got = windowed_attention_fused(q, k, v, rh, rw, ws=ws, num_heads=heads)
    aligned = qkv.clone()
    want = windowed_attention_fused(aligned[..., :C], aligned[..., C:2 * C],
                                    aligned[..., 2 * C:], rh, rw, ws=ws,
                                    num_heads=heads)
    torch.cuda.synchronize()
    assert windowed_attention_fused.launches == before + 2
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    out = torch.empty((B, grid, grid, C), device=dev)
    assert LIBRARY.get().dlimg_window_strip_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(), rw.data_ptr(),
        out.data_ptr(), B, grid, grid, C, 3 * C, ws, heads, hd,
        DTYPE_CODES["torch.float32"], hd ** -0.5, stream) != 0


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
    """What no kernel takes raises on the card (no plain version there, no
    cast): float64. K2 at kd 16 and K4 / K5 / K7 / K6 at head widths 36
    (not a multiple of 8) and 136 (above 128), which raised before the
    general body, launch it and hold their plain versions."""
    g = torch.Generator(device=dev).manual_seed(39)
    qkv = torch.randn((2, 49, 4 * 3 * 16), generator=g, device=dev)  # kd 16
    lbias = 0.5 * torch.randn((4, 49, 49), generator=g, device=dev)
    _general_matches(levit_window_attention,
                     lambda: levit_window_attention(qkv, lbias, 4),
                     lambda: levit_window_attention_plain(qkv, lbias, 4))
    x = torch.zeros(4, 128, device=dev, dtype=torch.float64)
    with pytest.raises(DlimgError):
        fused_layer_norm(x, torch.ones(128, device=dev, dtype=torch.float64),
                         torch.zeros(128, device=dev, dtype=torch.float64))
    with pytest.raises(DlimgError):
        fused_add_layer_norm(x, x, torch.ones(128, device=dev, dtype=torch.float64),
                             torch.zeros(128, device=dev, dtype=torch.float64))
    with pytest.raises(DlimgError):
        quant.quantize_rows_int8(x)
    with pytest.raises(DlimgError):
        levit_window_attention(qkv.double(), lbias.double(), 4)
    for hd in (36, 136):
        q, k, v, bhw = _relpos_inputs(dev, 2, 7, 7, hd, torch.float32, 1.0, hd)
        _general_matches(relpos_attention_global,
                         lambda: relpos_attention_global(q, k, v, bhw, 7, 7),
                         lambda: attention_relpos_plain(q, k, v, bhw, 7, 7))
        _general_matches(relpos_attention_windowed,
                         lambda: relpos_attention_windowed(q, k, v, bhw, 7, 7,
                                                           2, True),
                         lambda: attention_relpos_plain(q, k, v, bhw, 7, 7,
                                                        folded=True, heads=2))
        qkv5 = torch.randn((1, 3, 2, 49, hd), generator=g, device=dev)
        _general_matches(relpos_attention_qkv,
                         lambda: relpos_attention_qkv(qkv5, bhw, 7, 7),
                         lambda: windowed_attention_qkv_plain(qkv5, bhw, 7, 7))
        x = torch.randn((1, 7, 7, 3 * 2 * hd), generator=g, device=dev)
        q6, k6, v6 = x[..., :2 * hd], x[..., 2 * hd:4 * hd], x[..., 4 * hd:]
        rh, rw = (0.3 * torch.randn((7, 7, hd), generator=g, device=dev)
                  for _ in range(2))
        _general_matches(windowed_attention_fused,
                         lambda: windowed_attention_fused(q6, k6, v6, rh, rw,
                                                          ws=7, num_heads=2),
                         lambda: windowed_attention_fused_plain(
                             q6, k6, v6, rh, rw, ws=7, num_heads=2))


# -- float16: every kernel the JAX functions run in float16 ---------------

def _f16(dev, shape, g, scale=1.0):
    return (scale * torch.randn(shape, generator=g, device=dev)).to(torch.float16)


def _f16_case(dev, case, g):
    """(wrapper, kernel call, plain call, compare) for one float16 case at
    a main path's shape (``F16_CASES``); compare returns the max |diff|."""
    diff = lambda a, b: (a.float() - b.float()).abs().max().item()  # noqa: E731
    kind, shape = case.split(" ", 1)
    dims = tuple(int(v) for v in shape.split("x"))
    if kind in ("K1", "K3"):
        rows, C = dims
        x, d = _f16(dev, (rows, C), g), _f16(dev, (rows, C), g)
        scale = (0.25 + 0.5 * torch.rand(C, generator=g, device=dev)).half()
        bias = (0.5 * torch.rand(C, generator=g, device=dev) - 0.25).half()
        if kind == "K1":
            return (fused_layer_norm, lambda: fused_layer_norm(x, scale, bias, 1e-6),
                    lambda: layer_norm_plain(x, scale, bias, 1e-6), diff)

        def add_diff(a, b):
            assert torch.equal(a[0], b[0])  # s = x + d rounded: bit for bit
            return diff(a[1], b[1])
        return (fused_add_layer_norm,
                lambda: fused_add_layer_norm(x, d, scale, bias, 1e-6),
                lambda: fused_add_layer_norm_plain(x, d, scale, bias, 1e-6), add_diff)
    if kind == "K2":
        G, N, nh = dims
        qkv, bias = _f16(dev, (G, N, nh * 96), g), _f16(dev, (nh, N, N), g, 0.5)
        return (levit_window_attention, lambda: levit_window_attention(qkv, bias, nh),
                lambda: levit_window_attention_plain(qkv, bias, nh), diff)
    if kind in ("K4", "K5"):
        G, side, hd = dims
        q, k, v = (_f16(dev, (G, side * side, hd), g) for _ in range(3))
        rh, rw = (_f16(dev, (side, side, hd), g, 0.3) for _ in range(2))
        if kind == "K4":
            bhw = _bias_halves(q, rh, rw, side, side)
            return (relpos_attention_global,
                    lambda: relpos_attention_global(q, k, v, bhw, side, side),
                    lambda: attention_relpos_plain(q, k, v, bhw, side, side), diff)
        heads = 12 if hd == 64 else 16
        bhw = _bias_halves(q, rh, rw, side, side, out_scale=hd ** 0.5)
        return (relpos_attention_windowed,
                lambda: relpos_attention_windowed(q, k, v, bhw, side, side, heads,
                                                  True, 5, 8),
                lambda: attention_relpos_plain(q, k, v, bhw, side, side, folded=True,
                                               heads=heads, n_w=5, valid_rows=8), diff)
    if kind == "K6":
        grid, heads, hd = dims
        C = heads * hd
        qkv = _f16(dev, (1, grid, grid, 3 * C), g)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        rh, rw = (_f16(dev, (14, 14, hd), g, 0.3) for _ in range(2))
        return (windowed_attention_fused,
                lambda: windowed_attention_fused(q, k, v, rh, rw, ws=14, num_heads=heads),
                lambda: windowed_attention_fused_plain(q, k, v, rh, rw, ws=14,
                                                       num_heads=heads), diff)
    if kind == "K7":
        W, nh, hd = dims
        qkv = _f16(dev, (W, 3, nh, 196, hd), g)
        bhw = _f16(dev, (W * nh, 196, 28), g)
        return (relpos_attention_qkv, lambda: relpos_attention_qkv(qkv, bhw, 14, 14),
                lambda: windowed_attention_qkv_plain(qkv, bhw, 14, 14), diff)
    if kind == "K8":
        table, layouts = probe_inputs(dev, torch.float16)
        idx = layouts["row-replicated" if dims == (0,) else "per-lane"]
        return (smem_gather, lambda: smem_gather(table, idx, 8),
                lambda: smem_gather_plain(table, idx, 8), diff)
    if kind == "P2":
        rows, C = dims
        x = _activations(dev, rows, C, torch.float16, C)

        def bits(a, b):
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            return 0.0
        return (quant.quantize_rows_int8, lambda: quant.quantize_rows_int8(x),
                lambda: quant.quantize_activations_int8(x), bits)
    rows, N = dims  # P3
    acc = torch.randint(-2**24, 2**24, (rows, N), generator=g, device=dev,
                        dtype=torch.int32)
    xs = torch.rand((rows, 1), generator=g, device=dev) * 1e-2
    ws = torch.rand((N,), generator=g, device=dev) * 1e-3
    b = _f16(dev, (N,), g)
    return (quant.int8_epilogue,
            lambda: quant.int8_epilogue(acc, xs, ws, b, torch.float16),
            lambda: quant.int8_epilogue_plain(acc, xs, ws, b, torch.float16),
            lambda a, c: 0.0 if torch.equal(a, c) else diff(a, c) + 1.0)


# Main paths' shapes: K1 MobileSAM's stage 1 and the ViT widths, K3 ViT-B
# and ViT-H, K2 MobileSAM's three, K4 (heads, 64 x 64 grid, hd) and K5 (25
# windows x heads, 14 x 14, hd) at ViT-B and ViT-H, K6 the fused ViT-B's
# and ViT-H's (1, 70, 70) grids, K7 ViT-B's and ViT-H's windows, K8 the
# probe's two index layouts (0 row-replicated, 1 per-lane), P2 / P3 at
# ViT-B's qkv and fc1 linears and odd widths.
F16_CASES = ["K1 17689x128", "K1 4096x768", "K1 1372x1280", "K3 4096x768",
             "K3 4096x1280", "K2 361x49x4", "K2 25x196x5", "K2 100x49x10",
             "K4 12x64x64", "K4 16x64x80", "K5 300x14x64", "K5 400x14x80",
             "K6 70x12x64", "K6 70x16x80", "K7 25x12x64", "K7 25x16x80",
             "K8 0", "K8 1", "P2 4096x768", "P2 4096x3072", "P2 37x100",
             "P3 4096x2304", "P3 4096x768", "P3 37x36"]


@pytest.mark.parametrize("case", F16_CASES)
def test_float16_kernel_matches_plain(dev, case):
    """Each kernel in float16 launches once (no plain path, no cast) and
    holds its plain version on the same inputs: K3's s, K8, P2 and P3 bit
    for bit, the others within TOL (K6 F16_STRIP_ATOL), the attention
    kernels' mean |diff| within F16_MEAN_ATOL."""
    g = torch.Generator(device=dev).manual_seed(len(case) * 7 + ord(case[1]))
    wrapper, kernel, plain, compare = _f16_case(dev, case, g)
    before = wrapper.launches
    got = kernel()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    out = got[0] if isinstance(got, tuple) else got
    assert out.dtype in (torch.float16, torch.float32, torch.int8)
    want = plain()
    err = compare(got, want)
    tol = {"K1": TOL[torch.float16][0], "K3": TOL[torch.float16][0],
           "K6": F16_STRIP_ATOL, "K8": 0.0}.get(case[:2], TOL[torch.float16][1])
    assert err <= (tol if case[0] == "K" else 0.0), (case, err)
    if case[:2] in ("K2", "K4", "K5", "K6", "K7"):
        mean = (got.float() - want.float()).abs().mean().item()
        assert mean <= F16_MEAN_ATOL, (case, mean)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("C,N", [(100, 36), (96, 98)])
def test_int8_linear_any_width_on_card(dev, C, N, dtype, monkeypatch):
    """An s8 x s8 linear whose in or out width is not a multiple of 8 runs
    P2, cuBLASLt's int8 product on the zero-padded operands and P3 (one
    launch each), its int32 product equal to the plain int32 product and
    its output to the CPU's bit for bit."""
    g = torch.Generator().manual_seed(C + N)
    w_q, w_scale = quant.quantize_weight(0.05 * torch.randn((C, N), generator=g))
    lin = QuantLinear(w_q, w_scale, 0.1 * torch.randn(N, generator=g),
                      act_int8=True)
    lin.b.data = lin.b.data.to(dtype)
    x = torch.randn((2, 77, C), generator=g).to(dtype)
    want = quant.int8_linear(lin, x)
    lin = lin.to(dev)
    products = []
    int_mm = torch._int_mm

    def counted(a, b):
        products.append((a.shape, b.shape))
        return int_mm(a, b)

    monkeypatch.setattr(torch, "_int_mm", counted)
    before = (quant.quantize_rows_int8.launches, quant.int8_epilogue.launches)
    got = quant.int8_linear(lin, x.to(dev))
    torch.cuda.synchronize()
    assert (quant.quantize_rows_int8.launches,
            quant.int8_epilogue.launches) == (before[0] + 1, before[1] + 1)
    assert products == [((154, -(-C // 8) * 8), (-(-C // 8) * 8, -(-N // 8) * 8))]
    assert got.shape == (2, 77, N) and torch.equal(got.cpu(), want)
    q, _ = quant.quantize_rows_int8(x.to(dev).reshape(-1, C))
    acc = quant.int8_mm(q, lin.w_q8_mm, N)
    assert torch.equal(acc.cpu(), q.cpu().int() @ w_q.int())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_layer_norm_takes_misaligned_inputs(dev, dtype):
    """K1 moves 16 bytes a lane: a contiguous view 8 bytes off a 16-byte
    boundary (x, then scale) is copied by the wrapper and the kernel
    launches, equal to the aligned input's result bit for bit; the C entry
    point, which the C++ serving library calls without the wrapper, still
    refuses it (cudaErrorInvalidValue) instead of faulting."""
    C, rows = 128, 4
    skip = 8 // torch.empty((), dtype=dtype).element_size()
    base = torch.randn(rows * C + 16, device=dev).to(dtype)
    x = base[skip:skip + rows * C].view(rows, C)
    assert x.is_contiguous() and x.data_ptr() % 16 == 8
    scale = torch.ones(C, device=dev, dtype=dtype)
    bias = torch.zeros(C, device=dev, dtype=dtype)
    before = fused_layer_norm.launches
    got = fused_layer_norm(x, scale, bias)
    got_scale = fused_layer_norm(base[:rows * C].view(rows, C),
                                 base[skip:skip + C], bias)
    torch.cuda.synchronize()
    assert fused_layer_norm.launches == before + 2
    torch.testing.assert_close(got, fused_layer_norm(x.clone(), scale, bias),
                               atol=0, rtol=0)
    torch.testing.assert_close(
        got_scale, fused_layer_norm(base[:rows * C].view(rows, C).clone(),
                                    base[skip:skip + C].clone(), bias),
        atol=0, rtol=0)
    out = torch.empty((rows, C), device=dev, dtype=dtype)
    rc = LIBRARY.get().dlimg_layer_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), rows,
        C, DTYPE_CODES[str(dtype)], 1e-6, torch.cuda.current_stream().cuda_stream)
    assert rc == 1  # cudaErrorInvalidValue
    aligned = base[2 * skip:2 * skip + rows * C].view(rows, C)
    assert aligned.data_ptr() % 16 == 0
    torch.testing.assert_close(fused_layer_norm(aligned, scale, bias).float(),
                               layer_norm_plain(aligned, scale, bias, 1e-6).float(),
                               atol=TOL[dtype][0], rtol=0)


# C10: K1 and K3 at widths without instances of their own: a masked last
# chunk (C 1, 3, 96, 200: lanes 4-32), rows too wide for a warp's registers
# (1536, 2050 in both dtypes, 4100), and 384 (float32 on 32 lanes, bf16 on
# 8), at row counts that fill no row group, the sp shards' 1372, and 4097.
ANY_WIDTHS = (1, 3, 96, 200, 384, 1536, 2050, 4100)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", ANY_WIDTHS)
@pytest.mark.parametrize("rows", [1, 7, 1372, 4097])
def test_layer_norm_kernels_any_width(dev, C, rows, dtype):
    """K1 and K3 against their plain versions on the CPU (the function the
    CPU tests hold against JAX): at C = 3 a row's one-pass variance can be
    ~1e-3 of its mean square, so the order of the 3-term sums (the CPU's and
    the kernel's are sequential; a CUDA reduction's need not be) moves the
    output by up to 6e-5. K3's s equals x + d bit for bit and its LN(s)
    equals K1 on that s bit for bit (one body)."""
    g = torch.Generator(device=dev).manual_seed(C + rows)
    x, d = (torch.randn((rows, C), generator=g, device=dev).to(dtype)
            for _ in range(2))
    scale = (0.25 + 0.5 * torch.rand(C, generator=g, device=dev)).to(dtype)
    bias = (0.5 * torch.rand(C, generator=g, device=dev) - 0.25).to(dtype)
    before = (fused_layer_norm.launches, fused_add_layer_norm.launches)
    y = fused_layer_norm(x, scale, bias, 1e-6)
    s, ys = fused_add_layer_norm(x, d, scale, bias, 1e-6)
    y_of_s = fused_layer_norm(s, scale, bias, 1e-6)
    torch.cuda.synchronize()
    assert (fused_layer_norm.launches,
            fused_add_layer_norm.launches) == (before[0] + 2, before[1] + 1)
    x, d, scale, bias = (t.cpu() for t in (x, d, scale, bias))
    torch.testing.assert_close(y.cpu().float(),
                               layer_norm_plain(x, scale, bias, 1e-6).float(),
                               atol=TOL[dtype][0], rtol=0)
    want_s, want_y = fused_add_layer_norm_plain(x, d, scale, bias, 1e-6)
    torch.testing.assert_close(s.cpu(), want_s, atol=0, rtol=0)
    torch.testing.assert_close(ys.cpu().float(), want_y.float(),
                               atol=TOL[dtype][0], rtol=0)
    torch.testing.assert_close(ys, y_of_s, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [96, 200, 768])
def test_layer_norm_kernels_take_any_view(dev, C, dtype):
    """A strided view (every other row) and a view off 16 bytes go through
    ``kernel_operand`` (a copy each), and K1 / K3 give what the dense
    aligned copies give, bit for bit."""
    g = torch.Generator(device=dev).manual_seed(C)
    big = torch.randn((2 * 37, C + 1), generator=g, device=dev).to(dtype)
    strided = big[::2, :C]
    assert not strided.is_contiguous()
    off = _shifted(torch.randn((37, C), generator=g, device=dev).to(dtype))
    scale = (0.25 + 0.5 * torch.rand(C, generator=g, device=dev)).to(dtype)
    bias = (0.5 * torch.rand(C, generator=g, device=dev) - 0.25).to(dtype)
    for x in (strided, off):
        copies = kernel_operand.copies
        y = fused_layer_norm(x, scale, bias)
        s, ys = fused_add_layer_norm(x, off, scale, bias)
        torch.cuda.synchronize()
        assert kernel_operand.copies > copies
        dense = x.contiguous().clone()
        torch.testing.assert_close(y, fused_layer_norm(dense, scale, bias),
                                   atol=0, rtol=0)
        want_s, want_y = fused_add_layer_norm(dense, off.clone(), scale, bias)
        torch.testing.assert_close(s, want_s, atol=0, rtol=0)
        torch.testing.assert_close(ys, want_y, atol=0, rtol=0)


# C11: every head width the kernels take other than 64 and 80 (the padded
# instances at 32, 96 and 128).
PAD_HEAD_DIMS = [hd for hd in range(8, 129, 8) if hd not in (64, 80)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", PAD_HEAD_DIMS)
def test_relpos_kernels_every_head_width(dev, hd, dtype):
    """K4 (a 20 x 20 grid, and a 64 x 64 one whose key tiles are grid
    rows), K5 (14 x 14 windows, the folded bias where hd + 28 <= 128, the
    pad-query skip; 16 x 16 windows, 256-key rows), K7 and K6 at head
    width hd, each against its plain version."""
    tol = TOL[dtype][1]
    for G, grid in ((2, 20), (1, 64)):
        q, k, v, bhw = _relpos_inputs(dev, G, grid, grid, hd, dtype, 1.0, hd)
        before = relpos_attention_global.launches
        got = relpos_attention_global(q, k, v, bhw, grid, grid)
        torch.cuda.synchronize()
        assert relpos_attention_global.launches == before + 1
        want = attention_relpos_plain(q, k, v, bhw, grid, grid)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    for W, heads, ws, n_w, valid_rows in ((4, 3, 14, 2, 5), (2, 2, 16, None, None)):
        folded = hd + 2 * ws <= 128
        q, k, v, bhw = _relpos_inputs(dev, W * heads, ws, ws, hd, dtype,
                                      1.0 / hd ** -0.5 if folded else 1.0, hd + 1)
        before = relpos_attention_windowed.launches
        got = relpos_attention_windowed(q, k, v, bhw, ws, ws, heads, folded,
                                        n_w, valid_rows)
        torch.cuda.synchronize()
        assert relpos_attention_windowed.launches == before + 1
        want = attention_relpos_plain(q, k, v, bhw, ws, ws, folded=folded,
                                      heads=heads, n_w=n_w,
                                      valid_rows=valid_rows)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
        if n_w:
            assert not got[-n_w * heads:, valid_rows * ws:].any()
    gen = torch.Generator(device=dev).manual_seed(hd + 2)
    W, heads, ws = 3, 2, 14
    qkv = torch.randn((W, 3, heads, ws * ws, hd), generator=gen, device=dev).to(dtype)
    bhw = torch.randn((W * heads, ws * ws, 2 * ws), generator=gen, device=dev).to(dtype)
    before = relpos_attention_qkv.launches
    got = relpos_attention_qkv(qkv, bhw, ws, ws)
    torch.cuda.synchronize()
    assert relpos_attention_qkv.launches == before + 1
    want = windowed_attention_qkv_plain(qkv, bhw, ws, ws)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    B, grid, heads, ws = 1, 28, 3, 14
    C = heads * hd
    qkv = torch.randn((B, grid, grid, 3 * C), generator=gen, device=dev).to(dtype)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    rh, rw = (0.3 * torch.randn((ws, ws, hd), generator=gen, device=dev)
              for _ in range(2))
    before = windowed_attention_fused.launches
    got = windowed_attention_fused(q, k, v, rh, rw, ws=ws, num_heads=heads)
    torch.cuda.synchronize()
    assert windowed_attention_fused.launches == before + 1
    want = windowed_attention_fused_plain(q, k, v, rh, rw, ws=ws,
                                          num_heads=heads)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)



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


# C13: the tuned bf16 K6 at the fused-window ViT-B's shape on the draw of
# seeds 0-63 (this file's K6 scheme: the qkv, then the tables, from one CUDA
# generator) whose |kernel - plain| was largest while the kernel rounded its
# float32 bias halves (tools/k6_draws.py on an H100: 0.0234 there, the
# kernel 1.42 bf16 steps at its window and head's largest output from the
# float64 evaluation, the plain version 0.63; JAX's float32 halves round as
# the kernel's did). The kernel must hold the plain version at the bf16
# atol and the float64 evaluations at its rounding points (the bias halves
# correctly rounded; also p, as JAX rounds it) within one bf16 step at each
# window and head's largest output.
K6_WORST_SEED = 21


def test_window_strip_kernel_worst_draw_within_a_step_of_float64(dev):
    B, grid, nh, hd, ws = k6_draws.SHAPE
    C = nh * hd
    qkv, rh, rw = k6_draws.draw(K6_WORST_SEED, torch.bfloat16, dev)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    before = windowed_attention_fused.launches
    got = windowed_attention_fused(q, k, v, rh, rw, ws=ws, num_heads=nh)
    torch.cuda.synchronize()
    assert windowed_attention_fused.launches == before + 1
    want = windowed_attention_fused_plain(q, k, v, rh, rw, ws=ws, num_heads=nh)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[torch.bfloat16][1],
                               rtol=0)
    exact, jax_points, _ = k6_draws.references(q, k, v, rh, rw, torch.bfloat16)
    for name, ref in (("float64", exact), ("JAX's rounding points", jax_points)):
        steps = (got.double() - ref).abs() / k6_draws.group_step(ref, torch.bfloat16)
        assert steps.max().item() <= 1.0, (name, steps.max().item())


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["slices", "contiguous"])
@pytest.mark.parametrize("hd", [64, 80])
def test_window_strip_kernel_large_tables(dev, hd, layout, dtype):
    """Rel-pos tables of scale ~3 on values whose bias sums are exact (see
    the module note): in bf16 the halves' rounding order decides, in
    float32 the order of the score's terms."""
    g = torch.Generator(device=dev).manual_seed(9)
    B, grid, heads, ws = 1, 42, 4, 14
    C = heads * hd

    def quarters(shape, std, limit):
        x = std * torch.randn(shape, generator=g, device=dev)
        return (torch.round(x * 4) / 4).clamp(-limit, limit)

    qkv = torch.randn((B, grid, grid, 3 * C), generator=g, device=dev)
    qkv[..., :C] = quarters((B, grid, grid, C), 1.0, 4.0)
    q, k, v = _strip_operands(qkv.to(dtype), layout)
    rh, rw = (quarters((ws, ws, hd), 3.0, 12.0).to(dtype) for _ in range(2))
    got = windowed_attention_fused(q, k, v, rh, rw, ws=ws, num_heads=heads)
    torch.cuda.synchronize()
    want = windowed_attention_fused_plain(q, k, v, rh, rw, ws=ws,
                                          num_heads=heads)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype][1],
                               rtol=0)


QKV_SHAPES = [(25, 12, 64, 14), (25, 16, 80, 14), (3, 2, 64, 5),
              (2, 3, 80, 14)]


# Float32 also at a 17 x 17 window (289 keys), which takes K4's body; the
# bf16 kernel refuses windows with a side above 16.
@pytest.mark.parametrize("dtype,W,heads,hd,g", [
    (dtype, *shape) for dtype in (torch.float32, torch.bfloat16)
    for shape in QKV_SHAPES] + [(torch.float32, 2, 3, 64, 17)])
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
    """K6 at head width 36, K7 at 136 and bf16 8 x 32 windows on the
    low-level K5 / K7 wrappers (a side above the tuned body's 16; the
    routers send them to K4), which raised before the general body, launch
    it and hold their plain versions; a gather table no slab holds raises."""
    g = torch.Generator(device=dev).manual_seed(40)
    x = torch.randn((1, 28, 28, 3 * 72), generator=g, device=dev)  # hd 36
    q, k, v = x[..., :72], x[..., 72:144], x[..., 144:]
    rh = 0.3 * torch.randn((14, 14, 36), generator=g, device=dev)
    _general_matches(windowed_attention_fused,
                     lambda: windowed_attention_fused(q, k, v, rh, rh, ws=14,
                                                      num_heads=2),
                     lambda: windowed_attention_fused_plain(q, k, v, rh, rh,
                                                            ws=14, num_heads=2))
    qkv = torch.randn((2, 3, 2, 49, 136), generator=g, device=dev)  # hd 136
    bhw = torch.randn((4, 49, 14), generator=g, device=dev)
    _general_matches(relpos_attention_qkv,
                     lambda: relpos_attention_qkv(qkv, bhw, 7, 7),
                     lambda: windowed_attention_qkv_plain(qkv, bhw, 7, 7))
    qkv = torch.randn((2, 3, 2, 8 * 32, 64), generator=g,
                      device=dev).to(torch.bfloat16)
    bhw = torch.randn((4, 8 * 32, 40), generator=g, device=dev).to(torch.bfloat16)
    _general_matches(relpos_attention_qkv,
                     lambda: relpos_attention_qkv(qkv, bhw, 8, 32),
                     lambda: windowed_attention_qkv_plain(qkv, bhw, 8, 32))
    q = qkv[:, 0].reshape(4, 8 * 32, 64)
    _general_matches(relpos_attention_windowed,
                     lambda: relpos_attention_windowed(q, q, q, bhw, 8, 32, 2,
                                                       False),
                     lambda: attention_relpos_plain(q, q, q, bhw, 8, 32, heads=2))
    table = torch.zeros(8000, 16, device=dev)  # 8000 rows: no slab fits
    with pytest.raises(DlimgError):
        smem_gather(table, torch.zeros(8000, 16, dtype=torch.int32,
                                       device=dev), 2)


# -- the general attention body (csrc/attention_general.cuh) ----------------

def _general_matches(wrapper, kernel, plain, general=True, strip=False):
    """One launch of ``wrapper``'s kernel (and of its general body when
    ``general``), held against the plain version on the same inputs at
    the output dtype's tolerance (float16: K6 F16_STRIP_ATOL, and the mean
    |diff| within F16_MEAN_ATOL)."""
    before = (wrapper.launches, wrapper.general_launches)
    got = kernel()
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.general_launches) == (
        before[0] + 1, before[1] + int(general))
    want = plain()
    tol = F16_STRIP_ATOL if strip and got.dtype == torch.float16 else TOL[got.dtype][1]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    if got.dtype == torch.float16:
        assert (got.float() - want.float()).abs().mean().item() <= F16_MEAN_ATOL
    return got


def _general_case(dev, case, dtype, seed):
    """(wrapper, kernel call, plain call, K6) for one GENERAL_CASES entry."""
    kind, dims = case.split(" ", 1)
    d = [int(t) for t in dims.split("x")]
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    if kind == "K2":
        kd, N, G, nh = d
        qkv, bias = randn(G, N, nh * 3 * kd), randn(nh, N, N, scale=0.5)
        return (levit_window_attention, lambda: levit_window_attention(qkv, bias, nh),
                lambda: levit_window_attention_plain(qkv, bias, nh), False)
    if kind == "K4":
        G, gh, gw, hd = d
        q, k, v, bhw = _relpos_inputs(dev, G, gh, gw, hd, dtype, 1.0, seed)
        return (relpos_attention_global,
                lambda: relpos_attention_global(q, k, v, bhw, gh, gw),
                lambda: attention_relpos_plain(q, k, v, bhw, gh, gw), False)
    if kind == "K5":
        W, heads, gh, gw, hd, n_w, valid = d
        folded = hd + gh + gw <= 128
        q, k, v, bhw = _relpos_inputs(dev, W * heads, gh, gw, hd, dtype,
                                      1.0 / hd ** -0.5 if folded else 1.0, seed)
        return (relpos_attention_windowed,
                lambda: relpos_attention_windowed(q, k, v, bhw, gh, gw, heads,
                                                  folded, n_w, valid),
                lambda: attention_relpos_plain(q, k, v, bhw, gh, gw, folded=folded,
                                               heads=heads, n_w=n_w,
                                               valid_rows=valid), False)
    if kind == "K7":
        W, nh, gh, gw, hd = d
        qkv = randn(W, 3, nh, gh * gw, hd)
        bhw = _bias_halves(qkv[:, 0].reshape(W * nh, gh * gw, hd),
                           0.3 * torch.randn((gh, gh, hd), generator=g, device=dev),
                           0.3 * torch.randn((gw, gw, hd), generator=g, device=dev),
                           gh, gw)
        return (relpos_attention_qkv, lambda: relpos_attention_qkv(qkv, bhw, gh, gw),
                lambda: windowed_attention_qkv_plain(qkv, bhw, gh, gw), False)
    B, Hp, Wp, heads, hd, ws = d  # K6: q, k, v the slices of one qkv
    C = heads * hd
    qkv = randn(B, Hp, Wp, 3 * C)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    rh, rw = (0.3 * torch.randn((ws, ws, hd), generator=g, device=dev)
              for _ in range(2))
    return (windowed_attention_fused,
            lambda: windowed_attention_fused(q, k, v, rh, rw, ws=ws, num_heads=heads),
            lambda: windowed_attention_fused_plain(q, k, v, rh, rw, ws=ws,
                                                   num_heads=heads), True)


# The geometries the tuned instances do not take: K2 "kd x N x G x nh"; K4
# "G x gh x gw x hd"; K5 "W x heads x gh x gw x hd x n_w x valid_rows"
# (folded where hd + gh + gw <= 128); K7 "W x nh x gh x gw x hd"; K6
# "B x Hp x Wp x heads x hd x ws". Head widths 1-256 (not multiples of 8,
# or above 128), K2 at kd 8-48 and windows of 257-1024 tokens, K6 windows
# of 225-1024 tokens, bf16 and float16 K5 / K7 windows of 8 x 32 (float32
# takes those tuned). The key pipeline's edges (64-key chunks; 32 where a
# 16-bit head is wider than 128 or a float32 one wider than 64): one token;
# a single chunk, whole (64) or ragged (33); a ragged last chunk (65); 16
# bits' score path at its largest group (256 tokens) and two passes at the
# smallest beyond it (257), also at hd 136; odd head widths (2-byte loads:
# hd 1, 9, kd 33); hd 300 (16 bits: two depth pieces and two column parts);
# K4's halves read in place (a 1 x 400 grid: 401 a row); a K5 block whose
# rows are all skipped (10 x 10 windows keeping 20 rows).
GENERAL_HEAD_DIMS = (1, 4, 12, 36, 100, 136, 200, 256)
GENERAL_CASES = (
    [f"K2 {kd}x{N}x2x2" for kd in (8, 12, 48) for N in (49, 576)]
    + ["K2 32x257x2x3", "K2 32x1024x2x5", "K2 48x256x2x2", "K2 48x257x2x2",
       "K2 33x70x2x2", "K2 12x1x3x2"]
    + [f"K4 2x10x12x{hd}" for hd in GENERAL_HEAD_DIMS] + ["K4 1x64x64x36"]
    + ["K4 1x1x1x36", "K4 1x8x8x36", "K4 1x1x33x36", "K4 1x1x65x36",
       "K4 1x16x16x36", "K4 1x1x257x36", "K4 1x16x16x136", "K4 1x1x257x136",
       "K4 1x5x7x300", "K4 1x1x400x12"]
    + [f"K5 3x2x7x7x{hd}x1x4" for hd in GENERAL_HEAD_DIMS]
    + ["K5 2x2x2x128x36x1x1", "K5 3x2x8x32x64x1x5", "K5 3x2x10x10x20x1x2"]
    + [f"K7 3x2x7x7x{hd}" for hd in GENERAL_HEAD_DIMS] + ["K7 2x2x8x32x64"]
    + [f"K6 1x{ws}x{2 * ws}x2x{hd}x{ws}" for ws in (15, 16, 24) for hd in (36, 64)]
    + [f"K6 1x14x14x2x{hd}x7" for hd in GENERAL_HEAD_DIMS] + ["K6 1x32x32x2x64x32"]
    + ["K6 1x16x16x1x9x16", "K6 1x17x17x1x64x17"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", GENERAL_CASES)
def test_general_body_matches_plain(dev, case, dtype):
    """Each geometry launches the general body once (float32's 8 x 32 K5 /
    K7 windows: the tuned body) and holds the plain version."""
    wrapper, kernel, plain, strip = _general_case(dev, case, dtype,
                                                  len(case) + ord(case[1]))
    general = not (dtype == torch.float32 and "8x32" in case)
    _general_matches(wrapper, kernel, plain, general=general, strip=strip)


# (wrapper, tuned head width, general head width): G = 70000 groups, more
# than a tuned K4 / K5 / K7 grid's 65535 (the entry point splits the
# launch; K7 by whole windows) and K6 windows likewise.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("body", ["tuned", "general"])
@pytest.mark.parametrize("kind", ["K4", "K5", "K7", "K6"])
def test_more_than_65535_groups(dev, kind, body, dtype):
    hd = 64 if body == "tuned" else 36
    if kind == "K4":
        case = f"K4 70000x2x2x{hd}"
    elif kind == "K5":  # the skip's first group, 69998, lies in the second launch
        case = f"K5 35000x2x2x2x{hd}x1x1"
    elif kind == "K7":
        case = f"K7 35000x2x2x2x{hd}"
    else:
        case = f"K6 1x2x140000x1x{hd // 8 if body == 'tuned' else 4}x2"
    wrapper, kernel, plain, strip = _general_case(dev, case, dtype, 70)
    got = _general_matches(wrapper, kernel, plain, general=body == "general",
                           strip=strip)
    if kind == "K5":
        assert not got[-2:, 2:].any()


# The main paths' shapes (chip_smoke.py phases 2 and 4): K2 at MobileSAM's,
# K4 / K5 / K7 / K6 at ViT-B's and ViT-H's.
MAIN_PATH_CASES = ["K2 32x49x361x4", "K2 32x196x25x5", "K2 32x49x100x10",
                   "K4 12x64x64x64", "K4 16x64x64x80",
                   "K5 25x12x14x14x64x5x8", "K5 25x16x14x14x80x5x8",
                   "K7 25x12x14x14x64", "K7 25x16x14x14x80",
                   "K6 1x70x70x12x64x14", "K6 1x70x70x16x80x14"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_main_path_shapes_never_reach_the_general_body(dev, dtype):
    """Every main path's shape launches its tuned instance once and the
    general body never (the tuned values are held by the tests above and
    chip_smoke.py phase 2), and the C entry points' rule
    (``dlimg_attention_route``) agrees with ``attention_body`` over a sweep
    of kernels, head widths, windows and grids."""
    for case in MAIN_PATH_CASES:
        wrapper, kernel, _, _ = _general_case(dev, case, dtype, 3)
        before = (wrapper.launches, wrapper.general_launches)
        out = kernel()
        torch.cuda.synchronize()
        assert (wrapper.launches, wrapper.general_launches) == (
            before[0] + 1, before[1]), case
        assert bool(torch.isfinite(out).all()), case
    code = DTYPE_CODES[str(dtype)]
    route = LIBRARY.get().dlimg_attention_route
    for i, name in enumerate(ATTENTION_KERNELS):
        for hd in (1, 4, 8, 12, 32, 36, 64, 80, 100, 128, 136, 256):
            for n, gh, gw in ((49, 7, 7), (196, 14, 14), (225, 15, 15),
                              (256, 16, 16), (256, 8, 32), (576, 24, 24),
                              (1024, 32, 32), (4096, 64, 64)):
                for heads in (2, 70000):
                    want = attention_body(name, dtype, hd, n, gh, gw, heads)
                    assert route(i, code, hd, n, gh, gw, heads) == (
                        want == "general"), (name, hd, n, gh, gw, heads)


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
    # A view off 16 bytes is no refusal: the wrapper copies it
    # (kernel_operand) and the kernel keeps what it keeps on a dense copy.
    thresh = torch.tensor([0.5], device=dev)
    shifted = boxes.view(-1)[1:-3].reshape(-1, 4)
    assert shifted.data_ptr() % 16
    torch.testing.assert_close(
        greedy_nms(shifted, scores[1:], thresh),
        greedy_nms(shifted.clone(), scores[1:].clone(), thresh), atol=0, rtol=0)


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
    # Any width: a width without an instance of its own launches P2's
    # width-generic body, and an int8 product at K = 324 (not a multiple
    # of 8) pads with zeros, exact.
    before = quant.quantize_rows_int8.launches
    quant.quantize_rows_int8(torch.randn((40, 96), device=dev))
    assert quant.quantize_rows_int8.launches == before + 1
    gen = torch.Generator().manual_seed(1)
    q = torch.randint(-127, 128, (32, 324), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (324, 960), generator=gen, dtype=torch.int8)
    assert torch.equal(
        quant.int8_mm(q.to(dev), quant.pad_int8_weight(w.to(dev)), 960).cpu(),
        torch._int_mm(q, w))
    # Fewer than 17 rows are padded for cuBLASLt and sliced back: exact.
    gen = torch.Generator().manual_seed(0)
    for M in (1, 4, 16):
        q = torch.randint(-127, 128, (M, 320), generator=gen, dtype=torch.int8)
        w = torch.randint(-127, 128, (320, 960), generator=gen,
                          dtype=torch.int8)
        got = quant.int8_mm(q.to(dev), w.to(dev).t().contiguous().t(), 960)
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
