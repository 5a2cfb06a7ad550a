"""The port's last three kernel modules against the JAX package, on the CPU,
all inputs from numpy seeds:

  * K6 ``windowed_attention_fused`` (its plain version on CPU tensors)
    against JAX ``windowed_attention_fused(..., interpret=True)`` at ws 4 on
    a (2, 8, 12) padded grid, with 2 heads of 16 and 4 heads of 64 (JAX's
    ``_head_group`` then splits the channels into two strips), and at SAM's
    own window, one 14 x 14 window with 1 or 2 heads of 64 (the window the
    bf16 kernel tiles by 16-row stripes), and at the head widths of the
    card's padded instances (8-128, ws 4); q, k and v passed as the channel
    slices of one qkv tensor;
  * K7 ``windowed_attention_qkv`` against JAX ``windowed_attention_qkv(...,
    interpret=True)`` at the shapes of JAX's
    ``test_combined_qkv_kernel_matches_dense``, at a 14 x 14 window of
    2 heads of 64, and at the padded instances' head widths;
  * K8 ``smem_gather`` (the gather probe) against a numpy transcription of
    tools/probe_vmem_gather.py ``gather_kernel`` (the JAX tool has no
    interpret switch), bit for bit: both sum in the same order.

Tolerances: float32 atol 2e-5, the summation-order noise of the float32
reductions. bfloat16: within one bf16 step at the output's largest
magnitude (the bias halves and p are rounded to bf16 at the same places on
both sides; a different float32 summation order can move a rounding by
one step).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlimgedit_tpu.ops.flash_attention import (
    windowed_attention_fused as jax_windowed_attention_fused,
)
from dlimgedit_tpu.ops.flash_attention import (
    windowed_attention_qkv as jax_windowed_attention_qkv,
)
from dlimgedit_tpu_torch.errors import DlimgError
from dlimgedit_tpu_torch.ops.flash_attention import (
    _bias_halves,
    attention_reference,
    relpos_attention_qkv,
    windowed_attention_fused,
    windowed_attention_fused_plain,
    windowed_attention_qkv,
    windowed_attention_qkv_plain,
)
from dlimgedit_tpu_torch.tools.probe_smem_gather import (
    probe_inputs,
    smem_gather,
    smem_gather_plain,
)

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _atol(want: np.ndarray, dtype: str) -> float:
    if dtype == "float32":
        return 2e-5
    # One bf16 step (8 significant bits) at the largest magnitude.
    return float(2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7))


# (B, Hp, Wp, heads, hd, ws)
STRIP_CASES = {"2x16": (2, 8, 12, 2, 16, 4),
               "4x64_two_strips": (2, 8, 12, 4, 64, 4),
               "1x64_ws14": (1, 14, 14, 1, 64, 14),
               "2x64_ws14": (1, 14, 14, 2, 64, 14)}
# Head widths other than the ViTs' 64 and 80, which the card runs on the
# padded instances (32, 96 and 128) of K6 and K7.
PAD_HEAD_DIMS = (8, 16, 32, 48, 96, 128)
STRIP_CASES.update({f"2x{hd}_pad": (1, 8, 8, 2, hd, 4) for hd in PAD_HEAD_DIMS
                    if hd != 16})


def _strip_inputs(B, Hp, Wp, heads, hd, ws, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, Hp, Wp, 3 * heads * hd)).astype(np.float32)
    rh = (0.3 * rng.standard_normal((ws, ws, hd))).astype(np.float32)
    rw = (0.3 * rng.standard_normal((ws, ws, hd))).astype(np.float32)
    return qkv, rh, rw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(STRIP_CASES))
def test_windowed_attention_fused_matches_pallas(case, dtype):
    B, Hp, Wp, heads, hd, ws = STRIP_CASES[case]
    C = heads * hd
    qkv, rh, rw = _strip_inputs(B, Hp, Wp, heads, hd, ws, seed=hd)
    (jqkv, tqkv), (jrh, trh), (jrw, trw) = (_pair(a, dtype)
                                            for a in (qkv, rh, rw))
    want = jax_windowed_attention_fused(
        jqkv[..., :C], jqkv[..., C:2 * C], jqkv[..., 2 * C:], jrh, jrw,
        ws=ws, num_heads=heads, interpret=True)
    launches = windowed_attention_fused.launches
    got = windowed_attention_fused(tqkv[..., :C], tqkv[..., C:2 * C],
                                   tqkv[..., 2 * C:], trh, trw, ws=ws,
                                   num_heads=heads)
    assert windowed_attention_fused.launches == launches  # CPU: plain version
    assert got.dtype == tqkv.dtype and got.shape == (B, Hp, Wp, C)
    np.testing.assert_allclose(_f32(got), _f32(want),
                               atol=_atol(_f32(want), dtype), rtol=0)


def test_windowed_attention_fused_plain_matches_dense_reference():
    """Per window and head, the strip's plain version is the dense rel-pos
    attention of that window (float32)."""
    B, Hp, Wp, heads, hd, ws = STRIP_CASES["2x16"]
    C = heads * hd
    qkv, rh, rw = (torch.from_numpy(a) for a in
                   _strip_inputs(B, Hp, Wp, heads, hd, ws, seed=9))
    got = windowed_attention_fused_plain(qkv[..., :C], qkv[..., C:2 * C],
                                         qkv[..., 2 * C:], rh, rw, ws=ws,
                                         num_heads=heads)
    for b, wy, wx, h in ((0, 0, 0, 0), (1, 1, 2, 1), (1, 0, 1, 0)):
        win = qkv[b, wy * ws:(wy + 1) * ws, wx * ws:(wx + 1) * ws]
        q, k, v = (win[..., c * C + h * hd:c * C + (h + 1) * hd]
                   .reshape(1, ws * ws, hd) for c in range(3))
        want = attention_reference(q, k, v, rh, rw, ws, ws)[0]
        torch.testing.assert_close(
            got[b, wy * ws:(wy + 1) * ws, wx * ws:(wx + 1) * ws,
                h * hd:(h + 1) * hd].reshape(ws * ws, hd),
            want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("case", ["grid", "heads", "table", "strides",
                                  "shapes"])
def test_windowed_attention_fused_rejects_bad_operands(case):
    """Shapes that do not fit are refused. Strides are not a shape: q, k, v
    with different strides (case "strides") are taken as JAX takes any
    array, and give what the same values give contiguous."""
    B, Hp, Wp, heads, hd, ws = 1, 8, 8, 2, 16, 4
    C = heads * hd
    rng = np.random.default_rng(11)
    qkv = torch.from_numpy(rng.standard_normal((B, Hp, Wp, 3 * C),
                                               dtype=np.float32))
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    rh = rw = torch.from_numpy(rng.standard_normal((ws, ws, hd),
                                                   dtype=np.float32))
    if case == "grid":
        ws = 3
        rh = rw = torch.zeros(ws, ws, hd)
    elif case == "heads":
        heads = 3
    elif case == "table":
        rw = torch.zeros(2 * ws - 1, hd)  # raw, not gathered
    elif case == "strides":
        k = k.contiguous()  # q, v keep the qkv slices' strides
        got = windowed_attention_fused(q, k, v, rh, rw, ws=ws, num_heads=heads)
        want = windowed_attention_fused(q.contiguous(), k, v.contiguous(), rh,
                                        rw, ws=ws, num_heads=heads)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
        return
    else:
        v = v[:, :, :4]
    with pytest.raises(DlimgError):
        windowed_attention_fused(q, k, v, rh, rw, ws=ws, num_heads=heads)


def test_windowed_attention_fused_takes_transposed_views_only_as_slices():
    """A permuted view (channel stride != 1) is taken, as any view: on the
    card the wrapper makes q, k, v dense (the kernel reads in place only
    slices with unit channel stride), and the result equals that of the
    same data made contiguous."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((1, 16, 8, 8), dtype=np.float32)
                         ).permute(0, 2, 3, 1)  # (1, 8, 8, 16)
    rh = torch.from_numpy(rng.standard_normal((4, 4, 8), dtype=np.float32))
    out = windowed_attention_fused(x, x, x, rh, rh, ws=4, num_heads=2)
    y = x.contiguous()
    want = windowed_attention_fused(y, y, y, rh, rh, ws=4, num_heads=2)
    assert out.shape == (1, 8, 8, 16)
    torch.testing.assert_close(out, want, atol=0, rtol=0)


def _check_qkv_against_pallas(windows, gh, gw, hd, heads, dtype, seed):
    N = gh * gw
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((windows, 3, heads, N, hd)).astype(np.float32)
    rh = (0.3 * rng.standard_normal((gh, gh, hd))).astype(np.float32)
    rw = (0.3 * rng.standard_normal((gw, gw, hd))).astype(np.float32)
    (jqkv, tqkv), (jrh, trh), (jrw, trw) = (_pair(a, dtype)
                                            for a in (qkv, rh, rw))
    want = jax_windowed_attention_qkv(jqkv, jrh, jrw, grid_h=gh, grid_w=gw,
                                      interpret=True)
    launches = relpos_attention_qkv.launches
    got = windowed_attention_qkv(tqkv, trh, trw, grid_h=gh, grid_w=gw)
    assert relpos_attention_qkv.launches == launches
    assert got.dtype == tqkv.dtype and got.shape == (windows, heads, N, hd)
    np.testing.assert_allclose(_f32(got), _f32(want),
                               atol=_atol(_f32(want), dtype), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_attention_qkv_matches_pallas(dtype):
    _check_qkv_against_pallas(3, 5, 5, 16, 2, dtype, seed=7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", PAD_HEAD_DIMS)
def test_windowed_attention_qkv_head_widths_match_pallas(hd, dtype):
    """K7 at the head widths of the padded instances: 2 windows of 5 x 5,
    2 heads."""
    _check_qkv_against_pallas(2, 5, 5, hd, 2, dtype, seed=hd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_attention_qkv_matches_pallas_at_sam_window(dtype):
    """SAM's 14 x 14 window, 2 heads of 64."""
    _check_qkv_against_pallas(1, 14, 14, 64, 2, dtype, seed=10)


def test_windowed_attention_qkv_takes_raw_tables_and_checks_bias():
    """Raw (2g-1, hd) tables are gathered as JAX does; a bias of the wrong
    shape is refused."""
    windows, g, hd, heads = 2, 4, 16, 2
    rng = np.random.default_rng(8)
    qkv = torch.from_numpy(rng.standard_normal(
        (windows, 3, heads, g * g, hd)).astype(np.float32))
    raw = torch.from_numpy((0.3 * rng.standard_normal((2 * g - 1, hd))
                            ).astype(np.float32))
    idx = torch.arange(g)[:, None] - torch.arange(g)[None, :] + g - 1
    got = windowed_attention_qkv(qkv, raw, raw, grid_h=g, grid_w=g)
    q = qkv[:, 0].reshape(windows * heads, g * g, hd)
    bhw = _bias_halves(q, raw[idx], raw[idx], g, g)
    torch.testing.assert_close(
        got, windowed_attention_qkv_plain(qkv, bhw, g, g), atol=0, rtol=0)
    with pytest.raises(DlimgError):
        relpos_attention_qkv(qkv, bhw[:, :, :g], g, g)


def _numpy_gather_kernel(table: np.ndarray, idx: np.ndarray,
                         reps: int) -> np.ndarray:
    """tools/probe_vmem_gather.py gather_kernel, in numpy: the fori_loop
    adds take_along_axis(table, rem(idx + i, n), axis=0) as float32 to a
    zero accumulator, i = 0 .. reps - 1."""
    n = table.shape[0]
    acc = np.zeros(table.shape, np.float32)
    for i in range(reps):
        acc = acc + np.take_along_axis(table, np.remainder(idx + i, n),
                                       axis=0).astype(np.float32)
    return acc


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("layout", ["row-replicated", "per-lane"])
def test_smem_gather_matches_the_tpu_probe(layout, dtype):
    """At the probe's own shapes (4096 x 128) and reps 8 and 16."""
    table, layouts = probe_inputs(torch.device("cpu"), DTYPES[dtype][1])
    idx = layouts[layout]
    table_np = table.float().numpy()  # bf16 values are exact in float32
    launches = smem_gather.launches
    for reps in (8, 16):
        got = smem_gather(table, idx, reps)
        want = _numpy_gather_kernel(table_np, idx.numpy(), reps)
        np.testing.assert_array_equal(got.numpy(), want)
    assert smem_gather.launches == launches
    if layout == "row-replicated":
        assert bool((idx == idx[:, :1]).all())


def test_smem_gather_wraps_and_refuses_bad_indices():
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.standard_normal((6, 3)).astype(np.float32))
    idx = torch.tensor([[5, 4, 0]] * 6, dtype=torch.int32)
    got = smem_gather_plain(table, idx, 3)
    want = _numpy_gather_kernel(table.numpy(), idx.numpy(), 3)
    np.testing.assert_array_equal(got.numpy(), want)
    torch.testing.assert_close(got[0], torch.stack([
        table[5, 0] + table[0, 0] + table[1, 0],
        table[4, 1] + table[5, 1] + table[0, 1],
        table[0, 2] + table[1, 2] + table[2, 2]]), atol=0, rtol=0)
    with pytest.raises(DlimgError):
        smem_gather(table, idx.long(), 3)
    with pytest.raises(DlimgError):
        smem_gather(table, idx[:, :2], 3)
