"""The port's SAM ViT kernel modules against the JAX package's Pallas
kernels, run in interpret mode on the CPU: K1 at the ViT widths, K3
(residual add + LayerNorm, also at widths without a card instance of their
own), and the rel-pos attention router (also at head widths 8-128)
``flash_attention_relpos`` with its two kernels' plain versions (K5:
windowed, folded and unfolded bias, pad-query skip; K4: grouped, at N = 400
and N = 1024, the two JAX query blockings). On CPU tensors the wrappers
compute their plain versions; the CUDA kernels are held against those on
the card (tests/test_torch_cuda.py, chip_smoke.py). A bf16 window with a
side above 16 (8 x 32 here) is routed to K4 where JAX takes its windowed
kernel; ``test_relpos_route`` holds that decision.

Tolerances: float32 atol 1e-5 (LayerNorm) and 2e-5 (attention), the
summation-order noise of float32 reductions; bfloat16 atol 2e-2, a bit more
than one bf16 rounding step of the outputs (inputs are made from one seed
with numpy and rounded to bf16 identically on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlimgedit_tpu.ops.flash_attention import (
    attention_reference as jax_attention_reference,
)
from dlimgedit_tpu.ops.flash_attention import (
    flash_attention_relpos as jax_flash_attention_relpos,
)
from dlimgedit_tpu.ops.fused_norm import (
    fused_add_layer_norm as jax_fused_add_layer_norm,
)
from dlimgedit_tpu.ops.fused_norm import fused_layer_norm as jax_fused_layer_norm
from dlimgedit_tpu_torch.errors import DlimgError
from dlimgedit_tpu_torch.ops.flash_attention import (
    _bias_halves,
    _gathered_tables,
    attention_reference,
    attention_relpos_plain,
    flash_attention_relpos,
    relpos_attention_global,
    relpos_attention_windowed,
    relpos_route,
)
from dlimgedit_tpu_torch.ops.fused_norm import (
    fused_add_layer_norm,
    fused_add_layer_norm_plain,
    fused_layer_norm,
    layer_norm_plain,
)

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LN_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
ATTN_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _ln_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    d = rng.standard_normal(shape).astype(np.float32)
    scale = rng.uniform(0.25, 0.75, C).astype(np.float32)
    bias = rng.uniform(-0.25, 0.25, C).astype(np.float32)
    return x, d, scale, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [768, 1024, 1280])
def test_fused_layer_norm_vit_widths_match_pallas(C, dtype):
    x, _, scale, bias = _ln_inputs((2, 5, C), 0)
    (jx, tx), (js, ts), (jb, tb) = (_pair(a, dtype) for a in (x, scale, bias))
    want = jax_fused_layer_norm(jx, js, jb, eps=1e-6, interpret=True)
    launches = fused_layer_norm.launches
    got = fused_layer_norm(tx, ts, tb, eps=1e-6)
    assert fused_layer_norm.launches == launches  # CPU: the plain version
    np.testing.assert_allclose(_f32(got), _f32(want), atol=LN_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 4, 6, 768), (37, 1024), (3, 5, 1280)] + [
    # widths the width-generic bodies take on the card, at ragged row counts
    (rows, C) for C in (1, 3, 96, 200, 384, 1536, 2050) for rows in (1, 3, 37, 197)])
def test_fused_add_layer_norm_matches_pallas(shape, dtype):
    x, d, scale, bias = _ln_inputs(shape, 1)
    (jx, tx), (jd, td), (js, ts), (jb, tb) = (
        _pair(a, dtype) for a in (x, d, scale, bias))
    want_s, want_y = jax_fused_add_layer_norm(jx, jd, js, jb, eps=1e-6,
                                              interpret=True)
    launches = fused_add_layer_norm.launches
    got_s, got_y = fused_add_layer_norm(tx, td, ts, tb, eps=1e-6)
    assert fused_add_layer_norm.launches == launches
    assert got_s.dtype == got_y.dtype == tx.dtype
    assert got_s.shape == got_y.shape == tx.shape
    # s is the residual stream: x + d rounded to the dtype, bit for bit.
    torch.testing.assert_close(got_s, tx + td, atol=0, rtol=0)
    # y is LN of the ROUNDED s, as in the unfused chain.
    torch.testing.assert_close(got_y, layer_norm_plain(got_s, ts, tb, 1e-6),
                               atol=0, rtol=0)
    np.testing.assert_allclose(_f32(got_s), _f32(want_s), atol=0, rtol=0)
    np.testing.assert_allclose(_f32(got_y), _f32(want_y), atol=LN_ATOL[dtype],
                               rtol=0)


def _attn_inputs(G, gh, gw, hd, seed):
    rng = np.random.default_rng(seed)
    N = gh * gw
    q, k, v = (rng.standard_normal((G, N, hd)).astype(np.float32)
               for _ in range(3))
    rh = (0.3 * rng.standard_normal((gh, gh, hd))).astype(np.float32)
    rw = (0.3 * rng.standard_normal((gw, gw, hd))).astype(np.float32)
    return q, k, v, rh, rw


# (G, gh, gw, hd, heads, n_w, valid_rows): the route flash_attention_relpos
# takes is JAX's — windowed (K5) with heads and N <= 256, global (K4) else.
RELPOS_CASES = {
    # 3x3 windows of 7x7, bottom row skipped below row 4; 64+14 <= 128: folded
    "windowed_folded_skip": (9 * 2, 7, 7, 64, 2, 3, 4),
    # SAM's 14x14 windows at hd 80 (ViT-H): folded, no skip
    "windowed_folded_hd80": (2 * 2, 14, 14, 80, 2, None, None),
    # hd + gh + gw = 136 > 128: the unfolded bias
    "windowed_unfolded": (4 * 2, 8, 8, 120, 2, 2, 3),
    # grouped, N = 400: JAX blocks the queries by grid_w (400 % 128 != 0)
    "global_n400": (2, 20, 20, 64, None, None, None),
    # grouped, N = 1024: JAX's 128-row query blocks
    "global_n1024_hd80": (2, 32, 32, 80, None, None, None),
    "global_n1024": (2, 32, 32, 64, None, None, None),
    # an 8 x 32 window (N = 256, folded: 64 + 40 <= 128) with the skip: JAX's
    # windowed kernel; in bf16 the port routes it to K4 (a side above 16),
    # unfolded, and zeroes the skipped rows. At hd 64 the scale is 1/8, so
    # the folded and unfolded forms round alike.
    "window_8x32_skip": (2 * 2, 8, 32, 64, 2, 1, 5),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(RELPOS_CASES))
def test_flash_attention_relpos_matches_pallas(case, dtype):
    G, gh, gw, hd, heads, n_w, valid_rows = RELPOS_CASES[case]
    arrays = _attn_inputs(G, gh, gw, hd, seed=len(case))
    (jq, tq), (jk, tk), (jv, tv), (jrh, trh), (jrw, trw) = (
        _pair(a, dtype) for a in arrays)
    want = jax_flash_attention_relpos(jq, jk, jv, jrh, jrw, grid_h=gh,
                                      grid_w=gw, heads=heads, interpret=True,
                                      n_w=n_w, valid_rows=valid_rows)
    launches = (relpos_attention_global.launches,
                relpos_attention_windowed.launches)
    got = flash_attention_relpos(tq, tk, tv, trh, trw, grid_h=gh, grid_w=gw,
                                 heads=heads, n_w=n_w, valid_rows=valid_rows)
    assert (relpos_attention_global.launches,
            relpos_attention_windowed.launches) == launches
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATTN_ATOL[dtype],
                               rtol=0)


# Head widths other than the ViTs' 64 and 80, which the card runs on the
# padded instances (32, 96 and 128) of K4 and K5.
PAD_HEAD_DIMS = (8, 16, 32, 48, 96, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["windowed", "global"])
@pytest.mark.parametrize("hd", PAD_HEAD_DIMS)
def test_flash_attention_relpos_head_widths_match_pallas(hd, route, dtype):
    """K5 (3 x 2 windows of 7 x 7 with 2 heads, the bottom window row
    skipped below row 4; folded where hd + 14 <= 128) and K4 (a 10 x 12
    grid) at head width hd, through ``flash_attention_relpos``."""
    if route == "windowed":
        G, gh, gw, heads, n_w, valid_rows = 6 * 2, 7, 7, 2, 2, 4
    else:
        G, gh, gw, heads, n_w, valid_rows = 2, 10, 12, None, None, None
    arrays = _attn_inputs(G, gh, gw, hd, seed=hd)
    (jq, tq), (jk, tk), (jv, tv), (jrh, trh), (jrw, trw) = (
        _pair(a, dtype) for a in arrays)
    want = jax_flash_attention_relpos(jq, jk, jv, jrh, jrw, grid_h=gh,
                                      grid_w=gw, heads=heads, interpret=True,
                                      n_w=n_w, valid_rows=valid_rows)
    assert relpos_route(tq.dtype, G, gh, gw, heads) == route
    got = flash_attention_relpos(tq, tk, tv, trh, trw, grid_h=gh, grid_w=gw,
                                 heads=heads, n_w=n_w, valid_rows=valid_rows)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATTN_ATOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype,grid,route", [
    (torch.bfloat16, (8, 32), "global"),     # a side above 16: K4
    (torch.bfloat16, (17, 17), "global"),    # N = 289 > 256: K4, as in JAX
    (torch.bfloat16, (14, 14), "windowed"),  # SAM's windows: K5
    (torch.float32, (8, 32), "windowed"),    # the float32 K5 takes any side
])
def test_relpos_route(dtype, grid, route):
    assert relpos_route(dtype, 2 * 3, *grid, heads=3) == route
    assert relpos_route(dtype, 2 * 3, *grid, heads=None) == "global"


def test_pad_query_skip_keeps_valid_rows_and_zeroes_the_rest():
    """The skip changes nothing but the skipped rows of the last n_w
    windows, which come back zero."""
    G, gh, gw, hd, heads, n_w, valid_rows = RELPOS_CASES["windowed_folded_skip"]
    q, k, v, rh, rw = (torch.from_numpy(a) for a in _attn_inputs(G, gh, gw, hd, 3))
    full = flash_attention_relpos(q, k, v, rh, rw, grid_h=gh, grid_w=gw,
                                  heads=heads)
    skip = flash_attention_relpos(q, k, v, rh, rw, grid_h=gh, grid_w=gw,
                                  heads=heads, n_w=n_w, valid_rows=valid_rows)
    tail, vN = n_w * heads, valid_rows * gw
    torch.testing.assert_close(skip[:-tail], full[:-tail], atol=0, rtol=0)
    torch.testing.assert_close(skip[-tail:, :vN], full[-tail:, :vN], atol=0,
                               rtol=0)
    assert not skip[-tail:, vN:].any()


@pytest.mark.parametrize("folded", [False, True])
def test_relpos_plain_matches_dense_reference(folded):
    """Both bias forms of the plain version agree with the dense oracle,
    and the port's oracle with JAX's."""
    G, gh, gw, hd = 4, 6, 5, 64
    arrays = _attn_inputs(G, gh, gw, hd, seed=5)
    q, k, v, rh, rw = (torch.from_numpy(a) for a in arrays)
    want = attention_reference(q, k, v, rh, rw, gh, gw)
    np.testing.assert_allclose(
        want.numpy(), np.asarray(jax_attention_reference(
            *(jnp.asarray(a) for a in arrays), gh, gw)), atol=2e-5, rtol=0)
    scale = hd ** -0.5
    bhw = _bias_halves(q, rh, rw, gh, gw,
                       out_scale=1.0 / scale if folded else 1.0)
    got = attention_relpos_plain(q, k, v, bhw, gh, gw, folded=folded)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_raw_tables_are_gathered_like_jax():
    rng = np.random.default_rng(6)
    raw = torch.from_numpy(rng.standard_normal((2 * 5 - 1, 8)).astype(np.float32))
    rh_g, rw_g = _gathered_tables(raw, raw, 5, 5, torch.float32)
    for i in range(5):
        for j in range(5):
            torch.testing.assert_close(rh_g[i, j], raw[i - j + 4], atol=0, rtol=0)
    assert torch.equal(rh_g, rw_g)


@pytest.mark.parametrize("case", ["qkv_shape", "grid", "bias_shape", "heads"])
def test_relpos_wrappers_reject_bad_shapes(case):
    G, N, hd, gh, gw = 4, 49, 64, 7, 7
    q = k = v = torch.zeros(G, N, hd)
    bhw = torch.zeros(G, N, gh + gw)
    heads = 2
    if case == "qkv_shape":
        v = torch.zeros(G, N, hd + 1)
    elif case == "grid":
        gw = 6
    elif case == "bias_shape":
        bhw = torch.zeros(G, N, gh)
    else:
        heads = 3
    with pytest.raises(DlimgError):
        relpos_attention_windowed(q, k, v, bhw, gh, gw, heads, True)
    if case != "heads":
        with pytest.raises(DlimgError):
            relpos_attention_global(q, k, v, bhw, gh, gw)


def test_fused_add_layer_norm_rejects_bad_delta():
    x = torch.zeros(4, 768)
    with pytest.raises(DlimgError):
        fused_add_layer_norm(x, torch.zeros(4, 767), torch.ones(768),
                             torch.zeros(768))
    s, y = fused_add_layer_norm_plain(x, x, torch.ones(768), torch.zeros(768),
                                      1e-6)
    assert s.shape == y.shape == x.shape
