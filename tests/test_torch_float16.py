"""The port's kernel modules in float16 against the JAX package's Pallas
kernels in float16 (interpret mode, as the JAX package's own tests run
them), and the int8 linears at widths that are not multiples of 8, on the
CPU. The inputs are made from numpy seeds and rounded to float16
identically on both sides; on CPU tensors the port's wrappers compute their
plain versions, which the CUDA kernels are held against on the card
(tests/test_torch_cuda.py ``-k float16``, chip_smoke.py phase 20).

JAX treats float16 as it treats bf16 (float32 statistics and products, p
and K6's bias halves rounded to the input dtype, one rounding of the
output), so the tolerances are the bf16 cases' rule at float16's step:

  * LayerNorm (K1, K3): atol 4e-3, two float16 steps (2^-9 each) at
    |y| < 4; the same rule is 2e-2 at bf16's step;
  * attention (K2, K4-K7): atol 4e-3 likewise (|out| < 3 here);
  * K3's s = x + d: bit for bit;
  * the int8 linears: bit for bit (the quanta, the int32 product and the
    epilogue's roundings are the same operations on both sides).

None is looser than the bf16 case of the same check (2e-2). Run as a
script, it runs every case and prints each kernel's largest float16
|diff| against JAX:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_float16.py
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dlimgedit_tpu.ops import quant as jq
from dlimgedit_tpu.ops.flash_attention import (
    flash_attention_relpos as jax_flash_attention_relpos,
)
from dlimgedit_tpu.ops.flash_attention import (
    levit_window_attention as jax_levit_window_attention,
)
from dlimgedit_tpu.ops.flash_attention import (
    windowed_attention_fused as jax_windowed_attention_fused,
)
from dlimgedit_tpu.ops.flash_attention import (
    windowed_attention_qkv as jax_windowed_attention_qkv,
)
from dlimgedit_tpu.ops.fused_norm import (
    fused_add_layer_norm as jax_fused_add_layer_norm,
)
from dlimgedit_tpu.ops.fused_norm import fused_layer_norm as jax_fused_layer_norm
from dlimgedit_tpu_torch.models.common import QuantLinear, linear
from dlimgedit_tpu_torch.ops import quant as pq
from dlimgedit_tpu_torch.ops.cuda_build import DTYPE_CODES
from dlimgedit_tpu_torch.ops.flash_attention import (
    flash_attention_relpos,
    levit_window_attention,
    relpos_route,
    windowed_attention_fused,
    windowed_attention_qkv,
)
from dlimgedit_tpu_torch.ops.fused_norm import (
    fused_add_layer_norm,
    fused_layer_norm,
    layer_norm_plain,
)

torch.set_num_threads(2)

LN_ATOL = 4e-3
ATTN_ATOL = 4e-3
BF16_ATOL = 2e-2  # the bf16 cases' tolerance, which none here exceeds
DTYPES = {"float16": (jnp.float16, torch.float16),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MAX_DIFFS = {}  # kernel -> the largest float16 |diff| against JAX so far


def _pair(a: np.ndarray, dtype: str = "float16"):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(kernel, got, want, atol):
    assert atol <= BF16_ATOL
    assert got.dtype == torch.float16
    err = float(np.abs(_f32(got) - _f32(want)).max())
    MAX_DIFFS[kernel] = max(MAX_DIFFS.get(kernel, 0.0), err)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=0)


def test_float16_has_a_kernel_dtype_code():
    """Every C entry point dispatches code 2 (csrc/common.cuh kDtypeF16)."""
    assert DTYPE_CODES == {"torch.float32": 0, "torch.bfloat16": 1,
                           "torch.float16": 2}


@pytest.mark.parametrize("C", [3, 96, 384])
@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_layer_norms_match_pallas_in_float16(kernel, C):
    rng = np.random.default_rng(C)
    x = (rng.standard_normal((37, C)) * 1.5 + 0.3).astype(np.float32)
    d = rng.standard_normal((37, C)).astype(np.float32)
    scale = rng.uniform(0.25, 0.75, C).astype(np.float32)
    bias = rng.uniform(-0.25, 0.25, C).astype(np.float32)
    (jx, tx), (jd, td), (js, ts), (jb, tb) = (_pair(a) for a in (x, d, scale, bias))
    if kernel == "K1":
        want = jax_fused_layer_norm(jx, js, jb, eps=1e-6, interpret=True)
        _close("K1", fused_layer_norm(tx, ts, tb, eps=1e-6), want, LN_ATOL)
        return
    want_s, want_y = jax_fused_add_layer_norm(jx, jd, js, jb, eps=1e-6,
                                              interpret=True)
    got_s, got_y = fused_add_layer_norm(tx, td, ts, tb, eps=1e-6)
    # s is x + d rounded to float16, read back: bit for bit, and y is the
    # LayerNorm of that rounded s.
    np.testing.assert_array_equal(_f32(got_s), _f32(want_s))
    torch.testing.assert_close(got_y, layer_norm_plain(got_s, ts, tb, 1e-6),
                               atol=0, rtol=0)
    _close("K3", got_y, want_y, LN_ATOL)


def test_levit_window_attention_matches_pallas_in_float16():
    """K2 at 2 windows of 7 x 7 (N = 49), 4 heads of kd 32."""
    rng = np.random.default_rng(49)
    G, N, nh, kd = 2, 49, 4, 32
    qkv = rng.standard_normal((G, N, nh * 3 * kd)).astype(np.float32)
    bias = (0.5 * rng.standard_normal((nh, N, N))).astype(np.float32)
    (jq_, tq), (jb, tb) = _pair(qkv), _pair(bias)
    want = jax_levit_window_attention(jq_, jb, num_heads=nh, interpret=True)
    _close("K2", levit_window_attention(tq, tb, nh), want, ATTN_ATOL)


def _attn_inputs(G, gh, gw, hd, seed):
    rng = np.random.default_rng(seed)
    N = gh * gw
    q, k, v = (rng.standard_normal((G, N, hd)).astype(np.float32)
               for _ in range(3))
    rh = (0.3 * rng.standard_normal((gh, gh, hd))).astype(np.float32)
    rw = (0.3 * rng.standard_normal((gw, gw, hd))).astype(np.float32)
    return q, k, v, rh, rw


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("route", ["windowed", "global"])
def test_flash_attention_relpos_matches_pallas_in_float16(route, hd):
    """K5 (3 x 2 windows of 7 x 7, 2 heads, the bottom window row skipped
    below row 4; folded bias, hd + 14 <= 128) and K4 (a 10 x 12 grid)."""
    if route == "windowed":
        G, gh, gw, heads, n_w, valid_rows = 6 * 2, 7, 7, 2, 2, 4
    else:
        G, gh, gw, heads, n_w, valid_rows = 2, 10, 12, None, None, None
    arrays = _attn_inputs(G, gh, gw, hd, seed=hd + len(route))
    (jq_, tq), (jk, tk), (jv, tv), (jrh, trh), (jrw, trw) = (
        _pair(a) for a in arrays)
    want = jax_flash_attention_relpos(jq_, jk, jv, jrh, jrw, grid_h=gh,
                                      grid_w=gw, heads=heads, interpret=True,
                                      n_w=n_w, valid_rows=valid_rows)
    assert relpos_route(tq.dtype, G, gh, gw, heads) == route
    got = flash_attention_relpos(tq, tk, tv, trh, trw, grid_h=gh, grid_w=gw,
                                 heads=heads, n_w=n_w, valid_rows=valid_rows)
    _close("K5" if route == "windowed" else "K4", got, want, ATTN_ATOL)


def test_relpos_route_sends_wide_float16_windows_to_k4():
    """The float16 K5 is the bf16 tensor-core body: windows of up to 16 x 16."""
    assert relpos_route(torch.float16, 6, 8, 32, heads=3) == "global"
    assert relpos_route(torch.float16, 6, 14, 14, heads=3) == "windowed"


@pytest.mark.parametrize("heads,hd", [(2, 32), (1, 64)])
def test_windowed_attention_fused_matches_pallas_in_float16(heads, hd):
    """K6 at ws 7 on a (1, 14, 14) padded grid: q, k, v the channel slices
    of one qkv tensor; the bias halves rounded to float16 on both sides."""
    ws, C = 7, heads * hd
    rng = np.random.default_rng(7 + hd)
    qkv = rng.standard_normal((1, 14, 14, 3 * C)).astype(np.float32)
    rh = (0.3 * rng.standard_normal((ws, ws, hd))).astype(np.float32)
    rw = (0.3 * rng.standard_normal((ws, ws, hd))).astype(np.float32)
    (jqkv, tqkv), (jrh, trh), (jrw, trw) = (_pair(a) for a in (qkv, rh, rw))
    want = jax_windowed_attention_fused(
        jqkv[..., :C], jqkv[..., C:2 * C], jqkv[..., 2 * C:], jrh, jrw,
        ws=ws, num_heads=heads, interpret=True)
    got = windowed_attention_fused(tqkv[..., :C], tqkv[..., C:2 * C],
                                   tqkv[..., 2 * C:], trh, trw, ws=ws,
                                   num_heads=heads)
    _close("K6", got, want, ATTN_ATOL)


@pytest.mark.parametrize("windows,side,hd", [(3, 5, 16), (1, 14, 64)])
def test_windowed_attention_qkv_matches_pallas_in_float16(windows, side, hd):
    """K7 on a (W, 3, 2, N, hd) qkv."""
    rng = np.random.default_rng(side + hd)
    qkv = rng.standard_normal((windows, 3, 2, side * side, hd)).astype(np.float32)
    rh = (0.3 * rng.standard_normal((side, side, hd))).astype(np.float32)
    rw = (0.3 * rng.standard_normal((side, side, hd))).astype(np.float32)
    (jqkv, tqkv), (jrh, trh), (jrw, trw) = (_pair(a) for a in (qkv, rh, rw))
    want = jax_windowed_attention_qkv(jqkv, jrh, jrw, grid_h=side,
                                      grid_w=side, interpret=True)
    got = windowed_attention_qkv(tqkv, trh, trw, grid_h=side, grid_w=side)
    _close("K7", got, want, ATTN_ATOL)


# (C, N): in and out widths of the int8 linears; none but the last is a
# multiple of 8, which cuBLASLt's int8 product needs on the card.
ODD_WIDTHS = [(100, 36), (96, 98), (13, 7), (64, 48)]


def _int8_linear_pair(C, N, dtype, seed):
    rng = np.random.default_rng(seed)
    w = (0.05 * rng.standard_normal((C, N))).astype(np.float32)
    b = (0.1 * rng.standard_normal(N)).astype(np.float32)
    x = rng.standard_normal((2, 23, C)).astype(np.float32)
    x[1] *= 30.0
    jw_q, js = jq.quantize_weight(jnp.asarray(w))
    (jb, tb), (jx, tx) = _pair(b, dtype), _pair(x, dtype)
    lin = QuantLinear(torch.from_numpy(np.array(jw_q)),
                      torch.from_numpy(np.array(js)), tb, act_int8=True)
    want = jq.int8_linear({"w_q8": jw_q, "w_scale": js, "b": jb}, jx)
    return lin, tx, want


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("C,N", ODD_WIDTHS)
def test_int8_linear_any_width_bit_equal_to_jax(C, N, dtype):
    lin, tx, want = _int8_linear_pair(C, N, dtype, seed=C + N)
    got = linear(lin, tx)
    assert got.dtype == tx.dtype and got.shape == (2, 23, N)
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("M,C,N", [(5, 100, 36), (40, 96, 98), (17, 13, 7)])
def test_zero_padded_int8_product_is_exact(M, C, N):
    """What ``int8_mm`` runs where C or N is not a multiple of 8: the weight
    zero-padded (``pad_int8_weight``: column-major, zero rows and columns
    to multiples of 8), q with zero columns up to its rows, the result
    sliced back to N; equal to the unpadded product."""
    gen = torch.Generator().manual_seed(M + C + N)
    q = torch.randint(-127, 128, (M, C), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (C, N), generator=gen, dtype=torch.int8)
    padded = pq.pad_int8_weight(w)
    assert padded.shape == (-(-C // 8) * 8, -(-N // 8) * 8)
    assert padded.stride() == (1, padded.shape[0])  # column-major
    assert torch.equal(padded[:C, :N], w) and int(padded.abs().sum()) == int(
        w.abs().sum())
    qp = pq.pad_rows(F.pad(q, (0, padded.shape[0] - C)))
    assert torch.equal(torch._int_mm(qp, padded)[:M, :N], q.int() @ w.int())
    got = pq.int8_mm(q, padded, N)
    assert got.shape == (M, N) and got.is_contiguous()
    assert torch.equal(got, torch._int_mm(q, w))
    assert torch.equal(got, q.int() @ w.int())


def test_padded_int8_weight_is_made_once_per_weight():
    """A ``QuantLinear`` whose widths are not multiples of 8 pads ``w_q8``
    once, into its non-persistent buffer ``w_q8_mm`` (column-major, no leaf
    of the state dict); ``load_state_dict`` writes the buffer again in
    place from the ``w_q8`` it loads; a width that needs no padding holds
    no buffer and multiplies by ``w_q8`` itself."""
    w_q, scale = pq.quantize_weight(torch.randn(100, 36))
    lin = QuantLinear(w_q, scale, None, act_int8=True)
    buf = lin.w_q8_mm
    assert buf.shape == (104, 40) and buf.stride() == (1, 104)
    assert torch.equal(buf, pq.pad_int8_weight(lin.w_q8))
    assert set(lin.state_dict()) == {"w_q8", "w_scale"}
    assert dict(lin.named_buffers()) == {"w_q8_mm": buf}
    w_new, _ = pq.quantize_weight(torch.randn(100, 36))
    lin.load_state_dict({"w_q8": w_new, "w_scale": scale}, strict=True)
    assert lin.w_q8_mm is buf and torch.equal(buf, pq.pad_int8_weight(w_new))
    lin.to(torch.bfloat16)  # int8 tensors keep their dtype
    assert lin.w_q8_mm.dtype == torch.int8
    even = QuantLinear(*pq.quantize_weight(torch.randn(64, 48)), None,
                       act_int8=True)
    assert not hasattr(even, "w_q8_mm") and not list(even.buffers())


if __name__ == "__main__":
    for kernel in ("K1", "K3"):
        for C in (3, 96, 384):
            test_layer_norms_match_pallas_in_float16(kernel, C)
    test_levit_window_attention_matches_pallas_in_float16()
    for route in ("windowed", "global"):
        for hd in (32, 64):
            test_flash_attention_relpos_matches_pallas_in_float16(route, hd)
    for heads, hd in ((2, 32), (1, 64)):
        test_windowed_attention_fused_matches_pallas_in_float16(heads, hd)
    for case in ((3, 5, 16), (1, 14, 64)):
        test_windowed_attention_qkv_matches_pallas_in_float16(*case)
    for C, N in ODD_WIDTHS:
        for dtype in DTYPES:
            test_int8_linear_any_width_bit_equal_to_jax(C, N, dtype)
    print("float16 max |diff| against JAX (interpret mode), by kernel: "
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(MAX_DIFFS.items()))
          + "; int8_linear at every ODD_WIDTHS case in float16 and bf16: 0 "
          "(bit for bit)")
