"""The arithmetic of the float32 attention kernels on the tensor cores, on
the CPU.

csrc/relpos_attention_f32tc.cu (float32 K4, K5, K6 and K7) and
csrc/levit_attention_f32tc.cu (float32 K2) compute every product in three
TF32 passes (hi = TF32(x), lo = TF32(x - hi), a product lo.hi + hi.lo +
hi.hi, TF32 rounding being `cvt.rna.tf32.f32`: 10 mantissa bits, ties away
from zero). K4, K5 and K6 run a one-pass online softmax over key chunks (32
keys for K4, 40 for K5, K6 and K7), exp as 2^(s log2 e - m log2 e); K6 computes
its bias halves in float32 (CUDA cores) and adds them in its own order,
((q.k) scale + bh) + bw. K2 keeps the whole score row and normalises p in
float32 before p . v, the bias added after the scale. Those kernels run
only on the card; this file emulates their arithmetic in float32 with
torch on the CPU, from numpy-seeded inputs, and holds it against the
port's plain versions (`attention_relpos_plain`,
`windowed_attention_fused_plain`, `windowed_attention_qkv_plain`,
`levit_window_attention_plain`) and, for K6, K7 and K2, the JAX kernels in
interpret mode, at chip_smoke.py's float32
tolerance, atol 2e-5: the design's precision argument, pinned before any
card time is spent. A single TF32 pass (what PyTorch's `allow_tf32` gives)
exceeds that tolerance on scores of large range (q of scale 4), so the
card's check against the plain version catches such a shortcut. The
emulation rounds its float32 sums; the tensor cores truncate theirs, which
the kernel's note deals with (K4's p . v of each chunk accumulates from
zero) and only the card tests can check. The padded instances (head
widths other than 64 and 80, computed at 32, 96 or 128 with zero columns)
are emulated too: with each product summed term by term in order, the
padded arithmetic equals the true width's bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from dlimgedit_tpu_torch.ops.flash_attention import (
    _bias_halves,
    _from_windows,
    _to_windows,
    attention_relpos_plain,
    levit_window_attention_plain,
    windowed_attention_fused_plain,
    windowed_attention_qkv_plain,
)

torch.set_num_threads(2)

ATOL = 2e-5
LOG2E = 1.4426950408889634
K4_CHUNK, K5_CHUNK, K6_CHUNK = 32, 40, 40


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """`cvt.rna.tf32.f32`: the nearest value with 10 mantissa bits, ties
    away from zero (a float32 with its 13 low bits zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b from TF32 operands: lo.hi + hi.lo + hi.hi (three passes, the
    small terms first) or hi.hi alone (one pass). Products of two TF32
    values are exact in float32."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def product_in_order(a: torch.Tensor, b: torch.Tensor, passes: int = 3
                     ) -> torch.Tensor:
    """``product`` with each pass's sum taken term by term in the order of
    the contraction index (one float32 rounding a term), so that its bits
    do not depend on how a library blocks a product: zero terms appended to
    the contraction (a padded head width) leave every sum as it was."""
    ah, al = split(a)
    bh, bl = split(b)

    def in_order(x, y):
        acc = torch.zeros(x.shape[:-1] + y.shape[-1:])
        for t in range(x.shape[-1]):
            acc = acc + x[..., t:t + 1] * y[..., t:t + 1, :]
        return acc
    if passes == 1:
        return in_order(ah, bh)
    return in_order(al, bh) + in_order(ah, bl) + in_order(ah, bh)


def online_tf32(q, k, v, score, *, passes, chunk, prod=product):
    """The online-softmax body of K4, K5 and K6: chunks of `chunk` keys,
    score(qk, k0, k1) the scores of keys k0 .. k1 - 1 from their products,
    the row constant m log2 e."""
    *lead, N, hd = q.shape
    cl = torch.full((*lead, N, 1), -float("inf"))
    l = torch.zeros((*lead, N, 1))
    o = torch.zeros((*lead, N, hd))
    for k0 in range(0, N, chunk):
        k1 = min(k0 + chunk, N)
        s = score(prod(q, k[..., k0:k1, :].transpose(-1, -2), passes), k0, k1)
        cn = torch.maximum(cl, s.amax(-1, keepdim=True) * LOG2E)
        alpha = torch.exp2(cl - cn)
        p = torch.exp2(s * LOG2E - cn)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + prod(p, v[..., k0:k1, :], passes)
        cl = cn
    return o / l


def attention_tf32(q, k, v, bhw, gh, gw, *, folded, passes, chunk,
                   prod=product, scale=None):
    """K4 / K5's arithmetic: scores in the plain version's order; the
    scale hd^-1/2 of q's width unless given (a padded width's is the true
    hd's)."""
    N, hd = q.shape[1:]
    scale = hd ** -0.5 if scale is None else scale
    tok = torch.arange(N)
    b = bhw.float()
    bias = b[:, :, :gh][:, :, tok // gw] + b[:, :, gh:][:, :, tok % gw]

    def score(qk, k0, k1):
        bt = bias[:, :, k0:k1]
        return (qk + bt) * scale if folded else qk * scale + bt
    return online_tf32(q, k, v, score, passes=passes, chunk=chunk, prod=prod)


def window_strip_tf32(q, k, v, rh, rw, *, ws, num_heads, passes,
                      chunk=K6_CHUNK):
    """K6's arithmetic on (B, Hp, Wp, C) q, k, v: the windows' bias halves
    in float32, s = ((q.k) scale + bh[i, y_j]) + bw[i, x_j], K5's online
    softmax over 40-key chunks."""
    B, Hp, Wp, C = q.shape
    hd = C // num_heads
    n = ws * ws
    scale = hd ** -0.5
    qw, kw, vw = (_to_windows(t, ws, num_heads).float() for t in (q, k, v))
    tok = torch.arange(n)
    yi, xi = tok // ws, tok % ws
    bh = torch.einsum("gnid,iyd->gniy", qw, rh.float()[yi])
    bw = torch.einsum("gnid,ixd->gnix", qw, rw.float()[xi])

    def score(qk, k0, k1):
        return qk * scale + bh[..., yi[k0:k1]] + bw[..., xi[k0:k1]]
    o = online_tf32(qw, kw, vw, score, passes=passes, chunk=chunk)
    return _from_windows(o, B, Hp, Wp, ws)


def levit_tf32(qkv, bias, num_heads, *, passes):
    """K2's arithmetic: the whole score row, s = (q.k) scale + bias, exact
    softmax, p normalised in float32 (times 1 / l), then p . v."""
    G, N, H = qkv.shape
    kd = H // (3 * num_heads)
    q, k, v = (qkv.reshape(G, N, num_heads, 3 * kd)[..., i * kd:(i + 1) * kd]
               .permute(0, 2, 1, 3) for i in range(3))
    s = product(q, k.transpose(-1, -2), passes) * kd ** -0.5 + bias[None]
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s * LOG2E - m * LOG2E)
    p = p * (1.0 / p.sum(-1, keepdim=True))
    out = product(p, v, passes)
    return out.permute(0, 2, 1, 3).reshape(G, N, num_heads * kd)


def inputs(G, gh, gw, hd, q_scale, folded, seed):
    rng = np.random.default_rng(seed)
    N = gh * gw
    q, k, v = (torch.from_numpy(rng.standard_normal((G, N, hd), dtype=np.float32))
               for _ in range(3))
    q = q * q_scale
    rh = torch.from_numpy(0.3 * rng.standard_normal((gh, gh, hd), dtype=np.float32))
    rw = torch.from_numpy(0.3 * rng.standard_normal((gw, gw, hd), dtype=np.float32))
    bhw = _bias_halves(q, rh, rw, gh, gw,
                       out_scale=1.0 / hd ** -0.5 if folded else 1.0)
    return q, k, v, bhw


# (grid, chunk): K5's 14 x 14 windows (196 keys: four 40-key chunks and one
# of 36 with 4 masked), K4 over a 32 x 32 grid in its 32-key chunks, and in
# 64-key chunks (fewer rescales of the running sums).
CASES = [((14, 14), K5_CHUNK), ((32, 32), K4_CHUNK), ((32, 32), 64)]


@pytest.mark.parametrize("q_scale", [1.0, 4.0])
@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("grid,chunk", CASES)
@pytest.mark.parametrize("hd", [64, 80])
def test_three_tf32_passes_match_the_plain_version(hd, grid, chunk, folded,
                                                   q_scale):
    gh, gw = grid
    q, k, v, bhw = inputs(2, gh, gw, hd, q_scale, folded, seed=hd + gh)
    got = attention_tf32(q, k, v, bhw, gh, gw, folded=folded, passes=3,
                         chunk=chunk)
    want = attention_relpos_plain(q, k, v, bhw, gh, gw, folded=folded)
    err = (got - want).abs().max().item()
    assert err <= ATOL, err


@pytest.mark.parametrize("grid,chunk", CASES)
@pytest.mark.parametrize("hd", [64, 80])
def test_one_tf32_pass_exceeds_the_tolerance(hd, grid, chunk):
    gh, gw = grid
    q, k, v, bhw = inputs(2, gh, gw, hd, 4.0, False, seed=hd + gh)
    got = attention_tf32(q, k, v, bhw, gh, gw, folded=False, passes=1,
                         chunk=chunk)
    want = attention_relpos_plain(q, k, v, bhw, gh, gw)
    assert (got - want).abs().max().item() > ATOL


def test_tf32_rounding_and_split():
    one = 1.0
    x = torch.tensor([one + 2.0 ** -11, one + 2.0 ** -12, one + 3 * 2.0 ** -11,
                      -(one + 2.0 ** -11), 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + 2.0 ** -10, one, one + 2.0 ** -9,
                         -(one + 2.0 ** -10), 3.0, 0.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)  # ties away from zero
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.standard_normal(4096, dtype=np.float32) * 100)
    hi, lo = split(y)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    assert ((hi + lo - y).abs() <= y.abs() * 2.0 ** -22).all()


def strip_inputs(heads, hd, q_scale, seed, B=1, grid=14, ws=14):
    """q, k, v as the channel slices of one (B, grid, grid, 3C) qkv, the
    gathered (ws, ws, hd) tables, numpy arrays beside the tensors."""
    rng = np.random.default_rng(seed)
    C = heads * hd
    qkv = rng.standard_normal((B, grid, grid, 3 * C), dtype=np.float32)
    qkv[..., :C] *= q_scale
    rh, rw = ((0.3 * rng.standard_normal((ws, ws, hd))).astype(np.float32)
              for _ in range(2))
    return qkv, rh, rw


def strip_ops(qkv, C):
    return qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]


@pytest.mark.parametrize("q_scale", [1.0, 4.0])
@pytest.mark.parametrize("hd", [64, 80])
def test_window_strip_three_tf32_passes_match_plain_and_pallas(hd, q_scale):
    """K6 at SAM's 14 x 14 window (196 keys: four 40-key chunks and one of
    36 with 4 masked), two heads, against the plain version and JAX's
    `windowed_attention_fused` in interpret mode."""
    heads, ws = 2, 14
    qkv, rh, rw = strip_inputs(heads, hd, q_scale, seed=hd)
    C = heads * hd
    tq, trh, trw = (torch.from_numpy(a) for a in (qkv, rh, rw))
    got = window_strip_tf32(*strip_ops(tq, C), trh, trw, ws=ws,
                            num_heads=heads, passes=3)
    plain = windowed_attention_fused_plain(*strip_ops(tq, C), trh, trw, ws=ws,
                                           num_heads=heads)
    assert (got - plain).abs().max().item() <= ATOL
    jq = jnp.asarray(qkv)
    want = jax_windowed_attention_fused(*strip_ops(jq, C), jnp.asarray(rh),
                                        jnp.asarray(rw), ws=ws,
                                        num_heads=heads, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("hd", [64, 80])
def test_window_strip_padded_grid_matches_plain(hd):
    """K6 over a padded 28 x 28 grid of four windows, three heads."""
    heads, ws = 3, 14
    qkv, rh, rw = strip_inputs(heads, hd, 1.0, seed=hd + 1, grid=28)
    C = heads * hd
    tq, trh, trw = (torch.from_numpy(a) for a in (qkv, rh, rw))
    got = window_strip_tf32(*strip_ops(tq, C), trh, trw, ws=ws,
                            num_heads=heads, passes=3)
    plain = windowed_attention_fused_plain(*strip_ops(tq, C), trh, trw, ws=ws,
                                           num_heads=heads)
    assert (got - plain).abs().max().item() <= ATOL


@pytest.mark.parametrize("hd", [64, 80])
def test_window_strip_one_tf32_pass_exceeds_the_tolerance(hd):
    heads, ws = 2, 14
    qkv, rh, rw = strip_inputs(heads, hd, 4.0, seed=hd)
    C = heads * hd
    tq, trh, trw = (torch.from_numpy(a) for a in (qkv, rh, rw))
    got = window_strip_tf32(*strip_ops(tq, C), trh, trw, ws=ws,
                            num_heads=heads, passes=1)
    plain = windowed_attention_fused_plain(*strip_ops(tq, C), trh, trw, ws=ws,
                                           num_heads=heads)
    assert (got - plain).abs().max().item() > ATOL


# K7: SAM's 14 x 14 window in K5's 40-key chunks; a 17 x 17 window (289
# keys, above K5's 256) in K4's 32-key chunks.
QKV_CASES = [(14, K5_CHUNK), (17, K4_CHUNK)]


@pytest.mark.parametrize("q_scale", [1.0, 4.0])
@pytest.mark.parametrize("g,chunk", QKV_CASES)
@pytest.mark.parametrize("hd", [64, 80])
def test_qkv_three_tf32_passes_match_plain_and_pallas(hd, g, chunk, q_scale):
    """K7's arithmetic: K5's (K4's above 256 keys) on the q, k, v
    components of a (W, 3, nh, N, hd) qkv, the plain bias, every row."""
    W, nh, N = 2, 2, g * g
    rng = np.random.default_rng(hd + g)
    qkv = rng.standard_normal((W, 3, nh, N, hd), dtype=np.float32)
    qkv[:, 0] *= q_scale
    rh, rw = (0.3 * rng.standard_normal((g, g, hd), dtype=np.float32)
              for _ in range(2))
    tqkv = torch.from_numpy(qkv)
    q, k, v = (tqkv[:, c].reshape(W * nh, N, hd) for c in range(3))
    bhw = _bias_halves(q, torch.from_numpy(rh), torch.from_numpy(rw), g, g)
    got = attention_tf32(q, k, v, bhw, g, g, folded=False, passes=3,
                         chunk=chunk).reshape(W, nh, N, hd)
    err = (got - windowed_attention_qkv_plain(tqkv, bhw, g, g)).abs().max()
    assert err.item() <= ATOL, err.item()
    pallas = np.asarray(jax_windowed_attention_qkv(
        jnp.asarray(qkv), jnp.asarray(rh), jnp.asarray(rw), grid_h=g,
        grid_w=g, interpret=True))
    assert np.abs(got.numpy() - pallas).max() <= ATOL


def levit_inputs(G, N, nh, q_scale, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((G, N, nh * 96), dtype=np.float32)
    qkv.reshape(G, N, nh, 96)[..., :32] *= q_scale
    bias = (0.5 * rng.standard_normal((nh, N, N))).astype(np.float32)
    return qkv, bias


@pytest.mark.parametrize("q_scale", [1.0, 4.0])
@pytest.mark.parametrize("N", [49, 196])
def test_levit_three_tf32_passes_match_plain_and_pallas(N, q_scale):
    """K2 at TinyViT's windows of 7 x 7 and 14 x 14 tokens."""
    G, nh = 2, 3
    qkv, bias = levit_inputs(G, N, nh, q_scale, seed=N)
    tq, tb = torch.from_numpy(qkv), torch.from_numpy(bias)
    got = levit_tf32(tq, tb, nh, passes=3)
    plain = levit_window_attention_plain(tq, tb, nh)
    assert (got - plain).abs().max().item() <= ATOL
    want = jax_levit_window_attention(jnp.asarray(qkv), jnp.asarray(bias),
                                      num_heads=nh, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("N", [49, 196])
def test_levit_one_tf32_pass_exceeds_the_tolerance(N):
    G, nh = 2, 3
    qkv, bias = levit_inputs(G, N, nh, 4.0, seed=N)
    tq, tb = torch.from_numpy(qkv), torch.from_numpy(bias)
    got = levit_tf32(tq, tb, nh, passes=1)
    plain = levit_window_attention_plain(tq, tb, nh)
    assert (got - plain).abs().max().item() > ATOL


# A padded instance of the float32 K4 / K5 / K6 / K7 (csrc/relpos_attention_
# f32tc.cuh, PAD) computes at width 32, 96 or 128 on rows of hd dims, the
# columns past hd zeros: (true hd, padded width).
PADDED = [(8, 32), (24, 32), (32, 32), (48, 96), (88, 96), (96, 96),
          (104, 128)]


@pytest.mark.parametrize("route", ["windowed", "global"])
@pytest.mark.parametrize("hd,width", PADDED)
def test_padded_width_tf32_equals_true_width_and_matches_pallas(hd, width,
                                                                route):
    """The three-pass arithmetic at the padded width (q, k, v with zero
    columns up to `width`, the true hd's scale, the output's first hd
    columns) equals the true-width arithmetic bit for bit, the products
    summed term by term in order: the TF32 split of a zero is zero, and a
    zero term leaves a float32 sum as it was. Both match JAX's
    `flash_attention_relpos` in interpret mode within 2e-5: K5 (two heads of
    7 x 7 windows, 40-key chunks, folded where hd + 14 <= 128, as JAX routes
    it) and K4 (a 9 x 11 grid, 32-key chunks, the plain bias)."""
    if route == "windowed":
        G, gh, gw, heads, chunk = 2 * 2, 7, 7, 2, K5_CHUNK
        folded = hd + gh + gw <= 128
    else:
        G, gh, gw, heads, chunk, folded = 2, 9, 11, None, K4_CHUNK, False
    rng = np.random.default_rng(hd + width)
    N = gh * gw
    q, k, v = (rng.standard_normal((G, N, hd), dtype=np.float32)
               for _ in range(3))
    rh = (0.3 * rng.standard_normal((gh, gh, hd))).astype(np.float32)
    rw = (0.3 * rng.standard_normal((gw, gw, hd))).astype(np.float32)
    tq, tk, tv, trh, trw = (torch.from_numpy(a) for a in (q, k, v, rh, rw))
    scale = hd ** -0.5
    bhw = _bias_halves(tq, trh, trw, gh, gw,
                       out_scale=1.0 / scale if folded else 1.0)
    true = attention_tf32(tq, tk, tv, bhw, gh, gw, folded=folded, passes=3,
                          chunk=chunk, prod=product_in_order)
    pad = [torch.nn.functional.pad(t, (0, width - hd)) for t in (tq, tk, tv)]
    padded = attention_tf32(*pad, bhw, gh, gw, folded=folded, passes=3,
                            chunk=chunk, prod=product_in_order, scale=scale)
    assert not padded[..., hd:].any()
    assert torch.equal(padded[..., :hd], true)
    want = jax_flash_attention_relpos(
        *(jnp.asarray(a) for a in (q, k, v, rh, rw)), grid_h=gh, grid_w=gw,
        heads=heads, interpret=True)
    np.testing.assert_allclose(true.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
