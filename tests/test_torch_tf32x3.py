"""The arithmetic of float32 K4 and K5 on the tensor cores, on the CPU.

csrc/relpos_attention_f32tc.cu computes every product of float32 K4 and
K5 in three TF32 passes (hi = TF32(x), lo = TF32(x - hi), a product
lo.hi + hi.lo + hi.hi, TF32 rounding being `cvt.rna.tf32.f32`: 10 mantissa
bits, ties away from zero) with a one-pass online softmax over key chunks
(32 keys for K4, 40 for K5), exp as 2^(s log2 e - m log2 e). That kernel
runs only on the card; this file emulates its arithmetic in float32 with
torch on the CPU, from numpy-seeded inputs, and holds it against the port's
plain version (`attention_relpos_plain`) at chip_smoke.py's float32
tolerance, atol 2e-5: the design's precision argument, pinned before any
card time is spent. A single TF32 pass (what PyTorch's `allow_tf32` gives)
exceeds that tolerance on scores of large range (q of scale 4), so the
card's check against the plain version catches such a shortcut. The
emulation rounds its float32 sums; the tensor cores truncate theirs, which
the kernel's note deals with (K4's p . v of each chunk accumulates from
zero) and only the card tests can check.
"""

import numpy as np
import pytest
import torch

from dlimgedit_tpu_torch.ops.flash_attention import (
    _bias_halves,
    attention_relpos_plain,
)

ATOL = 2e-5
LOG2E = 1.4426950408889634
K4_CHUNK, K5_CHUNK = 32, 40


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


def attention_tf32(q, k, v, bhw, gh, gw, *, folded, passes, chunk):
    """The kernel's arithmetic: chunks of `chunk` keys, scores in the plain
    version's order, online softmax with the row constant m log2 e."""
    G, N, hd = q.shape
    scale = hd ** -0.5
    tok = torch.arange(N)
    b = bhw.float()
    bias = b[:, :, :gh][:, :, tok // gw] + b[:, :, gh:][:, :, tok % gw]
    cl = torch.full((G, N, 1), -float("inf"))
    l = torch.zeros((G, N, 1))
    o = torch.zeros((G, N, hd))
    for k0 in range(0, N, chunk):
        qk = product(q, k[:, k0:k0 + chunk].transpose(1, 2), passes)
        bt = bias[:, :, k0:k0 + chunk]
        s = (qk + bt) * scale if folded else qk * scale + bt
        cn = torch.maximum(cl, s.amax(-1, keepdim=True) * LOG2E)
        alpha = torch.exp2(cl - cn)
        p = torch.exp2(s * LOG2E - cn)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + product(p, v[:, k0:k0 + chunk], passes)
        cl = cn
    return o / l


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
