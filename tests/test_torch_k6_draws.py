"""The float64 helpers of K6's halves and of tools/k6_draws.py on the CPU
(the tool itself runs on the card): `_round_exact` (ops/flash_attention.py,
which the plain K6 rounds its 16-bit bias halves with) is the correct
rounding of float64 to bf16 and float16 (to nearest, ties to even), checked
against exact rational arithmetic at random values, at the midpoints
between neighbouring values of the dtype and just beside them; `step` is
one step of the dtype at a magnitude."""

from fractions import Fraction

import pytest
import torch

from dlimgedit_tpu_torch.ops.flash_attention import _round_exact
from dlimgedit_tpu_torch.tools.k6_draws import step


def _nearest(x: float, dtype) -> float:
    """The dtype's value nearest x (ties to the even bit pattern), by exact
    arithmetic over the neighbours of x's float32 rounding."""
    base = torch.tensor([x], dtype=torch.float32).to(dtype).view(torch.int16)
    best = None
    for d in (-2, -1, 0, 1, 2):
        bits = base + d
        c = bits.view(dtype).double().item()
        key = (abs(Fraction(c) - Fraction(x)), int(bits.item()) & 1)
        if best is None or key < best[0]:
            best = (key, c)
    return best[1]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_round_exact_is_the_correct_rounding(dtype):
    g = torch.Generator().manual_seed(0)
    values = (3 * torch.randn(200, generator=g)).to(dtype).double()
    half = step(values, dtype) / 2
    tiny = values.abs() * 2.0 ** -40
    x = torch.cat([3 * torch.randn(200, generator=g, dtype=torch.float64),
                   values + half, values - half, values + half + tiny,
                   values + half - tiny, values - half - tiny])
    got = _round_exact(x, dtype)
    assert got.dtype == dtype
    want = [_nearest(v, dtype) for v in x.tolist()]
    assert got.double().tolist() == want


def test_step_is_one_step_at_a_magnitude():
    x = torch.tensor([1.0, 1.5, 1.99, 2.0, -3.0, 0.3], dtype=torch.float64)
    assert step(x, torch.bfloat16).tolist() == [2.0 ** -7, 2.0 ** -7, 2.0 ** -7,
                                                2.0 ** -6, 2.0 ** -6, 2.0 ** -9]
    assert step(x, torch.float16).tolist() == [2.0 ** -10, 2.0 ** -10, 2.0 ** -10,
                                               2.0 ** -9, 2.0 ** -9, 2.0 ** -12]
