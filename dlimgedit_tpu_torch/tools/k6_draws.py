"""The tuned K6 and its plain version against float64, over many input draws, on one GPU.

    python3 -m dlimgedit_tpu_torch.tools.k6_draws [--seeds 0-63]
        [--dtype bfloat16|float16] [--out DIR]

At the fused-window ViT-B's K6 shape (q, k, v the channel slices of a (1,
70, 70, 3 x 768) qkv, 12 heads of 64, 14 x 14 windows) each seed draws its
inputs as tests/test_torch_cuda.py's K6 tests do: a CUDA generator seeded
with the seed gives the qkv (then cast to the dtype) and the two tables
(scale 0.3, float32; the wrapper casts them). Each draw runs
`windowed_attention_fused` (the tuned body) and its plain version, and
evaluates every window and head in float64 from the same inputs at two
sets of rounding points:

  exact  the bias halves bh, bw (float64 sums) correctly rounded to the
         dtype, as JAX's `bh.astype(qn.dtype)` rounds; everything else
         exact, the output unrounded;
  jax    as exact, and p (float64) correctly rounded to the dtype before p
         . v: JAX's other rounding point (dlimgedit_tpu/ops/
         flash_attention.py:622-628).

A step is one step of the dtype at a magnitude (2^(e - 7) in bf16 for
magnitudes in [2^e, 2^(e + 1))): at an output's own magnitude, or at the
largest magnitude of its window and head's output (the repo's
tests/test_torch_geometry.py tolerance, taken a group at a time; an
output near zero has steps far below any float32 sum's error). Per seed
it prints max |kernel - plain| (the atol the tests hold), the outputs
where that exceeds one step at max(|kernel|, |plain|), each version's
worst distance to both references in steps at its group's magnitude and
the outputs past one and two such steps, at the output of largest
|kernel - plain| each version's distances in steps at its own magnitude,
and how many float32 sums of the bias halves (JAX sums them so) round to
another value than the float64 sums. At the draw with the largest |kernel -
plain| it prints the 8 worst outputs with every distance;
with --out it writes that draw's worst window and head (inputs, both
outputs, both references) to DIR/k6_worst_draw.npz for a CPU check
against JAX's kernel in interpret mode. Needs CUDA and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..ops.flash_attention import (_from_windows, _round_exact, _to_windows,
                                   windowed_attention_fused,
                                   windowed_attention_fused_plain)

SHAPE = (1, 70, 12, 64, 14)  # B, padded grid, heads, head width, window
MANTISSA = {torch.bfloat16: 7, torch.float16: 10}


def draw(seed: int, dtype, dev):
    """q, k, v (the slices of one qkv), rh, rw as the card tests draw them."""
    B, grid, nh, hd, ws = SHAPE
    C = nh * hd
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((B, grid, grid, 3 * C), generator=g, device=dev).to(dtype)
    rh, rw = (0.3 * torch.randn((ws, ws, hd), generator=g, device=dev)
              for _ in range(2))
    return qkv, rh, rw




def step(x, dtype):
    """One step of ``dtype`` at the magnitude of each element of ``x``."""
    tiny = torch.finfo(dtype).tiny
    _, e = torch.frexp(x.abs().double().clamp_min(tiny))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float64),
                       e - 1 - MANTISSA[dtype])


def group_step(ref, dtype):
    """One step of ``dtype`` at the largest magnitude of each window and
    head's output, for each of its outputs."""
    B, grid, nh, _, ws = SHAPE
    w = _to_windows(ref, ws, nh)
    top = w.abs().amax(dim=(2, 3), keepdim=True).expand_as(w)
    return _from_windows(step(top, dtype), B, grid, grid, ws)


def references(q, k, v, rh, rw, dtype):
    """The float64 evaluations of every window and head: (exact, jax), and
    the number of float32 sums of the halves that round apart from the
    float64 sums."""
    B, grid, nh, hd, ws = SHAPE
    n = ws * ws
    qw, kw, vw = (_to_windows(t, ws, nh).double() for t in (q, k, v))
    tok = torch.arange(n, device=q.device)
    yi, xi = tok // ws, tok % ws
    rh_e = rh.to(dtype).double()[yi]
    rw_e = rw.to(dtype).double()[xi]
    bh = torch.einsum("gnid,iyd->gniy", qw, rh_e)
    bw = torch.einsum("gnid,ixd->gnix", qw, rw_e)
    bh_r, bw_r = (_round_exact(t, dtype).double() for t in (bh, bw))
    # float32 sums of the same products
    q32 = qw.float()
    bh32 = torch.einsum("gnid,iyd->gniy", q32, rh_e.float()).to(dtype).double()
    bw32 = torch.einsum("gnid,ixd->gnix", q32, rw_e.float()).to(dtype).double()
    flips = int((bh32 != bh_r).sum() + (bw32 != bw_r).sum())
    s = qw @ kw.transpose(-1, -2) * float(hd ** -0.5)
    s = s + bh_r[..., yi] + bw_r[..., xi]
    p = torch.softmax(s, dim=-1)
    exact = _from_windows(p @ vw, B, grid, grid, ws)
    jax = _from_windows(_round_exact(p, dtype).double() @ vw, B, grid, grid, ws)
    return exact, jax, flips


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0-63", help="first-last")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float16"))
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k6_draws: needs a CUDA device", file=sys.stderr)
        return 2
    lo, hi = (int(t) for t in args.seeds.split("-"))
    dtype = getattr(torch, args.dtype)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    B, grid, nh, hd, ws = SHAPE
    C = nh * hd
    print(f"k6_draws on {gpu}: K6 at ({B},{grid},{grid},{C}), {nh} heads of "
          f"{hd}, windows {ws} x {ws}, {args.dtype}, seeds {lo}-{hi}", flush=True)
    rows, worst = [], None
    for seed in range(lo, hi + 1):
        qkv, rh, rw = draw(seed, dtype, dev)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        before = windowed_attention_fused.launches
        got = windowed_attention_fused(q, k, v, rh, rw, ws=ws, num_heads=nh)
        torch.cuda.synchronize()
        assert windowed_attention_fused.launches == before + 1
        want = windowed_attention_fused_plain(q, k, v, rh, rw, ws=ws, num_heads=nh)
        exact, jax, flips = references(q, k, v, rh, rw, dtype)
        kd, pd = got.double(), want.double()
        kp = (kd - pd).abs()
        kp_steps = kp / step(torch.maximum(kd.abs(), pd.abs()), dtype)
        row = {"seed": seed, "max_kernel_plain": kp.max().item(),
               "over_1_step_kernel_plain": int((kp_steps > 1).sum()),
               "float32_halves_flipped": flips}
        at = kp.flatten().argmax()
        for ref_name, ref in (("exact", exact), ("jax", jax)):
            st = group_step(ref, dtype)
            own = step(ref.flatten()[at], dtype)
            for name, x in (("kernel", kd), ("plain", pd)):
                d = (x - ref).abs() / st
                row[f"{name}_{ref_name}_max_steps"] = d.max().item()
                row[f"{name}_{ref_name}_over_1"] = int((d > 1).sum())
                row[f"{name}_{ref_name}_over_2"] = int((d > 2).sum())
                row[f"{name}_{ref_name}_steps_at_worst"] = (
                    (x.flatten()[at] - ref.flatten()[at]).abs() / own).item()
        rows.append(row)
        print(json.dumps(row), flush=True)
        if worst is None or row["max_kernel_plain"] > worst[0]:
            worst = (row["max_kernel_plain"], seed, got, want, exact, jax)
        del qkv, got, want, exact, jax
    _, seed, got, want, exact, jax = worst
    kd, pd = got.double(), want.double()
    kp = (kd - pd).abs().flatten()
    top = torch.topk(kp, 8).indices
    print(f"k6_draws: worst draw seed {seed}; its 8 largest |kernel - plain| "
          f"(distances in steps at each reference's magnitude):", flush=True)
    for i in top.tolist():
        t, c = divmod(i, C)
        y, x = divmod(t, grid)
        e, j = exact.flatten()[i].item(), jax.flatten()[i].item()
        kv, pv = kd.flatten()[i].item(), pd.flatten()[i].item()
        se = step(torch.tensor(e), dtype).item()
        sj = step(torch.tensor(j), dtype).item()
        print(f"  token ({y},{x}) channel {c} (window ({y // ws},{x // ws}), "
              f"head {c // hd}): kernel {kv:.6f} plain {pv:.6f} exact {e:.6f} "
              f"jax {j:.6f}; |kernel - plain| {abs(kv - pv):.5f}; kernel "
              f"{abs(kv - e) / se:.2f} / {abs(kv - j) / sj:.2f} steps from "
              f"exact / jax, plain {abs(pv - e) / se:.2f} / "
              f"{abs(pv - j) / sj:.2f}", flush=True)
    summary = {
        "gpu": gpu, "dtype": args.dtype, "seeds": [lo, hi], "worst_seed": seed,
        "max_kernel_plain": max(r["max_kernel_plain"] for r in rows),
        "draws_over_atol_2e-2": sum(r["max_kernel_plain"] > 2e-2 for r in rows)}
    for key in rows[0]:
        if key.endswith(("_max_steps", "_steps_at_worst")):
            summary[key] = max(r[key] for r in rows)
    print(json.dumps({"k6_draws": summary}), flush=True)
    if args.out is not None:
        i = top[0].item()
        t, c = divmod(i, C)
        y, x = divmod(t, grid)
        wy, wx, head = y // ws, x // ws, c // hd
        qkv, rh, rw = draw(seed, dtype, dev)
        win = (slice(None), slice(wy * ws, wy * ws + ws),
               slice(wx * ws, wx * ws + ws))

        def cut(t, part):
            return t[win][..., part * C + head * hd:part * C + head * hd + hd]

        arrays = {"q": cut(qkv, 0), "k": cut(qkv, 1), "v": cut(qkv, 2),
                  "rh": rh.to(dtype), "rw": rw.to(dtype),
                  "kernel": cut(got, 0), "plain": cut(want, 0),
                  "exact": cut(exact, 0), "jax": cut(jax, 0)}
        args.out.mkdir(parents=True, exist_ok=True)
        import numpy as np

        np.savez(args.out / "k6_worst_draw.npz",
                 seed=seed, window=(wy, wx), head=head, ws=ws,
                 token=(y - wy * ws, x - wx * ws), channel=c - head * hd,
                 **{name: a.double().cpu().numpy() for name, a in arrays.items()})
        print(f"k6_draws: wrote {args.out / 'k6_worst_draw.npz'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
