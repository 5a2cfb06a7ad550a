"""Whether the card's float16 attention checks see a rounding point that
moved: the float16 kernels K2, K4, K5, K6 and K7 against their plain
versions, built from this checkout and built from a copy whose float16
bodies round p (the softmax weights before p . v) to bf16 first, as a
float16 body that kept a bf16 rounding would.

    python3 -m dlimgedit_tpu_torch.tools.f16_rounding_check [--out FILE]

The copy is made in a temporary directory: in ``levit_attention_tc.cuh``
and ``relpos_attention_tc.cuh`` every ``H::pack`` of p (K2's and K5-K7's
normalised p, ``H::pack(s[...] * i, ...)``; K4's ``H::pack(ex2(...))``)
becomes ``pack_via_bf16<H>``, which rounds each value to bf16 and then
packs it as the body's type (a bf16 body is unchanged). Each build runs in
a fresh process at its checkout's root and prints, for each kernel at the
main paths' float16 shapes (those of ``tests/test_torch_cuda.py``'s
float16 cases, on the same kind of seeded inputs), the max and the mean
|kernel - plain|, one JSON line a build. ``--out`` also writes both lines
to FILE. Needs nvcc and a card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = "dlimgedit_tpu_torch"

# (kernel, shape): K2 (windows, tokens, heads), K4 (heads, grid side, hd),
# K5 (windows x heads, window side, hd), K6 (grid side, heads, hd), K7
# (windows, heads, hd) at 14 x 14.
CASES = (("K2", (361, 49, 4)), ("K2", (25, 196, 5)), ("K2", (100, 49, 10)),
         ("K4", (12, 64, 64)), ("K4", (16, 64, 80)),
         ("K5", (300, 14, 64)), ("K5", (400, 14, 80)),
         ("K6", (70, 12, 64)), ("K6", (70, 16, 80)),
         ("K7", (25, 12, 64)), ("K7", (25, 16, 80)))

_P_PACK = re.compile(r"H::pack\((?=s\[|ex2\()")
_VIA_BF16 = """
namespace dlimg {
template <typename H>
__device__ __forceinline__ uint32_t pack_via_bf16(float lo, float hi) {
  return H::pack(__bfloat162float(__float2bfloat16_rn(lo)),
                 __bfloat162float(__float2bfloat16_rn(hi)));
}
}  // namespace dlimg
"""


def make_mutant(dst: Path) -> Path:
    """A copy of the package under ``dst`` whose tensor-core bodies round
    p through bf16; returns the copy's root."""
    pkg = dst / PACKAGE
    shutil.copytree(ROOT / PACKAGE, pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = pkg / "csrc"
    with open(csrc / "tensor_core.cuh", "a") as f:
        f.write(_VIA_BF16)
    for name in ("levit_attention_tc.cuh", "relpos_attention_tc.cuh"):
        path = csrc / name
        text, n = _P_PACK.subn("pack_via_bf16<H>(", path.read_text())
        if n == 0:
            raise SystemExit(f"{name}: no p packing found to mutate")
        path.write_text(text)
    return dst


def _cases(torch, ops, dev):
    """(label, kernel call, plain call) a case, inputs made from seeds."""
    for kind, dims in CASES:
        g = torch.Generator(device=dev).manual_seed(sum(dims) + ord(kind[1]))

        def f16(shape, scale=1.0):
            return (scale * torch.randn(shape, generator=g, device=dev)).half()

        label = f"{kind} {'x'.join(map(str, dims))}"
        if kind == "K2":
            G, N, nh = dims
            qkv, bias = f16((G, N, nh * 96)), f16((nh, N, N), 0.5)
            yield (label, lambda: ops.levit_window_attention(qkv, bias, nh),
                   lambda: ops.levit_window_attention_plain(qkv, bias, nh))
        elif kind in ("K4", "K5"):
            G, side, hd = dims
            q, k, v = (f16((G, side * side, hd)) for _ in range(3))
            rh, rw = (f16((side, side, hd), 0.3) for _ in range(2))
            if kind == "K4":
                bhw = ops._bias_halves(q, rh, rw, side, side)
                yield (label,
                       lambda: ops.relpos_attention_global(q, k, v, bhw, side, side),
                       lambda: ops.attention_relpos_plain(q, k, v, bhw, side, side))
            else:
                heads = 12 if hd == 64 else 16
                bhw = ops._bias_halves(q, rh, rw, side, side, out_scale=hd ** 0.5)
                yield (label,
                       lambda: ops.relpos_attention_windowed(
                           q, k, v, bhw, side, side, heads, True, 5, 8),
                       lambda: ops.attention_relpos_plain(
                           q, k, v, bhw, side, side, folded=True, heads=heads,
                           n_w=5, valid_rows=8))
        elif kind == "K6":
            grid, heads, hd = dims
            C = heads * hd
            qkv = f16((1, grid, grid, 3 * C))
            q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
            rh, rw = (f16((14, 14, hd), 0.3) for _ in range(2))
            yield (label,
                   lambda: ops.windowed_attention_fused(q, k, v, rh, rw, ws=14,
                                                        num_heads=heads),
                   lambda: ops.windowed_attention_fused_plain(
                       q, k, v, rh, rw, ws=14, num_heads=heads))
        else:
            W, nh, hd = dims
            qkv, bhw = f16((W, 3, nh, 196, hd)), f16((W * nh, 196, 28))
            yield (label, lambda: ops.relpos_attention_qkv(qkv, bhw, 14, 14),
                   lambda: ops.windowed_attention_qkv_plain(qkv, bhw, 14, 14))


def measure(build_dir: str) -> dict:
    """Build this process's package into ``build_dir`` and hold each case's
    float16 kernel against its plain version: {label: [max, mean]}."""
    import torch

    import dlimgedit_tpu_torch.ops.cuda_build as cb
    import dlimgedit_tpu_torch.ops.flash_attention as ops

    cb.BUILD_DIR = Path(build_dir)
    cb.LIBRARY.get()
    dev = torch.device("cuda", 0)
    out = {}
    for label, kernel, plain in _cases(torch, ops, dev):
        d = (kernel().float() - plain().float()).abs()
        out[label] = [d.max().item(), d.mean().item()]
    return {"build_seconds": cb.LIBRARY.build_seconds, "diffs": out}


def _run(root: Path, build_dir: Path) -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", f"{PACKAGE}.tools.f16_rounding_check",
         "--measure", str(build_dir)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"the measurement at {root} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--measure", metavar="BUILD_DIR",
                    help="(internal) measure this process's build")
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure(args.measure)))
        return 0
    lines = []
    with tempfile.TemporaryDirectory(prefix="f16-rounding-") as tmp:
        tmp = Path(tmp)
        mutant = make_mutant(tmp / "mutant")
        for build, root in (("this checkout", ROOT), ("p via bf16", mutant)):
            res = _run(root, tmp / f"build-{len(lines)}")
            lines.append(json.dumps({"build": build, **res}))
            print(lines[-1], flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
