"""The kernel library's build from scratch, with nvcc's report per kernel
instance, of this checkout and, with --parent, of another.

    python3 -m dlimgedit_tpu_torch.tools.build_report [--parent DIR]
        [--out FILE]

Builds ``ops/cuda_build.py``'s library (one nvcc per source, all started
together, then the link) into a fresh temporary build directory, in a
fresh process, and prints the build's seconds and, per kernel instance,
its registers and bytes of spill stores as ``nvcc -Xptxas -v`` reports
them. With --parent DIR (another checkout, e.g. an unpacked parent commit)
the two build in turns, parent, this, this, parent, so that the two build
times are compared on one machine, the second build of each from a copy
of its package at another path (nvcc's code for a few instances moves
with the hash of an anonymous namespace, which the path enters); then it
prints the instances whose registers or spills differ between a
checkout's two builds, every instance of the parent whose registers and
spills in neither of this checkout's builds match those of either of the
parent's, the count of those that do, and the instances this checkout
adds. ``--out`` also writes the
report and nvcc's whole output to FILE. Needs nvcc (the card's machine).
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

# Run in a fresh process at a checkout's root: that checkout's library,
# built into a new directory; prints one JSON line.
_BUILD = """
import json, sys
from pathlib import Path
sys.path.insert(0, ".")
import dlimgedit_tpu_torch.ops.cuda_build as cb
cb.BUILD_DIR = Path(sys.argv[1])
cb.LIBRARY.get()
print(json.dumps({"seconds": cb.LIBRARY.build_seconds, "log": cb.LIBRARY.build_log}))
"""


def nvcc_report(build_log: str):
    """nvcc's per-kernel lines, (source, kernel, template arguments,
    registers, spill store bytes), from the -Xptxas -v log of the build.
    The template arguments are the element type (bf16, f16 or f32, where
    the kernel has one) and the integer and bool arguments."""
    rows, source, kernel = [], None, None
    for line in build_log.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.search(r"([a-z_]+_kernel(?:_f32tc|_tc)?)I(.*)EEv",
                             m.group(1))
            if name:
                targs = name.group(2)
                dtype = ("bf16 " if "bfloat16" in targs
                         else "f16 " if "__half" in targs
                         else "f32 " if (targs.startswith("f")
                                         or name.group(1).endswith("_f32tc"))
                         else "")
                kernel = (name.group(1), dtype + ",".join(
                    re.findall(r"L[ib](\d+)E", targs)))
            else:  # no template: the name without its namespaces
                plain = re.search(r"\d([a-z_]+_kernel)E", m.group(1))
                kernel = (plain.group(1) if plain else m.group(1), "")
            spill = None
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and kernel:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            rows.append((source, kernel[0], kernel[1], int(m.group(1)), spill))
            kernel = None
    return rows


def _key(source, kernel, targs):
    """An instance's identity across checkouts: a tensor-core kernel that
    names no element type is bf16 (before its body took one)."""
    if kernel.endswith("_tc") and not targs.startswith(("bf16", "f16")):
        targs = "bf16 " + targs
    return source, kernel, targs


def build(root: Path, moved: bool = False) -> dict:
    """The library of the checkout at ``root``, built from scratch; with
    ``moved``, from a copy of its package at another path."""
    with tempfile.TemporaryDirectory(prefix="dlimg-build-") as tmp:
        if moved:
            shutil.copytree(root / "dlimgedit_tpu_torch",
                            Path(tmp) / "moved" / "dlimgedit_tpu_torch",
                            ignore=shutil.ignore_patterns("_build"))
            root = Path(tmp) / "moved"
        out = subprocess.run([sys.executable, "-c", _BUILD, f"{tmp}/lib"],
                             cwd=root, capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"the build at {root} failed:\n{out.stdout[-20000:]}"
                         f"\n{out.stderr[-20000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    order = ([("parent", args.parent), ("this", ROOT), ("this", ROOT),
              ("parent", args.parent)] if args.parent else [("this", ROOT)])
    seconds, logs, reports = {}, {}, {}
    for label, root in order:
        moved = label in reports  # a checkout's second build
        b = build(root.resolve(), moved)
        seconds.setdefault(label, []).append(b["seconds"])
        reports.setdefault(label, []).append(
            {_key(s, k, t): (r, sp) for s, k, t, r, sp in nvcc_report(b["log"])})
        logs.setdefault(label, b["log"])
        print(f"build of {label} ({root}{', moved' if moved else ''}): "
              f"{b['seconds']:.2f} s", flush=True)
    lines = [f"build seconds: " + ", ".join(
        f"{label} {' / '.join(f'{s:.2f}' for s in v)} (mean "
        f"{sum(v) / len(v):.2f})" for label, v in seconds.items())]
    for label, (first, *rest) in reports.items():
        for other in rest:
            moved = sorted(k for k in first if other.get(k) != first[k])
            lines.append(f"{label}: {len(moved)} instances differ between its "
                         f"builds at two paths")
            lines += [f"  {' '.join(k)}: {first[k]} / {other.get(k)}"
                      for k in moved]
    this = nvcc_report(logs["this"])
    for source, kernel, targs, regs, spill in this:
        lines.append(f"  {source} {kernel}<{targs}>: {regs} registers, "
                     f"{spill} bytes spill stores")
    if args.parent:
        mine, theirs = reports["this"][0], reports["parent"][0]
        same, changed = 0, []
        for key, val in sorted(theirs.items()):
            seen = {r.get(key) for r in reports["parent"]}
            if mine.get(key) == val or any(r.get(key) in seen
                                           for r in reports["this"]):
                same += 1
            else:
                changed.append(f"  {' '.join(key)}: parent {val}, "
                               f"this {mine.get(key)}")
        added = sorted(set(mine) - set(theirs))
        lines.append(f"parent's instances with the same registers and spills "
                     f"here: {same} of {len(theirs)}; differing: "
                     f"{len(changed)}")
        lines += changed
        lines.append(f"instances this checkout adds: {len(added)}")
        lines += [f"  {' '.join(key)}: {mine[key][0]} registers, "
                  f"{mine[key][1]} bytes spill stores" for key in added]
    print("\n".join(lines), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n\n" + "\n\n".join(
            f"== nvcc output, {label}\n{log}" for label, log in logs.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
