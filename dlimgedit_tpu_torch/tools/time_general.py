"""The general attention body of this checkout and of another, on one GPU.

    python3 -m dlimgedit_tpu_torch.tools.time_general [--parent DIR]
        [--variants design,...] [--dtypes bfloat16,float16,float32]
        [--kernels K2,K4,K5,K7,K6] [--samples N] [--once]

Builds csrc/attention_general*.cu (the general body, csrc/
attention_general.cuh, in each dtype) with a small C entry point of its
own, `general_shim`, which fills the body's GeneralArgs as the kernels'
entry points do (levit_attention.cu, relpos_attention.cu,
window_strip_attention.cu) and calls `attention_general`; with --parent
DIR, DIR/dlimgedit_tpu_torch/csrc/ likewise (e.g. an unpacked parent
commit), and each of --variants (VARIANTS: this checkout's body with one
edit (every place it occurs), to see what a part of it costs; no_bias and no_pv compute something
else and are timed, not held), each source its own nvcc, all started
together. At chip_smoke.py's
phase 20 geometries (GENERAL_K2, _K4, _K5, _K7, _K6) in each dtype it holds
every build against the plain version (ops/flash_attention.py; TF32 off;
chip_smoke.py's TOL, float16's mean |diff| too) and times it: CUDA events
around 10 launches behind a spin kernel, the median of N samples, the
builds in turn and then in reverse order (each time the mean of its two),
beside F.scaled_dot_product_attention with the materialised float bias
(chip_smoke.py's yardstick) and the bound of chip_smoke.py's rule (bytes
at 3.35 TB/s; products at 989 TFLOP/s in 16 bits, at a third of 495 in
float32; other float32 operations at 67 TFLOP/s). Prints each build's
general-kernel instances with their registers and spills (nvcc -Xptxas
-v). With --once each build launches each case once after its check and
nothing is timed: the run to give a profiler (ncu --kernel-name
regex:attention_general ...). Needs CUDA and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

from ..ops import cuda_build
from ..ops.flash_attention import (
    _bias_halves,
    attention_relpos_plain,
    levit_window_attention_plain,
    windowed_attention_fused_plain,
    windowed_attention_qkv_plain,
)
from .sweep_layer_norm import time_us

# chip_smoke.py's phase 20 geometries.
GENERAL_K2 = (4, 1024, 5, 32)        # G, N, heads, kd
GENERAL_K4 = (8, 64, 36)             # heads, grid, hd
GENERAL_K5 = (25, 8, 14, 36, 5, 8)   # windows, heads, ws, hd, n_w, valid_rows
GENERAL_K7 = (25, 8, 14, 136)        # windows, heads, ws, hd
GENERAL_K6 = (1, 64, 8, 36, 16)      # B, grid, heads, hd, ws
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 4e-3}
STRIP_F16_TOL = 5e-3
F16_MEAN_TOL = 2e-5
HBM_BYTES_PER_S = 3.35e12
PEAK_16_TC_FLOPS = 989e12
PEAK_F32_TC_FLOPS = 495e12 / 3
PEAK_F32_FLOPS = 67e12
CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
POLICY = {"K2": 0, "K4": 1, "K5": 1, "K7": 1, "K6": 2}

# Variant -> [(text in csrc/attention_general.cuh, its replacement)].
VARIANTS = {
    "design": [],
    # the scores without their bias (no halves or table read a score)
    "no_bias": [
        ("        x = __fadd_rn(__fmul_rn(x, a.scale), b);\n      } else {",
         "        x = __fmul_rn(x, a.scale);\n      } else {"),
        ("x = __fadd_rn(__fadd_rn(__fmul_rn(x, a.scale), to_float(h[p.x])),\n"
         "                        to_float(h[a.gh + p.y]));", "x = __fmul_rn(x, a.scale);"),
        ("const float b = __fadd_rn(to_float(h[p.x]), to_float(h[a.gh + p.y]));",
         "const float b = 0.f;"),
    ],
    # a three-stage key pipeline (two chunks' copies in flight)
    "stages3": [("constexpr int kGenStages = 2;", "constexpr int kGenStages = 3;")],
    # the key pipeline, the q and bias staging and the stores alone (no warp
    # computes)
    "pipe_only": [("    if (!active) continue;", "    if (true) continue;")],
    # pipe_only with three stages
    "pipe3": [("    if (!active) continue;", "    if (true) continue;"),
              ("constexpr int kGenStages = 2;", "constexpr int kGenStages = 3;")],
    # pipe_only without the output's stores
    "pipe_noout": [("    if (!active) continue;", "    if (true) continue;"),
                   ("  const bool pairs = a.vec >= 2", "  if (true) return;\n  const bool pairs = a.vec >= 2")],
    # pipe_only without the chunks' copies (the prologue, barriers and stores)
    "pipe_nocopy": [("    if (!active) continue;", "    if (true) continue;"),
                    ("    if (i + kGenStages - 1 < items) issue(i + kGenStages - 1);", "")],
    # no q . k products (the scores from zero)
    "no_qk": [("      general_qk<T, KT>(s, ", "      if (false) general_qk<T, KT>(s, ")],
    # q . k's depth steps on two accumulator sets (even, odd), added at the end
    "qk2": [("""    for (int st = 0; st < steps; ++st) {
      uint32_t a[4];
      ldsm_x4(a, qa + 16 * st);
#pragma unroll
      for (int jp = 0; jp < KT / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, kb + 16 * jp * qp + 16 * st);
        Half2<T>::mma(s[2 * jp], a, b[0], b[1]);
        Half2<T>::mma(s[2 * jp + 1], a, b[2], b[3]);
      }
    }""", """    float t[KT][4] = {};
    int st = 0;
    for (; st + 1 < steps; st += 2) {
      uint32_t a[4], a2[4];
      ldsm_x4(a, qa + 16 * st);
      ldsm_x4(a2, qa + 16 * st + 16);
#pragma unroll
      for (int jp = 0; jp < KT / 2; ++jp) {
        uint32_t b[4], b2[4];
        ldsm_x4(b, kb + 16 * jp * qp + 16 * st);
        ldsm_x4(b2, kb + 16 * jp * qp + 16 * st + 16);
        Half2<T>::mma(s[2 * jp], a, b[0], b[1]);
        Half2<T>::mma(s[2 * jp + 1], a, b[2], b[3]);
        Half2<T>::mma(t[2 * jp], a2, b2[0], b2[1]);
        Half2<T>::mma(t[2 * jp + 1], a2, b2[2], b2[3]);
      }
    }
    if (st < steps) {
      uint32_t a[4];
      ldsm_x4(a, qa + 16 * st);
#pragma unroll
      for (int jp = 0; jp < KT / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, kb + 16 * jp * qp + 16 * st);
        Half2<T>::mma(s[2 * jp], a, b[0], b[1]);
        Half2<T>::mma(s[2 * jp + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += t[j][e];""")],
    # no p . v products (p still formed)
    "no_pv": [
        ("general_pv16<T, NT>(o, pa, vs, y.vp, y.vw, kk, lane);",
         "o[0][0] += __uint_as_float(pa[0] ^ pa[1] ^ pa[2] ^ pa[3]);"),
    ],
    # 64-key chunks at every width
    "kc64": [
        ("(GenTile<T>::kF32 ? NT >= 16 || POL == kGenLevit : NT >= 32) ? 32 : 64;",
         "GenTile<T>::kF32 && NT >= 16 ? 32 : 64;"),
    ],
    # blocks of 2 warps (32 query rows)
    "warps2": [("constexpr int kGenWarps = 4;", "constexpr int kGenWarps = 2;")],
}
UNCHECKED = ("no_bias", "no_pv", "no_qk", "pipe_only", "pipe3", "pipe_noout", "pipe_nocopy")

SHIM = r"""
#include "attention_general.cuh"
extern "C" int general_shim(int policy, int dtype, const void* q, const void* k, const void* v,
                            const void* bias, const void* bias2, void* out, long long groups,
                            int n, int hd, int gh, int gw, int nh, int g_skip, int n_valid,
                            int folded, int hp, int wp, int ts, int c, float scale,
                            long long stride, void* stream) {
  dlimg::GeneralArgs a{};
  a.q = q; a.k = k; a.v = v; a.bias = bias; a.bias2 = bias2; a.out = out;
  a.groups = groups; a.n = n; a.hd = hd; a.gh = gh; a.gw = gw; a.nh = nh;
  a.g_skip = g_skip; a.n_valid = n_valid; a.folded = folded;
  a.hp = hp; a.wp = wp; a.ts = ts; a.c = c; a.scale = scale;
  a.vec = dlimg::general_vec(dtype == dlimg::kDtypeF32 ? 4 : 2, hd, stride, q, k, v);
  return dlimg::attention_general(a, policy, dtype, static_cast<cudaStream_t>(stream));
}
"""
_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SHIM_ARGS = [_I, _I] + [_VP] * 6 + [_LL] + [_I] * 12 + [_F, _LL, _VP]


def build(work: Path, origins: dict) -> dict:
    """name -> (ctypes library, ptxas lines of its general instances); a
    name of VARIANTS takes its edits."""
    nvcc = cuda_build._nvcc()
    jobs = {}
    for name, origin in origins.items():
        src = work / name
        shutil.copytree(origin, src, ignore=shutil.ignore_patterns("*.cpp"))
        for old, new in VARIANTS.get(name, ()):
            body = src / "attention_general.cuh"
            text = body.read_text()
            if old not in text:
                raise SystemExit(f"time_general: {old!r} is not in the body")
            body.write_text(text.replace(old, new))
        (src / "general_shim.cu").write_text(SHIM)
        units = sorted(src.glob("attention_general*.cu")) + [src / "general_shim.cu"]
        jobs[name] = [(u, src / (u.stem + ".o"), subprocess.Popen(
            [nvcc, *cuda_build.COMPILE_FLAGS, "-c", str(u), "-o", str(src / (u.stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for u in units]
    libs = {}
    for name, units in jobs.items():
        log = []
        for unit, _, proc in units:
            out, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"time_general: nvcc failed on {name}/{unit.name}:\n{out}")
            log.append(out)
        lib_path = work / f"{name}.so"
        subprocess.run([nvcc, *cuda_build.ARCH_FLAGS, "-shared", "-o", str(lib_path),
                        *(str(obj) for _, obj, _ in units)], check=True,
                       capture_output=True, text=True)
        lib = ctypes.CDLL(str(lib_path))
        lib.general_shim.argtypes = SHIM_ARGS
        lib.general_shim.restype = ctypes.c_int
        libs[name] = (lib, ptxas_lines("\n".join(log)))
    return libs


def ptxas_lines(log: str) -> list:
    rows, kernel, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?attention_general_kernelI(\w*?)EEv", line)
        if m:
            targs = m.group(1)
            dtype = ("bf16" if "bfloat16" in targs else "f16" if "__half" in targs else "f32")
            kernel, spill, frame = (
                f"{dtype} <{','.join(re.findall(r'L[ib](\d+)E', targs))}>", 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and kernel:
            frame, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            rows.append(f"{kernel}: {m.group(1)} registers, {spill} bytes spilled"
                        + (f", {frame} bytes stack frame" if frame else ""))
            kernel = None
    return rows


def relpos_mask(bhw, gh, gw, folded, scale):
    tok = torch.arange(gh * gw, device=bhw.device)
    bias = bhw[:, :, :gh][:, :, tok // gw] + bhw[:, :, gh:][:, :, tok % gw]
    return bias * scale if folded else bias


def cases(dev, gen, dtype):
    """(label, kind, shim arguments with None for the output, plain output,
    SDPA call, bytes, products, other operations, tensors kept alive)."""
    es = torch.empty((), dtype=dtype).element_size()

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    G, N, nh, kd = GENERAL_K2
    qkv, bias = randn(G, N, nh * 3 * kd), randn(nh, N, N, scale=0.5)
    q5 = qkv.view(G, N, nh, 3, kd)
    lq, lk, lv = (q5[:, :, :, i].transpose(1, 2) for i in range(3))
    yield (f"K2 ({G},{N},{nh * 3 * kd}) nh={nh}", "K2",
           dict(q=qkv, k=qkv, v=qkv, bias=bias, groups=G * nh, n=N, hd=kd, nh=nh,
                scale=kd ** -0.5, stride=3 * nh * kd),
           levit_window_attention_plain(qkv, bias, nh),
           lambda: F.scaled_dot_product_attention(lq, lk, lv,
                                                  attn_mask=bias[None].expand(G, nh, N, N)),
           (G * N * nh * 4 * kd + nh * N * N) * es, 4 * G * nh * N * N * kd,
           7 * G * nh * N * N, (qkv, bias))

    nh, g, hd = GENERAL_K4
    N = g * g
    q, k, v = (randn(nh, N, hd) for _ in range(3))
    rh, rw = (0.3 * torch.randn((g, g, hd), generator=gen, device=dev) for _ in range(2))
    bhw = _bias_halves(q, rh, rw, g, g)
    mask = relpos_mask(bhw, g, g, False, 1.0).to(dtype)
    yield (f"K4 ({nh},{N},{hd})", "K4",
           dict(q=q, k=k, v=v, bias=bhw, groups=nh, n=N, hd=hd, gh=g, gw=g, g_skip=nh,
                n_valid=N, scale=hd ** -0.5, stride=hd),
           attention_relpos_plain(q, k, v, bhw, g, g),
           lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                  attn_mask=mask[None]),
           (4 * nh * N * hd + nh * N * 2 * g) * es, 4 * nh * N * N * hd, 7 * nh * N * N,
           (q, k, v, bhw, mask))

    W, nh, ws, hd, n_w, valid = GENERAL_K5
    N, G, scale = ws * ws, W * nh, hd ** -0.5
    folded = hd + 2 * ws <= 128
    q, k, v = (randn(G, N, hd) for _ in range(3))
    rh, rw = (0.3 * torch.randn((ws, ws, hd), generator=gen, device=dev) for _ in range(2))
    bhw = _bias_halves(q, rh, rw, ws, ws, out_scale=1.0 / scale if folded else 1.0)
    mask = relpos_mask(bhw, ws, ws, folded, scale).to(dtype)
    rows = (W - n_w) * nh * N + n_w * nh * valid * ws
    yield (f"K5 ({G},{N},{hd}) n_w={n_w} valid_rows={valid}", "K5",
           dict(q=q, k=k, v=v, bias=bhw, groups=G, n=N, hd=hd, gh=ws, gw=ws,
                g_skip=(W - n_w) * nh, n_valid=valid * ws, folded=int(folded), scale=scale,
                stride=hd),
           attention_relpos_plain(q, k, v, bhw, ws, ws, folded=folded, heads=nh, n_w=n_w,
                                  valid_rows=valid),
           lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                  attn_mask=mask[None]),
           (2 * G * N * hd + rows * (hd + 2 * ws) + G * N * hd) * es, 4 * rows * N * hd,
           7 * rows * N, (q, k, v, bhw, mask))

    W, nh, ws, hd = GENERAL_K7
    n, G = ws * ws, W * nh
    qkv7 = randn(W, 3, nh, n, hd)
    rh, rw = (0.3 * torch.randn((ws, ws, hd), generator=gen, device=dev) for _ in range(2))
    bhw7 = _bias_halves(qkv7[:, 0].reshape(G, n, hd), rh, rw, ws, ws)
    mask7 = relpos_mask(bhw7, ws, ws, False, 1.0).to(dtype).view(W, nh, n, n)
    yield (f"K7 ({W},3,{nh},{n},{hd})", "K7",
           dict(q=qkv7, k=qkv7, v=qkv7, bias=bhw7, groups=G, n=n, hd=hd, gh=ws, gw=ws, nh=nh,
                g_skip=G, n_valid=n, scale=hd ** -0.5, stride=hd),
           windowed_attention_qkv_plain(qkv7, bhw7, ws, ws).reshape(G, n, hd),
           lambda: F.scaled_dot_product_attention(qkv7[:, 0], qkv7[:, 1], qkv7[:, 2],
                                                  attn_mask=mask7),
           (4 * G * n * hd + G * n * 2 * ws) * es, 4 * G * n * n * hd, 7 * G * n * n,
           (qkv7, bhw7, mask7))

    B, grid, nh, hd, ws = GENERAL_K6
    C, n, nw = nh * hd, ws * ws, grid // ws
    G = B * nw * nw * nh
    qkv6 = randn(B, grid, grid, 3 * C)
    q, k, v = qkv6[..., :C], qkv6[..., C:2 * C], qkv6[..., 2 * C:]
    rh, rw = (randn(ws, ws, hd, scale=0.3) for _ in range(2))
    parts = qkv6.view(B, nw, ws, nw, ws, 3, nh, hd).permute(
        5, 0, 1, 3, 6, 2, 4, 7).reshape(3, G, n, hd)
    mask6 = relpos_mask(_bias_halves(parts[0], rh, rw, ws, ws), ws, ws, False, 1.0).to(dtype)
    yield (f"K6 ({B},{grid},{grid},{C}) ws={ws}", "K6",
           dict(q=q, k=k, v=v, bias=rh, bias2=rw, groups=G, n=n, hd=hd, gh=ws, gw=ws, nh=nh,
                hp=grid, wp=grid, ts=3 * C, c=C, scale=hd ** -0.5, stride=3 * C),
           windowed_attention_fused_plain(q, k, v, rh, rw, ws=ws, num_heads=nh),
           lambda: F.scaled_dot_product_attention(parts[0][None], parts[1][None],
                                                  parts[2][None], attn_mask=mask6[None]),
           (4 * B * grid * grid * C + 2 * ws * ws * hd) * es,
           4 * G * n * n * hd + 4 * G * n * ws * hd, 7 * G * n * n,
           (qkv6, rh, rw, parts, mask6))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout's root, built as 'parent'")
    ap.add_argument("--variants", default="design",
                    help=f"comma-separated, of {', '.join(VARIANTS)}")
    ap.add_argument("--dtypes", default="bfloat16,float16,float32")
    ap.add_argument("--kernels", default="K2,K4,K5,K7,K6")
    ap.add_argument("--samples", type=int, default=10)
    ap.add_argument("--once", action="store_true",
                    help="launch each case once a build, untimed (for a profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_general: needs a CUDA device", file=sys.stderr)
        return 2
    names = [n for n in args.variants.split(",") if n]
    if set(names) - set(VARIANTS):
        raise SystemExit(f"time_general: unknown variants {sorted(set(names) - set(VARIANTS))}")
    origins = {name: cuda_build.CSRC_DIR for name in names}
    if args.parent is not None:
        origins = {"parent": args.parent / "dlimgedit_tpu_torch" / "csrc", **origins}
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="time-general-", dir=cuda_build.BUILD_DIR))
    dev = torch.device("cuda", 0)
    try:
        libs = build(work, origins)
        for name, (_, lines) in libs.items():
            print(f"{name}: " + "; ".join(lines), flush=True)
        for dname in args.dtypes.split(","):
            dtype = getattr(torch, dname)
            gen = torch.Generator(device=dev).manual_seed(30)
            print(f"{gpu}; {dname}; ms a launch (median of {args.samples} x 10, each "
                  f"build the mean of two turns)", flush=True)
            for label, kind, kw, want, sdpa, nbytes, mm, other, keep in cases(dev, gen, dtype):
                if kind not in args.kernels.split(","):
                    continue
                out = torch.empty(want.shape, dtype=dtype, device=dev)
                stream = torch.cuda.current_stream().cuda_stream
                p = {key: (t.data_ptr() if isinstance(t, torch.Tensor) else t)
                     for key, t in kw.items()}
                cargs = [POLICY[kind], CODES[dtype], p["q"], p["k"], p["v"], p["bias"],
                         p.get("bias2"), out.data_ptr(), p["groups"], p["n"], p["hd"],
                         p.get("gh", 0), p.get("gw", 0), p.get("nh", 0), p.get("g_skip", 0),
                         p.get("n_valid", 0), p.get("folded", 0), p.get("hp", 0),
                         p.get("wp", 0), p.get("ts", 0), p.get("c", 0), p["scale"],
                         p["stride"], stream]
                tol = STRIP_F16_TOL if kind == "K6" and dtype == torch.float16 else TOL[dtype]
                calls, errs = {}, {}
                for name, (lib, _) in libs.items():
                    def call(lib=lib, name=name):
                        rc = lib.general_shim(*cargs)
                        if rc:
                            raise SystemExit(f"time_general: {name} {label} failed: {rc}")
                    out.fill_(float("nan"))
                    call()
                    torch.cuda.synchronize()
                    d = (out.float() - want.float()).abs()
                    err, mean = d.max().item(), d.mean().item()
                    if name in UNCHECKED:
                        pass
                    elif not err <= tol or (dtype == torch.float16
                                            and not mean <= F16_MEAN_TOL):
                        raise SystemExit(f"time_general: {name} {label} {dname}: max|diff| "
                                         f"{err}, mean {mean} (atol {tol})")
                    calls[name], errs[name] = call, (err, mean)
                if args.once:
                    print(f"{label} {dname}: " + "; ".join(
                        f"{n} max|diff| {e[0]:.1e}" for n, e in errs.items()), flush=True)
                    continue
                times = dict.fromkeys(calls, 0.0)
                for name in [*calls, *reversed(calls)]:
                    times[name] += time_us(calls[name], args.samples) / 2e3
                lib_ms = time_us(sdpa, args.samples) / 1e3
                half = dtype != torch.float32
                ops_ms = (mm / (PEAK_16_TC_FLOPS if half else PEAK_F32_TC_FLOPS)
                          + other / PEAK_F32_FLOPS) * 1e3
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                bound = max(ops_ms, bytes_ms)
                print(f"{label} {dname}: " + "; ".join(
                    f"{n} {t:.5f} ({t / lib_ms:.2f}x SDPA, {100 * bound / t:.0f}% of bound; "
                    f"max|diff| {errs[n][0]:.1e}, mean {errs[n][1]:.1e})"
                    for n, t in times.items())
                    + f"; SDPA {lib_ms:.5f}; bound {bound:.5f} "
                    f"({'bytes' if bytes_ms >= ops_ms else 'operations'})", flush=True)
                del out, want, keep, calls
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
