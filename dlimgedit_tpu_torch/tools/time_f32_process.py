"""Graphed float32 `process_ms` of one checkout's port, kernels on and off, on one GPU.

    python3 dlimgedit_tpu_torch/tools/time_f32_process.py [--root DIR]
        [--paths mobile_sam,vit_b:fused] [--rounds 5]

With ``--root DIR`` the package is imported from DIR (an unpacked checkout
of another commit; default: this checkout), so one chip call can time
parent and change in turns, each in its own process (parent, change,
change, parent). Run it as a script (not with -m) for that.

For each path (`mobile_sam`, `vit_b`, `vit_h`; `vit_b:fused` is ViT-B with
`fused_window_blocks`, whose windowed blocks take K6): two Environments
with compute_dtype float32 and seeded random weights (the ViTs' rel-pos
tables, pos_embed and qkv biases nonzero, as chip_smoke.py seeds them),
one with the encoder kernels on (the default on CUDA) and one with them
off; `process` on a 1024x768 image, 2 calls first (the eager warm-up and
the capture), then N calls a mode, on and off interleaved, each timed by
the host clock around a call that ends in a device synchronise (the
graphed replays). Prints a line per path with the medians, the K2 / K6
launches of one call and the card's name and power limit. chip_smoke.py
phase 4 prints the same `process_ms` for the change alone. Needs CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

PATHS = ("mobile_sam", "vit_b", "vit_b:fused", "vit_h")


def seed_vit_extras(model, seed: int = 0) -> None:
    """chip_smoke.py's seeding of the parameters JAX's init zeroes."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.encoder.named_parameters():
            if name == "pos_embed" or name.endswith(("rel_pos_h", "rel_pos_w",
                                                     "qkv.b")):
                std = 0.5 if name == "pos_embed" else 0.3
                p.copy_((std * torch.randn(p.shape, generator=gen)).to(p.dtype))


def make_env(dl, variant: str, fused: bool, kernels: bool):
    env = dl.Environment(dl.Options(allow_random_weights=True,
                                    compute_dtype="float32",
                                    sam_variant=variant))
    b = env.sam_model(variant)
    if b.cfg.encoder_vit is not None:
        seed_vit_extras(b.model)
        b.cfg = dataclasses.replace(b.cfg, encoder_vit=dataclasses.replace(
            b.cfg.encoder_vit, use_flash_attention=kernels,
            fused_window_blocks=fused and kernels))
    else:
        b.cfg = dataclasses.replace(b.cfg, encoder_tiny=dataclasses.replace(
            b.cfg.encoder_tiny, use_fused_norm=kernels,
            use_flash_attention=kernels))
    return env


def time_path(dl, fa, path: str, rounds: int) -> str:
    variant, _, flag = path.partition(":")
    envs = {mode: make_env(dl, variant, flag == "fused", mode == "on")
            for mode in ("on", "off")}
    pixels = np.random.default_rng(0).integers(0, 256, (768, 1024, 4),
                                               dtype=np.uint8)
    img = dl.Image(dl.Extent(1024, 768), dl.Channels.rgba, pixels)
    wrappers = (fa.levit_window_attention, fa.windowed_attention_fused)
    ms = {"on": [], "off": []}
    for i in range(2 + rounds):
        for mode, env in envs.items():
            before = [w.launches for w in wrappers]
            t = time.perf_counter()
            dl.Segmentation.process(img, env)
            torch.cuda.synchronize()
            if i >= 2:
                ms[mode].append((time.perf_counter() - t) * 1e3)
            if mode == "on":
                launches = [w.launches - b for w, b in zip(wrappers, before)]
    del envs
    torch.cuda.empty_cache()
    return (f"{path}: process_ms float32 1024x768 graphed, kernels on "
            f"{statistics.median(ms['on']):.3f}, off "
            f"{statistics.median(ms['off']):.3f} (medians of {rounds}); K2 / "
            f"K6 launches a call {launches[0]} / {launches[1]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose dlimgedit_tpu_torch is imported")
    ap.add_argument("--paths", default="mobile_sam,vit_b:fused",
                    help=f"comma-separated, of {','.join(PATHS)}")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    paths = [p for p in args.paths.split(",") if p]
    if set(paths) - set(PATHS):
        raise SystemExit(f"time_f32_process: unknown paths "
                         f"{sorted(set(paths) - set(PATHS))}")
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import dlimgedit_tpu_torch as dl
    from dlimgedit_tpu_torch.ops import flash_attention as fa

    if not str(Path(dl.__file__).resolve()).startswith(root):
        raise SystemExit(f"dlimgedit_tpu_torch came from {dl.__file__}, not "
                         f"{root}: run this file as a script")
    if not torch.cuda.is_available():
        raise SystemExit("time_f32_process: needs a CUDA device")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    for path in paths:
        print(f"root {root} on {gpu}: {time_path(dl, fa, path, args.rounds)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
