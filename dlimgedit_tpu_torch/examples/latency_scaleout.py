"""Single-image latency scale-out: cut per-image latency with devices.

dp (streaming_frames.py) scales throughput; this example scales the
LATENCY of one image, on both workloads:

  * SAM ViT encode: the encoder's token windows shard across an (sp,)
    mesh (`parallel/sp.py`), windowed blocks run on their shard alone,
    and only the global-attention blocks gather the token stream. On the
    GPU the blocks run the float32 kernels K1, K3, K4 and K5.
  * BiRefNet segment_objects: the canvas ROWS shard across the same mesh
    (`parallel/spatial.py`); convs and window attention stay row-local,
    fetching their halo rows from the neighbouring bands.

Both results equal the single-device path within 1e-4 (float32 at full
precision).

Usage:
    python -m dlimgedit_tpu_torch.examples.latency_scaleout          # vit_b over all GPUs
    python -m dlimgedit_tpu_torch.examples.latency_scaleout vit_h
"""

import sys

import numpy as np
import torch

from dlimgedit_tpu_torch.models import sam as sam_lib
from dlimgedit_tpu_torch.models.common import full_precision
from dlimgedit_tpu_torch.parallel.mesh import cuda_devices
from dlimgedit_tpu_torch.parallel.sp import encode_image_sp, make_sp_mesh


def main(variant="vit_b", image_size=1024, devices=None, cfg=None,
         params=None):
    """`image_size`/`devices`/`cfg`/`params` are injectable so the test
    suite can execute this example end-to-end at a tiny size
    (test_torch_examples.py); run as a script it uses the full preset.
    `devices` defaults to every CUDA device (fewer than one raises)."""
    devices = list(cuda_devices() if devices is None else devices)
    mesh = make_sp_mesh(len(devices), devices=devices)
    print(f"sp mesh: {dict(mesh.shape)}")
    dev = mesh.first_device

    if cfg is None:
        cfg = sam_lib.make_config(variant, image_size=image_size)
        if dev.type == "cuda":
            cfg = sam_lib.with_kernels(cfg)
    if params is None:
        params = sam_lib.init_sam(torch.Generator().manual_seed(0), cfg)
    params.to(dev).eval().requires_grad_(False)

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(
        (1, cfg.image_size, cfg.image_size, 3)), dtype=torch.float32,
        device=dev)

    emb = encode_image_sp(params, cfg, x, mesh=mesh)
    with torch.no_grad(), full_precision():
        ref = sam_lib.encode_image(params, cfg, x)
    err = float((emb - ref).abs().max())
    print(f"embedding {tuple(emb.shape)}; max|sp - single| = {err:.2e}")
    assert err < 1e-4
    return emb


def main_birefnet(image_size=None, devices=None, bcfg=None, bparams=None):
    """Row-sharded segment_objects over the same 1-D mesh (injectable for
    the hermetic example test, like main)."""
    from dlimgedit_tpu_torch.models import birefnet
    from dlimgedit_tpu_torch.parallel.spatial import (make_spatial_mesh,
                                                      segment_image_spatial)

    devices = list(cuda_devices() if devices is None else devices)
    mesh = make_spatial_mesh(len(devices), devices=devices)
    dev = mesh.first_device
    if bcfg is None:
        bcfg = birefnet.BiRefNetConfig(img_size=image_size or 1024)
    if bparams is None:
        bparams = birefnet.init_birefnet(torch.Generator().manual_seed(1),
                                         bcfg)
    bparams.to(dev).eval().requires_grad_(False)

    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal(
        (1, bcfg.img_size, bcfg.img_size, 3)), dtype=torch.float32,
        device=dev)
    logits = segment_image_spatial(bparams, bcfg, x, mesh)
    with torch.no_grad(), full_precision():
        ref = birefnet.birefnet_apply(bparams, x, bcfg)
    err = float((logits - ref).abs().max())
    print(f"birefnet logits {tuple(logits.shape)}; "
          f"max|spatial - single| = {err:.2e}")
    assert err < 1e-4
    return logits


if __name__ == "__main__":
    main(*sys.argv[1:2])
    main_birefnet()
