"""Streaming-frame embedding over a device mesh (BASELINE config 5).

Embeds batches of frames data-parallel over the mesh's devices (tensor-
parallel weights for the big encoders), feeding them through the
prefetch-to-device loader so the next batch's host-to-device copy rides
under the current batch's encode (the production video/burst pattern),
then runs interactive mask edits against the cached frame embedding. On
the GPU each mesh row's encode is a CUDA graph running the TinyViT
kernels K1 and K2.

Usage:
    python -m dlimgedit_tpu_torch.examples.streaming_frames
"""

import numpy as np
import torch

from dlimgedit_tpu_torch.models import sam as sam_lib
from dlimgedit_tpu_torch.models.common import full_precision
from dlimgedit_tpu_torch.parallel.batch import decode_prompt_batch, encode_frames
from dlimgedit_tpu_torch.parallel.mesh import cuda_devices, make_mesh
from dlimgedit_tpu_torch.train.data import prefetch_to_device


def main(image_size=256, devices=None):
    """`image_size`/`devices` are injectable so the test suite can execute
    this example end-to-end at a tiny size (test_torch_examples.py);
    `devices` defaults to every CUDA device (none raises)."""
    devices = list(cuda_devices() if devices is None else devices)
    n = len(devices)
    mesh = make_mesh(n, devices=devices)
    print(f"mesh: {dict(mesh.shape)} over {n} devices")

    cfg = sam_lib.make_config("mobile_sam", image_size=image_size)
    if mesh.first_device.type == "cuda":
        cfg = sam_lib.with_kernels(cfg)
    params = sam_lib.init_sam(torch.Generator().manual_seed(0), cfg)
    params.to(mesh.first_device).eval().requires_grad_(False)

    # A "video" stream: chunks of B frames, preprocessed (see
    # ops/preprocess for real inputs), prefetched dp-sharded onto the mesh.
    B = mesh.shape["dp"] * 2
    rng = np.random.default_rng(0)
    stream = (rng.standard_normal((B, image_size, image_size, 3))
              .astype(np.float32) for _ in range(3))
    embeddings = None
    for chunk in prefetch_to_device(stream, depth=2, mesh=mesh):
        embeddings = encode_frames(params, cfg, chunk, mesh=mesh)
    print("embeddings:", embeddings.shape, "sharding:",
          embeddings.sharding.spec)

    # Interactive edits on frame 0 (row 0 of the mesh's first shard): many
    # prompts, one program.
    _, _, first = embeddings.shards[0]
    dev = first.device
    coords = torch.as_tensor(rng.uniform(0, image_size, (6, 2, 2)),
                             dtype=torch.float32, device=dev)
    labels = torch.tensor([[1.0, -1.0]], device=dev).repeat(6, 1)
    with torch.inference_mode(), full_precision():
        masks, iou = decode_prompt_batch(params, cfg, first[:1], coords,
                                         labels)
    print("masks:", tuple(masks.shape), "predicted IoU:",
          iou[:, 0].cpu().numpy())


if __name__ == "__main__":
    main()
