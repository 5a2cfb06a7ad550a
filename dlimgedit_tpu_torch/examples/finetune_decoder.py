"""Fine-tune SAM on a (dp, tp) mesh with checkpointing.

Shows the full training loop: the train step over the mesh (focal + dice
+ IoU loss), checkpoints (train/checkpoint.py: one file a step, written
atomically), and export of the trained params as a serving bundle the
Environment loads directly (the same .npz serves the JAX package).

Usage:
    python -m dlimgedit_tpu_torch.examples.finetune_decoder /tmp/ckpts
"""

import sys

import numpy as np
import torch

from dlimgedit_tpu_torch.models import sam as sam_lib
from dlimgedit_tpu_torch.parallel.mesh import cuda_devices, make_mesh
from dlimgedit_tpu_torch.train.checkpoint import (
    export_serving_bundle,
    latest_step,
    restore_train_state,
    save_train_state,
)
from dlimgedit_tpu_torch.train.step import (
    TrainConfig,
    init_train_state,
    make_train_step,
    place_train_state,
)


def synthetic_batch(rng, B, img, L):
    return {
        "images": rng.standard_normal((B, img, img, 3)).astype(np.float32),
        "point_coords": rng.uniform(0, img, (B, 2, 2)).astype(np.float32),
        "point_labels": np.tile(np.array([[1.0, -1.0]], np.float32), (B, 1)),
        "masks": (rng.random((B, L, L)) > 0.5).astype(np.float32),
    }


def main(argv=None, bundle_out="models/segmentation/mobile_sam.npz",
         n_steps=5, devices=None):
    """`argv`/`bundle_out`/`n_steps`/`devices` are injectable so the test
    suite can execute this example end-to-end into a tmp dir
    (test_torch_examples.py). `devices` defaults to every CUDA device
    (none raises)."""
    argv = sys.argv[1:] if argv is None else argv
    ckpt_dir = argv[0] if argv else "/tmp/dlimg_ckpts"
    devices = list(cuda_devices() if devices is None else devices)
    mesh = make_mesh(len(devices), devices=devices)
    cfg = sam_lib.make_config("mobile_sam", image_size=64)  # demo-sized
    tcfg = TrainConfig(learning_rate=3e-4)

    params = sam_lib.init_sam(torch.Generator().manual_seed(0), cfg)
    if latest_step(ckpt_dir) is not None:
        params, opt_state, step0 = restore_train_state(ckpt_dir, like=params)
        print(f"resumed from step {step0}")
    else:
        opt_state, step0 = init_train_state(params, tcfg), 0

    train_step = make_train_step(cfg, tcfg)
    rng = np.random.default_rng(step0)
    B = mesh.shape["dp"] * 2

    batch = synthetic_batch(rng, B, 64, cfg.mask_input_size)
    params, opt_state, batch = place_train_state(params, opt_state, batch,
                                                 mesh)
    for step in range(step0, step0 + n_steps):
        params, opt_state, loss, aux = train_step(params, opt_state, batch)
        print(f"step {step}: loss {float(loss):.4f} "
              f"dice {float(aux['dice']):.4f}")

    save_train_state(ckpt_dir, step + 1, params, opt_state)
    export_serving_bundle(params, bundle_out)
    print("checkpointed + exported serving bundle")


if __name__ == "__main__":
    main()
