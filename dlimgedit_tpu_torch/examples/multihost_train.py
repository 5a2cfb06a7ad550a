"""Multi-host fine-tuning: one process per host, dp across hosts.

The same script is every worker; tp stays inside each host and the only
cross-host collective is the per-step all-reduce of the loss and the
gradients (`torch.distributed`: NCCL between GPUs, gloo between CPUs).
Batches flow through the prefetch-to-device loader so the host-to-device
copy rides under device compute, and the checkpoint at the end is
collective (rank 0 writes, every rank waits for it).

Usage, two workers on one machine:

    python -m dlimgedit_tpu_torch.examples.multihost_train --coordinator localhost:9911 \\
        --num-processes 2 --process-id 0 /tmp/mh_ckpts &
    python -m dlimgedit_tpu_torch.examples.multihost_train --coordinator localhost:9911 \\
        --num-processes 2 --process-id 1 /tmp/mh_ckpts

Single-process (no flags) it degenerates to the plain mesh run.
"""

import argparse

import numpy as np
import torch

from dlimgedit_tpu_torch.models import sam as sam_lib
from dlimgedit_tpu_torch.parallel import multihost as mh
from dlimgedit_tpu_torch.train.checkpoint import save_train_state
from dlimgedit_tpu_torch.train.data import prefetch_to_device, sam_batch_iterator
from dlimgedit_tpu_torch.train.step import (
    TrainConfig,
    init_train_state,
    make_train_step,
    place_train_state,
)


def main(argv=None, n_steps=3, devices=None):
    """`argv`/`n_steps`/`devices` injectable so the test suite executes this
    end-to-end on CPU device lists (test_torch_examples.py). `devices` is
    this process's (default its CUDA devices; none raises)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt_dir", nargs="?", default="/tmp/dlimg_mh_ckpts")
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    args = ap.parse_args(argv)

    if args.num_processes > 1:
        mh.initialize(args.coordinator, args.num_processes, args.process_id)
    mesh = mh.global_mesh(devices=devices)
    print(f"rank {args.process_id}: mesh {dict(mesh.shape)} over "
          f"{mesh.size} devices / {args.num_processes} processes")

    cfg = sam_lib.make_config("mobile_sam", image_size=64)  # demo-sized
    tcfg = TrainConfig(learning_rate=3e-4)
    params = sam_lib.init_sam(torch.Generator().manual_seed(0), cfg)
    opt_state = init_train_state(params, tcfg)
    train_step = make_train_step(cfg, tcfg)

    B = 2 * mesh.shape["dp"]
    # Every rank generates the identical global batch stream (same seed);
    # the loader's dp-sharded placement moves only this rank's rows.
    batches = list(sam_batch_iterator(np.random.default_rng(0), batch_size=B,
                                      image_size=64,
                                      mask_size=cfg.mask_input_size,
                                      steps=n_steps))
    params, opt_state, first = place_train_state(params, opt_state,
                                                 batches[0], mesh)
    params, opt_state, loss, _ = train_step(params, opt_state, first)
    print(f"rank {args.process_id} step 0: loss {float(loss):.4f}")
    step = 1
    for batch in prefetch_to_device(iter(batches[1:]), depth=2, mesh=mesh):
        params, opt_state, loss, _ = train_step(params, opt_state, batch)
        print(f"rank {args.process_id} step {step}: "
              f"loss {float(loss):.4f}")
        step += 1

    save_train_state(args.ckpt_dir, step, params, opt_state)
    print(f"rank {args.process_id}: collective checkpoint at step {step}")


if __name__ == "__main__":
    main()
