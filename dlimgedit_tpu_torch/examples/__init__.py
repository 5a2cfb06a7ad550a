"""The examples of the JAX package's ``examples/`` on the port, one module
each, with the same ``main`` and injectable arguments:

    python -m dlimgedit_tpu_torch.examples.interactive_segmentation photo.png 320 210 mask.png
    python -m dlimgedit_tpu_torch.examples.generate_masks photo.png masks/
    python -m dlimgedit_tpu_torch.examples.foreground_extraction photo.png cutout.png
    python -m dlimgedit_tpu_torch.examples.streaming_frames
    python -m dlimgedit_tpu_torch.examples.latency_scaleout [vit_b|vit_h]
    python -m dlimgedit_tpu_torch.examples.distill_encoder [vit_b|vit_h]
    python -m dlimgedit_tpu_torch.examples.finetune_decoder /tmp/ckpts
    python -m dlimgedit_tpu_torch.examples.multihost_train [ckpt_dir] \\
        [--coordinator host:port --num-processes N --process-id I]

Run from the repo root. Each runs on the GPU and raises without one: the
CPU runs only when the caller asks for it (``options=`` with
``Backend.cpu``, or ``devices=[torch.device("cpu")] * n``), as the tests
do.
"""
