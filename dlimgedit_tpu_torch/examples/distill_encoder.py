"""Distill a big SAM encoder into a small one: the MobileSAM recipe.

The reference's encoder IS a distilled artifact (MobileSAM's TinyViT,
shipped as mobile_sam_image_encoder.onnx); this example is the producer
side: the frozen teacher embeds images dp x tp over the mesh (on the GPU
on its kernels, K1, K3, K4 and K5), the student's encoder trains against
those embeddings under MSE (each dp row's gradients summed), and
`graft_student` assembles the servable model: the teacher's prompt
encoder and mask decoder, unchanged, behind the new small encoder.

Usage:
    python -m dlimgedit_tpu_torch.examples.distill_encoder          # vit_b -> TinyViT demo
    python -m dlimgedit_tpu_torch.examples.distill_encoder vit_h    # the MobileSAM pairing
"""

import sys

import numpy as np
import torch

from dlimgedit_tpu_torch.models import sam as sam_lib
from dlimgedit_tpu_torch.models.common import full_precision
from dlimgedit_tpu_torch.parallel.mesh import cuda_devices, make_mesh
from dlimgedit_tpu_torch.train.distill import (
    DistillConfig,
    graft_student,
    init_distill_state,
    make_distill_step,
    place_distill_state,
    teacher_embeddings,
)


def main(teacher_variant="vit_b", image_size=256, n_steps=4, devices=None,
         teacher_cfg=None, teacher=None):
    """`image_size`/`devices`/`teacher_cfg`/`teacher` are injectable so the
    test suite can run this end-to-end at a tiny size
    (test_torch_examples.py). `devices` defaults to every CUDA device
    (none raises)."""
    devices = list(cuda_devices() if devices is None else devices)
    mesh = make_mesh(len(devices), devices=devices)
    print(f"mesh: {dict(mesh.shape)}")
    dev = mesh.first_device

    if teacher_cfg is None:
        teacher_cfg = sam_lib.make_config(teacher_variant,
                                          image_size=image_size)
        if dev.type == "cuda":
            teacher_cfg = sam_lib.with_kernels(teacher_cfg)
    student_cfg = sam_lib.make_config("mobile_sam",
                                      image_size=teacher_cfg.image_size)
    if teacher is None:
        teacher = sam_lib.init_sam(torch.Generator().manual_seed(0),
                                   teacher_cfg)
    teacher.to(dev).eval().requires_grad_(False)
    student = sam_lib.init_sam(torch.Generator().manual_seed(1), student_cfg)

    rng = np.random.default_rng(0)
    B = mesh.shape["dp"] * 2
    S = teacher_cfg.image_size
    images = torch.as_tensor(rng.standard_normal((B, S, S, 3)),
                             dtype=torch.float32)

    # Teacher pass: frozen, dp x tp over the mesh; in a real run these are
    # precomputed once over the dataset and stored.
    emb = teacher_embeddings(teacher, teacher_cfg, images.to(dev), mesh=mesh)
    batch = {"images": images, "teacher_emb": emb}

    tcfg = DistillConfig(learning_rate=1e-3)
    step = make_distill_step(student_cfg, tcfg)
    enc = student.encoder
    opt = init_distill_state(enc, tcfg)
    enc, opt, batch = place_distill_state(enc, opt, batch, mesh)
    for i in range(n_steps):
        enc, opt, loss, _ = step(enc, opt, batch)
        print(f"step {i}: mse {float(loss):.5f}")

    grafted = graft_student(enc, teacher)
    g = student_cfg.prompt.image_embedding_size
    with torch.no_grad(), full_precision():
        out = sam_lib.encode_image(grafted, student_cfg, images[:1].to(dev))
    assert out.shape == (1, g, g, 256)
    print(f"grafted student serves: embedding {tuple(out.shape)} "
          f"(teacher decoder attached)")


if __name__ == "__main__":
    main(*sys.argv[1:2])
