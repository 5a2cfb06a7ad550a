"""Encoder distillation (counterpart of
dlimgedit_tpu/train/distill.py): train a small SAM image encoder (the
student, e.g. MobileSAM's TinyViT) to match a frozen big one's (the
teacher, e.g. SAM ViT-H) neck embeddings under MSE, then graft the
teacher's prompt encoder and mask decoder onto the student, as MobileSAM
was made.

The teacher is inference: ``teacher_embeddings`` runs it through
``parallel/batch.py::encode_frames`` under ``torch.no_grad``, so a teacher
config with the kernel flags on (as the Environment sets them on the card)
runs the port's kernels, one CUDA graph per batch shape. The student step
trains the encoder subtree only, on its plain paths. Over a mesh
(``place_distill_state``) the student is replicated on every dp row (it
is small by construction) and the batch dp-sharded, as in JAX; the step
is train/step.py's mesh step without tp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch import nn

from ..models import sam as sam_lib
from ..parallel.batch import encode_frames
from .step import (
    _on,
    adamw_init,
    adamw_update,
    is_placed,
    learning_rate_schedule,
    leaves,
    loss_and_grads,
    mesh_loss_and_grads,
    place_train_state,
    plain_paths_only,
    run_encoder,
    shadow,
    sync_rows,
)

__all__ = ["DistillConfig", "distill_loss", "graft_student",
           "init_distill_state", "make_distill_step", "place_distill_state",
           "teacher_embeddings"]


@dataclass(frozen=True)
class DistillConfig:
    learning_rate: float = 1e-3  # a student from scratch: pretraining scale
    weight_decay: float = 0.01
    # The schedule of train/step.py's TrainConfig.
    warmup_steps: int = 0
    decay_steps: int = 0
    # Recompute the student's activations in the backward pass.
    remat: bool = False
    # "bfloat16": bf16 shadows of the float32 masters for the forward and
    # backward; gradients return in float32. The MSE stays float32.
    compute_dtype: str = "float32"


def distill_loss(encoder: nn.Module, student_cfg: sam_lib.SamConfig,
                 batch: Dict, tcfg: DistillConfig = DistillConfig(),
                 params: Dict[str, torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MSE of the student's embeddings against the teacher's. ``encoder``:
    the student's image encoder (``Sam.encoder``); ``params``: its leaves
    to use in place of its own. batch: images (B, S, S, 3) preprocessed
    pixels, teacher_emb (B, G, G, 256) frozen teacher embeddings."""
    params = leaves(encoder) if params is None else params
    batch = _on(encoder, batch)
    images = batch["images"]
    if tcfg.compute_dtype == "bfloat16":
        params, images = shadow(params, torch.bfloat16), images.to(torch.bfloat16)
    emb = run_encoder(encoder, student_cfg.encoder_tiny or student_cfg.encoder_vit,
                      params, images, tcfg.remat).float()
    target = batch["teacher_emb"].detach().float()
    mse = torch.mean((emb - target) ** 2)
    return mse, {"mse": mse}


def init_distill_state(encoder: nn.Module,
                       tcfg: DistillConfig = DistillConfig()) -> Dict:
    """AdamW state over the student encoder's leaves."""
    return adamw_init(leaves(encoder), callable(learning_rate_schedule(tcfg)))


def make_distill_step(student_cfg: sam_lib.SamConfig,
                      tcfg: DistillConfig = DistillConfig()):
    """The distillation step over the student's ENCODER: (encoder,
    opt_state, batch) -> (encoder, opt_state, loss, aux), the encoder's
    leaves and ``opt_state`` updated in place. Only the encoder trains;
    the prompt encoder and decoder come from the teacher at graft time."""
    plain_paths_only(student_cfg.encoder_tiny or student_cfg.encoder_vit)
    schedule = learning_rate_schedule(tcfg)

    def step(encoder, opt_state, batch):
        placed = is_placed(batch)
        if placed:
            (loss, aux), grads = mesh_loss_and_grads(
                distill_loss, encoder, student_cfg, batch, tcfg, 1, tp=False)
        else:
            (loss, aux), grads = loss_and_grads(distill_loss, encoder,
                                                student_cfg, batch, tcfg)
        adamw_update(leaves(encoder), grads, opt_state, schedule,
                     tcfg.weight_decay)
        if placed:
            sync_rows(encoder, batch, tp=False)
        return encoder, opt_state, loss, aux

    return step


def place_distill_state(encoder: nn.Module, opt_state: Dict, batch: Dict,
                        mesh):
    """(encoder, opt_state, batch) placed for a step over ``mesh``: the
    student replicated (each dp row's replica is made by the step), the
    batch dp-sharded."""
    return place_train_state(encoder, opt_state, batch, mesh)


def teacher_embeddings(teacher: sam_lib.Sam, teacher_cfg: sam_lib.SamConfig,
                       images: torch.Tensor, mesh=None) -> torch.Tensor:
    """The frozen teacher's embeddings of a batch of preprocessed images,
    float32 and without gradient, through ``encode_frames`` (one CUDA
    graph per batch shape on the card; its kernels when ``teacher_cfg``
    turns them on; over the (dp, tp) ``mesh`` when one is given, the whole
    batch returned on its first device). The images are cast to the
    teacher encoder's dtype."""
    dtype = next(teacher.encoder.parameters()).dtype
    with torch.no_grad():
        emb = encode_frames(teacher, teacher_cfg,
                            torch.as_tensor(images).to(dtype), mesh=mesh)
    return emb.float()


def graft_student(student_encoder: nn.Module, teacher: sam_lib.Sam
                  ) -> sam_lib.Sam:
    """The servable distilled model: a ``Sam`` of the student's encoder and
    the teacher's prompt encoder and mask decoder (MobileSAM's assembly),
    holding those modules themselves, not copies."""
    grafted = nn.Module.__new__(sam_lib.Sam)
    nn.Module.__init__(grafted)
    grafted.encoder = student_encoder
    grafted.prompt_encoder = teacher.prompt_encoder
    grafted.decoder = teacher.decoder
    return grafted
