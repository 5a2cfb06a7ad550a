"""Training (counterpart of dlimgedit_tpu/train): the SAM fine-tuning
step, encoder distillation, the BiRefNet fine-tuning step, the prefetching
loader and checkpoints, on one device or over a mesh (the ``place_*``
functions; ``train.step.place_train_state`` for the SAM step)."""

from .birefnet_step import (
    BiRefNetTrainConfig,
    birefnet_loss,
    init_birefnet_train_state,
    make_birefnet_train_step,
    place_birefnet_train_state,
)
from .data import prefetch_to_device, sam_batch_iterator
from .distill import (
    DistillConfig,
    distill_loss,
    graft_student,
    init_distill_state,
    make_distill_step,
    place_distill_state,
    teacher_embeddings,
)
from .step import (
    TrainConfig,
    init_train_state,
    learning_rate_schedule,
    make_train_step,
    mask_loss,
)

__all__ = ["BiRefNetTrainConfig", "DistillConfig", "TrainConfig",
           "birefnet_loss", "distill_loss", "graft_student",
           "init_birefnet_train_state", "init_distill_state",
           "init_train_state", "learning_rate_schedule",
           "make_birefnet_train_step", "make_distill_step", "make_train_step",
           "mask_loss", "place_birefnet_train_state", "place_distill_state",
           "prefetch_to_device", "sam_batch_iterator", "teacher_embeddings"]
