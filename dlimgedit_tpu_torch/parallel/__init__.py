"""Batched and multi-device execution (counterpart of
dlimgedit_tpu/parallel): batched frames and prompts, the (dp, tp) mesh,
the sequence-parallel ViT, canvas-row sharding of BiRefNet and TinyViT
(``spatial``) and the multi-process tier."""

from .batch import decode_prompt_batch, encode_frames, segment_frames
from .mesh import batch_sharding, make_mesh, sam_param_sharding
from .multihost import (
    global_mesh,
    initialize,
    local_rows,
    process_local_batch,
    replicate_params,
)
from .sp import encode_image_sp, make_sp_mesh, sam_vit_apply_sp
from .spatial import (
    birefnet_apply_spatial,
    make_spatial_mesh,
    segment_image_spatial,
    tinyvit_apply_spatial,
)

__all__ = ["batch_sharding", "birefnet_apply_spatial", "decode_prompt_batch",
           "encode_frames", "encode_image_sp", "global_mesh", "initialize",
           "local_rows", "make_mesh", "make_sp_mesh", "make_spatial_mesh",
           "process_local_batch", "replicate_params", "sam_param_sharding",
           "sam_vit_apply_sp", "segment_frames", "segment_image_spatial",
           "tinyvit_apply_spatial"]
