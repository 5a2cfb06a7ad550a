"""Many prompts against one embedding (counterpart of
dlimgedit_tpu/parallel/batch.py::decode_prompt_batch; its
``encode_frames`` and ``segment_frames`` come with the parallel tier).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models import sam as sam_lib


def decode_prompt_batch(model: sam_lib.Sam, cfg: sam_lib.SamConfig,
                        embedding: torch.Tensor, point_coords: torch.Tensor,
                        point_labels: torch.Tensor, multimask: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode N prompts against ONE embedding in one batched pass.

    embedding: (1, He, We, C); point_coords: (N, P, 2); point_labels:
    (N, P). Returns (masks (N, T, 4He, 4We), iou (N, T)), T = 4 with
    ``multimask``, else 1 (the single-mask selection). The embedding is
    broadcast (``expand``), not copied N times."""
    n = point_coords.shape[0]
    return sam_lib.decode_masks(model, cfg,
                                embedding.expand(n, *embedding.shape[1:]),
                                point_coords, point_labels, multimask=multimask)
