"""SAM model: image encoder + prompt encoder + mask decoder (counterpart of
dlimgedit_tpu/models/sam.py). This slice ports the MobileSAM variant
(TinyViT-5M encoder); the ViT-B/L/H encoders come with the SAM ViT slice.

Image embeddings are NHWC (B, 64, 64, 256).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..errors import not_in_this_slice
from .mask_decoder import MaskDecoder, MaskDecoderConfig, predict_masks, select_single_mask
from .prompt_encoder import (
    PromptEncoder,
    PromptEncoderConfig,
    dense_pe,
    embed_masks,
    embed_points,
)
from .tinyvit import TinyViT, TinyViTConfig

# SAM pixel normalisation.
SAM_PIXEL_MEAN = (123.675, 116.28, 103.53)
SAM_PIXEL_STD = (58.395, 57.12, 57.375)


@dataclass(frozen=True)
class SamConfig:
    variant: str = "mobile_sam"
    image_size: int = 1024
    encoder_tiny: TinyViTConfig = TinyViTConfig()
    prompt: PromptEncoderConfig = PromptEncoderConfig()
    decoder: MaskDecoderConfig = MaskDecoderConfig()

    @property
    def embedding_size(self) -> int:
        return self.prompt.image_embedding_size

    @property
    def mask_input_size(self) -> int:
        return 4 * self.embedding_size


def make_config(variant: str = "mobile_sam", image_size: int = 1024) -> SamConfig:
    prompt = PromptEncoderConfig(image_embedding_size=image_size // 16,
                                 input_image_size=image_size)
    if variant in ("mobile_sam", "vit_t"):
        return SamConfig(variant="mobile_sam", image_size=image_size,
                         encoder_tiny=TinyViTConfig(img_size=image_size),
                         prompt=prompt)
    if variant in ("vit_b", "vit_l", "vit_h"):
        raise not_in_this_slice(f"SAM variant {variant!r}", "SAM ViT")
    raise ValueError(f"Unknown SAM variant: {variant}")


class Sam(nn.Module):
    """{"encoder", "prompt_encoder", "decoder"}, as the JAX tree."""

    def __init__(self, cfg: SamConfig, gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.encoder = TinyViT(cfg.encoder_tiny, gen)
        self.prompt_encoder = PromptEncoder(cfg.prompt, gen)
        self.decoder = MaskDecoder(cfg.decoder, gen)


def init_sam(gen: torch.Generator, cfg: SamConfig) -> Sam:
    """Random weights from `gen`: the JAX tree's structure, shapes and
    distributions, with torch's random numbers (not jax.random's)."""
    return Sam(cfg, gen)


def encode_image(model: Sam, cfg: SamConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, S, 3) normalised pixels -> (B, S/16, S/16, 256). The
    kernel flags are read from `cfg.encoder_tiny`."""
    return model.encoder(x, cfg.encoder_tiny)


def decode_masks(model: Sam, cfg: SamConfig, image_embedding: torch.Tensor,
                 point_coords: torch.Tensor, point_labels: torch.Tensor,
                 mask_input: Optional[torch.Tensor] = None,
                 has_mask: Optional[torch.Tensor] = None,
                 multimask: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prompt encoder + mask decoder with ONNX-decoder semantics.

    image_embedding: (B, He, We, C); point_coords: (B, N, 2) in padded-image
    pixels; point_labels: (B, N). Returns multimask -> (B, 4, L, L), (B, 4);
    otherwise the ONNX single-mask selection -> (B, 1, L, L), (B, 1)."""
    B = image_embedding.shape[0]
    s = cfg.mask_input_size
    dev, dt = image_embedding.device, image_embedding.dtype
    if has_mask is None:
        fill = torch.zeros if mask_input is None else torch.ones
        has_mask = fill((B,), dtype=dt, device=dev)
    if mask_input is None:
        mask_input = torch.zeros((B, s, s, 1), dtype=dt, device=dev)
    pe = model.prompt_encoder
    sparse = embed_points(pe, cfg.prompt, point_coords, point_labels).to(dt)
    dense = embed_masks(pe, cfg.prompt, mask_input, has_mask)
    image_pe = dense_pe(pe, cfg.prompt)
    masks, iou = predict_masks(model.decoder, image_embedding, image_pe,
                               sparse, dense, cfg.decoder)
    if not multimask:
        masks, iou = select_single_mask(masks, iou,
                                        num_points=point_coords.shape[1])
    return masks, iou
