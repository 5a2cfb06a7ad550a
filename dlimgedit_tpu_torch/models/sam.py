"""SAM model: image encoder + prompt encoder + mask decoder (counterpart of
dlimgedit_tpu/models/sam.py). Variants: "mobile_sam" / "vit_t" (TinyViT-5M
encoder) and "vit_b", "vit_l", "vit_h" (the SAM ViT encoders); the prompt
encoder and decoder are the same for all.

Image embeddings are NHWC (B, 64, 64, 256).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from .mask_decoder import (
    DecoderContext,
    MaskDecoder,
    MaskDecoderConfig,
    decoder_context,
    predict_masks_from,
    select_single_mask,
)
from .prompt_encoder import (
    PromptEncoder,
    PromptEncoderConfig,
    dense_pe,
    embed_masks,
    embed_points,
)
from .tinyvit import TinyViT, TinyViTConfig
from .vit_sam import VIT_PRESETS, SamViT, SamViTConfig

# SAM pixel normalisation.
SAM_PIXEL_MEAN = (123.675, 116.28, 103.53)
SAM_PIXEL_STD = (58.395, 57.12, 57.375)


@dataclass(frozen=True)
class SamConfig:
    variant: str = "mobile_sam"
    image_size: int = 1024
    encoder_tiny: Optional[TinyViTConfig] = None
    encoder_vit: Optional[SamViTConfig] = None
    prompt: PromptEncoderConfig = PromptEncoderConfig()
    decoder: MaskDecoderConfig = MaskDecoderConfig()

    def __post_init__(self):
        if (self.encoder_tiny is None) == (self.encoder_vit is None):
            raise ValueError("SamConfig needs exactly one encoder config "
                             "(encoder_tiny or encoder_vit); build configs "
                             "with sam.make_config()")

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
    if variant in VIT_PRESETS:
        return SamConfig(variant=variant, image_size=image_size,
                         encoder_vit=VIT_PRESETS[variant](img_size=image_size),
                         prompt=prompt)
    raise ValueError(f"Unknown SAM variant: {variant}")


def with_kernels(cfg: SamConfig) -> SamConfig:
    """``cfg`` with the port's encoder kernels on, as an Environment serves
    on a CUDA device: TinyViT's K1 (LayerNorm) and K2 (window attention);
    a ViT's K4 and K5 (rel-pos attention; its LayerNorms, K1 and K3,
    follow)."""
    if cfg.encoder_tiny is not None:
        return dataclasses.replace(cfg, encoder_tiny=dataclasses.replace(
            cfg.encoder_tiny, use_fused_norm=True, use_flash_attention=True))
    return dataclasses.replace(cfg, encoder_vit=dataclasses.replace(
        cfg.encoder_vit, use_flash_attention=True))


class Sam(nn.Module):
    """{"encoder", "prompt_encoder", "decoder"}, as the JAX tree."""

    def __init__(self, cfg: SamConfig, gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        if cfg.encoder_tiny is not None:
            self.encoder = TinyViT(cfg.encoder_tiny, gen)
        else:
            self.encoder = SamViT(cfg.encoder_vit, gen)
        self.prompt_encoder = PromptEncoder(cfg.prompt, gen)
        self.decoder = MaskDecoder(cfg.decoder, gen)


def init_sam(gen: torch.Generator, cfg: SamConfig) -> Sam:
    """Random weights from `gen`: the JAX tree's structure, shapes and
    distributions, with torch's random numbers (not jax.random's)."""
    return Sam(cfg, gen)


def encode_image(model: Sam, cfg: SamConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, S, 3) normalised pixels -> (B, S/16, S/16, 256). The
    kernel flags are read from the encoder's config in `cfg`."""
    return model.encoder(x, cfg.encoder_tiny or cfg.encoder_vit)


def decode_masks(model: Sam, cfg: SamConfig, image_embedding: torch.Tensor,
                 point_coords: torch.Tensor, point_labels: torch.Tensor,
                 mask_input: Optional[torch.Tensor] = None,
                 has_mask: Optional[torch.Tensor] = None,
                 multimask: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prompt encoder + mask decoder with ONNX-decoder semantics.

    image_embedding: (B, He, We, C); point_coords: (B, N, 2) in padded-image
    pixels; point_labels: (B, N). Returns multimask -> (B, 4, L, L), (B, 4);
    otherwise the ONNX single-mask selection -> (B, 1, L, L), (B, 1)."""
    ctx = decode_context(model, cfg, image_embedding, mask_input, has_mask)
    return decode_prompts(model, cfg, ctx, point_coords, point_labels,
                          multimask)


def decode_context(model: Sam, cfg: SamConfig, image_embedding: torch.Tensor,
                   mask_input: Optional[torch.Tensor] = None,
                   has_mask: Optional[torch.Tensor] = None) -> DecoderContext:
    """The decoder's work on the image and the dense prompt alone
    (``mask_decoder.decoder_context``), at the embedding's batch B."""
    B = image_embedding.shape[0]
    s = cfg.mask_input_size
    dev, dt = image_embedding.device, image_embedding.dtype
    if has_mask is None:
        fill = torch.zeros if mask_input is None else torch.ones
        has_mask = fill((B,), dtype=dt, device=dev)
    if mask_input is None:
        mask_input = torch.zeros((B, s, s, 1), dtype=dt, device=dev)
    pe = model.prompt_encoder
    dense = embed_masks(pe, cfg.prompt, mask_input, has_mask)
    return decoder_context(model.decoder, image_embedding,
                           dense_pe(pe, cfg.prompt), dense)


def decode_prompts(model: Sam, cfg: SamConfig, ctx: DecoderContext,
                   point_coords: torch.Tensor, point_labels: torch.Tensor,
                   multimask: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """``decode_masks`` of B prompts from a context made at batch B."""
    sparse = embed_points(model.prompt_encoder, cfg.prompt, point_coords,
                          point_labels).to(ctx.dtype)
    masks, iou = predict_masks_from(model.decoder, ctx, sparse, cfg.decoder)
    if not multimask:
        masks, iou = select_single_mask(masks, iou,
                                        num_points=point_coords.shape[1])
    return masks, iou
