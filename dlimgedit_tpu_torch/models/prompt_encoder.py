"""SAM prompt encoder (counterpart of dlimgedit_tpu/models/prompt_encoder.py).

Random-Fourier positional encoding of point/box prompts with the label
protocol 1 = positive point, -1 = padding, 2 = box top-left,
3 = box bottom-right, plus the dense no-mask embedding / mask-downscaling
path gated by `has_mask`. Runs in float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .common import Conv, LayerNorm, _param, conv2d, gelu, layer_norm, normal


@dataclass(frozen=True)
class PromptEncoderConfig:
    embed_dim: int = 256
    image_embedding_size: int = 64   # H = W of the image embedding
    input_image_size: int = 1024     # padded model input resolution
    mask_in_chans: int = 16


class MaskDownscaling(nn.Module):
    def __init__(self, embed_dim: int, mask_in_chans: int, gen: torch.Generator):
        super().__init__()
        mc = mask_in_chans
        self.conv1 = Conv(1, mc // 4, 2, gen, with_bias=True)
        self.ln1 = LayerNorm(mc // 4)
        self.conv2 = Conv(mc // 4, mc, 2, gen, with_bias=True)
        self.ln2 = LayerNorm(mc)
        self.conv3 = Conv(mc, embed_dim, 1, gen, with_bias=True)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: PromptEncoderConfig, gen: torch.Generator):
        super().__init__()
        ed = cfg.embed_dim
        # PositionEmbeddingRandom gaussian matrix, scale=1.
        self.pe_gaussian = _param(normal(gen, (2, ed // 2)))
        # [neg point(0), pos point(1), box tl(2), box br(3)]
        self.point_embeddings = _param(normal(gen, (4, ed)))
        self.not_a_point_embed = _param(normal(gen, (1, ed)))
        self.no_mask_embed = _param(normal(gen, (1, ed)))
        self.mask_downscaling = MaskDownscaling(ed, cfg.mask_in_chans, gen)


def pe_encoding(params: PromptEncoder, coords01: torch.Tensor) -> torch.Tensor:
    """Random-Fourier encoding of [0,1]-normalised (x, y): (..., 2) ->
    (..., embed_dim), in float32 (elementwise, not a K=2 matmul)."""
    coords = 2.0 * coords01.float() - 1.0
    g = params.pe_gaussian.float()
    coords = coords[..., 0:1] * g[0] + coords[..., 1:2] * g[1]
    coords = 2.0 * np.pi * coords
    return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


def dense_pe(params: PromptEncoder, cfg: PromptEncoderConfig) -> torch.Tensor:
    """Positional encoding of the image-embedding grid -> (H, W, embed_dim)."""
    s = cfg.image_embedding_size
    dev = params.pe_gaussian.device
    r = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    y = r[:, None].expand(s, s)
    x = r[None, :].expand(s, s)
    return pe_encoding(params, torch.stack([x, y], dim=-1))


def embed_points(params: PromptEncoder, cfg: PromptEncoderConfig,
                 point_coords: torch.Tensor, point_labels: torch.Tensor
                 ) -> torch.Tensor:
    """Sparse prompt embedding, ONNX-export semantics: coords are in padded
    model-input pixel space; +0.5 centres the pixel.
    point_coords: (B, N, 2) (x, y); point_labels: (B, N). -> (B, N, ed)."""
    coords = (point_coords.float() + 0.5) / float(cfg.input_image_size)
    emb = pe_encoding(params, coords)
    labels = point_labels.float()[..., None]
    emb = emb * (labels != -1)
    emb = emb + params.not_a_point_embed[0].float() * (labels == -1)
    for i in range(4):
        emb = emb + params.point_embeddings[i].float() * (labels == i)
    return emb


def embed_masks(params: PromptEncoder, cfg: PromptEncoderConfig,
                mask_input: torch.Tensor, has_mask: torch.Tensor) -> torch.Tensor:
    """Dense prompt embedding (B, H, W, embed_dim). mask_input:
    (B, 4H, 4W, 1) low-res mask logits; has_mask: (B,) blends the downscaled
    mask against the learned no-mask embedding, as the ONNX graph does."""
    md = params.mask_downscaling
    x = mask_input
    x = conv2d(x, md.conv1.w, stride=2) + md.conv1.b.to(x.dtype)
    x = gelu(layer_norm(md.ln1, x, eps=1e-6))
    x = conv2d(x, md.conv2.w, stride=2) + md.conv2.b.to(x.dtype)
    x = gelu(layer_norm(md.ln2, x, eps=1e-6))
    x = conv2d(x, md.conv3.w) + md.conv3.b.to(x.dtype)
    no_mask = params.no_mask_embed[0].to(x.dtype)
    hm = has_mask.to(x.dtype).reshape(-1, 1, 1, 1)
    return hm * x + (1.0 - hm) * no_mask
