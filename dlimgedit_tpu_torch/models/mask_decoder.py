"""SAM mask decoder (counterpart of dlimgedit_tpu/models/mask_decoder.py).

A 2-layer two-way transformer over [iou_token, 4 mask tokens, sparse
prompts] x image embedding, a 4x transposed-conv upscaler, per-token
hypernetwork MLPs and the IoU head. Single-mask selection follows the ONNX
export's `select_masks`. Runs in float32. Its attention is plain PyTorch in
the JAX op order (matmul, float32 softmax, cast, matmul): the JAX package
has no TPU kernel for it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .common import (
    LayerNorm,
    Linear,
    _param,
    conv_transpose2d,
    gelu,
    layer_norm,
    linear,
    normal,
    relu,
)


@dataclass(frozen=True)
class MaskDecoderConfig:
    embed_dim: int = 256
    num_heads: int = 8
    mlp_dim: int = 2048
    depth: int = 2
    attention_downsample_rate: int = 2
    num_mask_tokens: int = 4  # 1 + num_multimask_outputs(3)
    iou_head_depth: int = 3
    iou_head_hidden: int = 256


class Attn(nn.Module):
    def __init__(self, embed_dim: int, internal_dim: int, gen: torch.Generator):
        super().__init__()
        self.q = Linear(embed_dim, internal_dim, gen)
        self.k = Linear(embed_dim, internal_dim, gen)
        self.v = Linear(embed_dim, internal_dim, gen)
        self.out = Linear(internal_dim, embed_dim, gen)


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, gen: torch.Generator):
        super().__init__()
        self.lin1 = Linear(dim, hidden, gen)
        self.lin2 = Linear(hidden, dim, gen)


class TwoWayBlock(nn.Module):
    def __init__(self, cfg: MaskDecoderConfig, gen: torch.Generator):
        super().__init__()
        ed = cfg.embed_dim
        down = ed // cfg.attention_downsample_rate
        self.self_attn = Attn(ed, ed, gen)
        self.norm1 = LayerNorm(ed)
        self.cross_attn_t2i = Attn(ed, down, gen)
        self.norm2 = LayerNorm(ed)
        self.mlp = MlpBlock(ed, cfg.mlp_dim, gen)
        self.norm3 = LayerNorm(ed)
        self.norm4 = LayerNorm(ed)
        self.cross_attn_i2t = Attn(ed, down, gen)


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: MaskDecoderConfig, gen: torch.Generator):
        super().__init__()
        ed = cfg.embed_dim
        self.blocks = nn.ModuleList(TwoWayBlock(cfg, gen) for _ in range(cfg.depth))
        self.final_attn = Attn(ed, ed // cfg.attention_downsample_rate, gen)
        self.norm_final = LayerNorm(ed)


class MlpChain(nn.Module):
    def __init__(self, dims, gen: torch.Generator):
        super().__init__()
        self.layers = nn.ModuleList(Linear(dims[i], dims[i + 1], gen)
                                    for i in range(len(dims) - 1))


class UpscaleConv(nn.Module):
    """ConvTranspose2d(k=2, s=2) weight (out, in, 2, 2) and bias."""

    def __init__(self, cin: int, cout: int, gen: torch.Generator):
        super().__init__()
        self.w = _param(normal(gen, (cout, cin, 2, 2), std=0.02))
        self.b = _param(torch.zeros(cout))


class Upscale(nn.Module):
    def __init__(self, ed: int, gen: torch.Generator):
        super().__init__()
        self.conv1 = UpscaleConv(ed, ed // 4, gen)
        self.ln = LayerNorm(ed // 4)
        self.conv2 = UpscaleConv(ed // 4, ed // 8, gen)


class MaskDecoder(nn.Module):
    def __init__(self, cfg: MaskDecoderConfig, gen: torch.Generator):
        super().__init__()
        ed = cfg.embed_dim
        nmt = cfg.num_mask_tokens
        self.iou_token = _param(normal(gen, (1, ed)))
        self.mask_tokens = _param(normal(gen, (nmt, ed)))
        self.transformer = TwoWayTransformer(cfg, gen)
        self.upscale = Upscale(ed, gen)
        self.hypernet_mlps = nn.ModuleList(
            MlpChain([ed, ed, ed, ed // 8], gen) for _ in range(nmt))
        self.iou_head = MlpChain(
            [ed] + [cfg.iou_head_hidden] * (cfg.iou_head_depth - 1) + [nmt], gen)


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _attn(params: Attn, q, k, v, num_heads: int, q_proj=None, k_proj=None,
          v_proj=None) -> torch.Tensor:
    """SAM decoder attention: project, split heads, attend, recombine. A
    projection given (``q_proj``, ``k_proj``, ``v_proj``: block 0's
    prompt-independent ones, ``DecoderContext``) stands for its input's."""
    q = linear(params.q, q) if q_proj is None else q_proj
    k = linear(params.k, k) if k_proj is None else k_proj
    v = linear(params.v, v) if v_proj is None else v_proj
    B, Nq, C = q.shape
    Nk = k.shape[1]
    hd = C // num_heads
    q = q.reshape(B, Nq, num_heads, hd)
    k = k.reshape(B, Nk, num_heads, hd)
    v = v.reshape(B, Nk, num_heads, hd)
    attn = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) / np.sqrt(hd)
    attn = torch.softmax(attn, dim=-1).to(v.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", attn, v).to(v.dtype)
    return linear(params.out, out.reshape(B, Nq, C))


def _mlp_block(params: MlpBlock, x) -> torch.Tensor:
    return linear(params.lin2, relu(linear(params.lin1, x)))


class DecoderContext(NamedTuple):
    """What the decoder computes from the image alone (no mask prompt):
    the keys ``image_embedding + dense_prompt`` and their positional
    encoding, (B, H*W, C), and block 0's projections of them: its
    token-to-image k and v and its image-to-token q. The keys change per
    prompt only after block 0's image-to-token attention. One context
    serves every prompt decoded against the same image, at the batch it
    was made at (``predict_masks_from``). ``dtype`` is the embedding's,
    which the sparse prompt is cast to."""

    keys: torch.Tensor
    key_pe: torch.Tensor
    t2i_k: torch.Tensor
    t2i_v: torch.Tensor
    i2t_q: torch.Tensor
    grid: Tuple[int, int]
    dtype: torch.dtype


def decoder_context(params: MaskDecoder, image_embedding: torch.Tensor,
                    image_pe: torch.Tensor, dense_prompt: torch.Tensor
                    ) -> DecoderContext:
    """image_embedding, dense_prompt: (B, H, W, C); image_pe: (H, W, C)."""
    B, H, W, C = image_embedding.shape
    src = image_embedding + dense_prompt
    keys = src.reshape(B, H * W, C)
    key_pe = image_pe[None].expand(B, H, W, C).to(src.dtype).reshape(B, H * W, C)
    k = keys + key_pe
    block = params.transformer.blocks[0]
    return DecoderContext(keys, key_pe, linear(block.cross_attn_t2i.k, k),
                          linear(block.cross_attn_t2i.v, keys),
                          linear(block.cross_attn_i2t.q, k), (H, W),
                          image_embedding.dtype)


def _twoway_block(params: TwoWayBlock, queries, keys, query_pe, key_pe,
                  num_heads: int, skip_first_layer_pe: bool,
                  ctx: Optional[DecoderContext] = None):
    """With ``ctx`` (block 0) the keys are the context's and its
    projections of them are used."""
    if skip_first_layer_pe:
        queries = _attn(params.self_attn, queries, queries, queries, num_heads)
    else:
        q = queries + query_pe
        queries = queries + _attn(params.self_attn, q, q, queries, num_heads)
    queries = layer_norm(params.norm1, queries)

    q = queries + query_pe
    if ctx is None:
        k = keys + key_pe
        queries = queries + _attn(params.cross_attn_t2i, q, k, keys, num_heads)
    else:
        queries = queries + _attn(params.cross_attn_t2i, q, None, None,
                                  num_heads, k_proj=ctx.t2i_k, v_proj=ctx.t2i_v)
    queries = layer_norm(params.norm2, queries)

    queries = queries + _mlp_block(params.mlp, queries)
    queries = layer_norm(params.norm3, queries)

    q = queries + query_pe
    if ctx is None:
        k = keys + key_pe
        keys = keys + _attn(params.cross_attn_i2t, k, q, queries, num_heads)
    else:
        keys = keys + _attn(params.cross_attn_i2t, None, q, queries, num_heads,
                            q_proj=ctx.i2t_q)
    keys = layer_norm(params.norm4, keys)
    return queries, keys


def _twoway_transformer(params: TwoWayTransformer, cfg: MaskDecoderConfig,
                        ctx: DecoderContext, point_embedding):
    """point_embedding: (B, N, C), at the context's batch."""
    keys, key_pe = ctx.keys, ctx.key_pe
    queries = point_embedding
    for i, bp in enumerate(params.blocks):
        queries, keys = _twoway_block(bp, queries, keys, point_embedding, key_pe,
                                      cfg.num_heads, skip_first_layer_pe=(i == 0),
                                      ctx=ctx if i == 0 else None)
    q = queries + point_embedding
    k = keys + key_pe
    queries = queries + _attn(params.final_attn, q, k, keys, cfg.num_heads)
    queries = layer_norm(params.norm_final, queries)
    return queries, keys


def _mlp_chain(params: MlpChain, x) -> torch.Tensor:
    n = len(params.layers)
    for i, lp in enumerate(params.layers):
        x = linear(lp, x)
        if i < n - 1:
            x = relu(x)
    return x


def predict_masks(params: MaskDecoder, image_embedding: torch.Tensor,
                  image_pe: torch.Tensor, sparse_prompt: torch.Tensor,
                  dense_prompt: torch.Tensor,
                  cfg: MaskDecoderConfig = MaskDecoderConfig()
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Low-res mask logits. image_embedding: (B, H, W, C); image_pe:
    (H, W, C); sparse_prompt: (B, N, C); dense_prompt: (B, H, W, C).
    Returns (masks (B, nmt, 4H, 4W), iou_pred (B, nmt))."""
    ctx = decoder_context(params, image_embedding, image_pe, dense_prompt)
    return predict_masks_from(params, ctx, sparse_prompt, cfg)


def predict_masks_from(params: MaskDecoder, ctx: DecoderContext,
                       sparse_prompt: torch.Tensor,
                       cfg: MaskDecoderConfig = MaskDecoderConfig()
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``predict_masks`` from the image's context; sparse_prompt (B, N, C)
    at the context's batch B. A context made at B = 1 and one prompt at a
    time give each prompt the operations and shapes of a single decode."""
    B = ctx.keys.shape[0]
    (H, W), C = ctx.grid, ctx.keys.shape[2]
    nmt = cfg.num_mask_tokens
    output_tokens = torch.cat([params.iou_token, params.mask_tokens],
                              dim=0).to(sparse_prompt.dtype)
    tokens = torch.cat([output_tokens[None].expand(B, 1 + nmt, C), sparse_prompt],
                       dim=1)
    hs, src = _twoway_transformer(params.transformer, cfg, ctx, tokens)
    iou_token_out = hs[:, 0]
    mask_tokens_out = hs[:, 1:1 + nmt]

    src = src.reshape(B, H, W, C)
    up = params.upscale
    x = conv_transpose2d(src, up.conv1.w) + up.conv1.b.to(src.dtype)
    x = gelu(layer_norm(up.ln, x, eps=1e-6))
    x = conv_transpose2d(x, up.conv2.w) + up.conv2.b.to(x.dtype)
    x = gelu(x)  # (B, 4H, 4W, C/8)

    hyper_in = torch.stack(
        [_mlp_chain(params.hypernet_mlps[i], mask_tokens_out[:, i])
         for i in range(nmt)], dim=1)  # (B, nmt, C/8)
    masks = torch.einsum("btc,bhwc->bthw", hyper_in.float(), x.float())
    iou_pred = _mlp_chain(params.iou_head, iou_token_out.float())
    return masks, iou_pred


def select_single_mask(masks: torch.Tensor, iou_pred: torch.Tensor,
                       num_points: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """ONNX-export `select_masks`: penalise the single-click token (index 0)
    unless >= 3 points were given, then take the argmax-IoU mask."""
    # 1000 on token 0, made on the device (a scalar store into a device
    # tensor is a host copy, which a CUDA graph capture refuses).
    token = torch.arange(masks.shape[1], device=masks.device)
    penalty = (token == 0).to(torch.float32) * 1000.0
    score = iou_pred + (num_points - 2.5) * penalty
    best = torch.argmax(score, dim=1)
    b = torch.arange(masks.shape[0], device=masks.device)
    return masks[b, best][:, None], iou_pred[b, best][:, None]
