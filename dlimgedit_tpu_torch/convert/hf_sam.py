"""Convert a HuggingFace ``transformers`` SamModel state dict to the SAM
parameter tree (counterpart of dlimgedit_tpu/convert/hf_sam.py).

Offline conversion of HF checkpoints (facebook/sam-vit-base etc.). Every
tensor becomes a float32 numpy array, in the JAX package's layouts (Linear
(in, out), conv HWIO), leaf for leaf the tree that the JAX package's
converter gives, so one ``.npz`` serves both packages. The state dict may
hold torch tensors or plain numpy arrays (safetensors loaders yield
arrays). ``transformers`` itself is never imported: ``convert_sam_model``
takes any object with a ``state_dict()``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _t(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _lin(sd, prefix) -> Dict[str, np.ndarray]:
    p = {"w": _t(sd[prefix + ".weight"]).T}
    if prefix + ".bias" in sd:
        p["b"] = _t(sd[prefix + ".bias"])
    return p


def _conv(sd, prefix, bias=True) -> Dict[str, np.ndarray]:
    # torch conv weight (O, I, kh, kw) -> HWIO (kh, kw, I, O)
    p = {"w": _t(sd[prefix + ".weight"]).transpose(2, 3, 1, 0)}
    if bias and prefix + ".bias" in sd:
        p["b"] = _t(sd[prefix + ".bias"])
    return p


def _conv_transpose(sd, prefix) -> Dict[str, np.ndarray]:
    # torch ConvTranspose2d weight (I, O, kh, kw) -> (kh, kw, I, O)
    return {"w": _t(sd[prefix + ".weight"]).transpose(2, 3, 0, 1),
            "b": _t(sd[prefix + ".bias"])}


def _ln(sd, prefix) -> Dict[str, np.ndarray]:
    return {"scale": _t(sd[prefix + ".weight"]), "bias": _t(sd[prefix + ".bias"])}


def _attn(sd, prefix) -> Dict[str, Any]:
    return {
        "q": _lin(sd, prefix + ".q_proj"),
        "k": _lin(sd, prefix + ".k_proj"),
        "v": _lin(sd, prefix + ".v_proj"),
        "out": _lin(sd, prefix + ".out_proj"),
    }


def _feed_forward(sd, prefix) -> Dict[str, Any]:
    """SamFeedForward: proj_in -> layers.* -> proj_out."""
    layers = [_lin(sd, prefix + ".proj_in")]
    i = 0
    while f"{prefix}.layers.{i}.weight" in sd:
        layers.append(_lin(sd, f"{prefix}.layers.{i}"))
        i += 1
    layers.append(_lin(sd, prefix + ".proj_out"))
    return {"layers": layers}


def convert_prompt_encoder(sd) -> Dict[str, Any]:
    pe = "prompt_encoder"
    point_embeddings = np.stack(
        [_t(sd[f"{pe}.point_embed.{i}.weight"])[0] for i in range(4)])
    return {
        "pe_gaussian": _t(sd["shared_image_embedding.positional_embedding"]),
        "point_embeddings": point_embeddings,
        "not_a_point_embed": _t(sd[f"{pe}.not_a_point_embed.weight"]),
        "no_mask_embed": _t(sd[f"{pe}.no_mask_embed.weight"]),
        "mask_downscaling": {
            "conv1": _conv(sd, f"{pe}.mask_embed.conv1"),
            "ln1": _ln(sd, f"{pe}.mask_embed.layer_norm1"),
            "conv2": _conv(sd, f"{pe}.mask_embed.conv2"),
            "ln2": _ln(sd, f"{pe}.mask_embed.layer_norm2"),
            "conv3": _conv(sd, f"{pe}.mask_embed.conv3"),
        },
    }


def convert_mask_decoder(sd) -> Dict[str, Any]:
    md = "mask_decoder"
    blocks = []
    i = 0
    while f"{md}.transformer.layers.{i}.layer_norm1.weight" in sd:
        p = f"{md}.transformer.layers.{i}"
        blocks.append({
            "self_attn": _attn(sd, p + ".self_attn"),
            "norm1": _ln(sd, p + ".layer_norm1"),
            "cross_attn_t2i": _attn(sd, p + ".cross_attn_token_to_image"),
            "norm2": _ln(sd, p + ".layer_norm2"),
            "mlp": {"lin1": _lin(sd, p + ".mlp.lin1"),
                    "lin2": _lin(sd, p + ".mlp.lin2")},
            "norm3": _ln(sd, p + ".layer_norm3"),
            "norm4": _ln(sd, p + ".layer_norm4"),
            "cross_attn_i2t": _attn(sd, p + ".cross_attn_image_to_token"),
        })
        i += 1
    hyper = []
    i = 0
    while f"{md}.output_hypernetworks_mlps.{i}.proj_in.weight" in sd:
        hyper.append(_feed_forward(sd, f"{md}.output_hypernetworks_mlps.{i}"))
        i += 1
    return {
        "iou_token": _t(sd[f"{md}.iou_token.weight"]),
        "mask_tokens": _t(sd[f"{md}.mask_tokens.weight"]),
        "transformer": {
            "blocks": blocks,
            "final_attn": _attn(sd, f"{md}.transformer.final_attn_token_to_image"),
            "norm_final": _ln(sd, f"{md}.transformer.layer_norm_final_attn"),
        },
        "upscale": {
            "conv1": _conv_transpose(sd, f"{md}.upscale_conv1"),
            "ln": _ln(sd, f"{md}.upscale_layer_norm"),
            "conv2": _conv_transpose(sd, f"{md}.upscale_conv2"),
        },
        "hypernet_mlps": hyper,
        "iou_head": _feed_forward(sd, f"{md}.iou_prediction_head"),
    }


def convert_vision_encoder(sd) -> Dict[str, Any]:
    ve = "vision_encoder"
    blocks = []
    i = 0
    while f"{ve}.layers.{i}.layer_norm1.weight" in sd:
        p = f"{ve}.layers.{i}"
        b = {
            "norm1": _ln(sd, p + ".layer_norm1"),
            "qkv": _lin(sd, p + ".attn.qkv"),
            "proj": _lin(sd, p + ".attn.proj"),
            "norm2": _ln(sd, p + ".layer_norm2"),
            "mlp": {"lin1": _lin(sd, p + ".mlp.lin1"),
                    "lin2": _lin(sd, p + ".mlp.lin2")},
        }
        if p + ".attn.rel_pos_h" in sd:
            b["rel_pos_h"] = _t(sd[p + ".attn.rel_pos_h"])
            b["rel_pos_w"] = _t(sd[p + ".attn.rel_pos_w"])
        blocks.append(b)
        i += 1
    params = {
        "patch_embed": {
            "w": _t(sd[f"{ve}.patch_embed.projection.weight"]).transpose(2, 3, 1, 0),
            "b": _t(sd[f"{ve}.patch_embed.projection.bias"]),
        },
        "blocks": blocks,
        "neck": {
            "conv1": _conv(sd, f"{ve}.neck.conv1", bias=False),
            "ln1": _ln(sd, f"{ve}.neck.layer_norm1"),
            "conv2": _conv(sd, f"{ve}.neck.conv2", bias=False),
            "ln2": _ln(sd, f"{ve}.neck.layer_norm2"),
        },
    }
    if f"{ve}.pos_embed" in sd:
        params["pos_embed"] = _t(sd[f"{ve}.pos_embed"])
    return params


def convert_sam_model(model) -> Dict[str, Any]:
    """transformers SamModel -> the full SAM parameter tree."""
    sd = model.state_dict()
    return {
        "encoder": convert_vision_encoder(sd),
        "prompt_encoder": convert_prompt_encoder(sd),
        "decoder": convert_mask_decoder(sd),
    }
