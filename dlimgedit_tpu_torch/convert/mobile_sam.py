"""Convert original MobileSAM / SAM checkpoints to weight bundles
(counterpart of dlimgedit_tpu/convert/mobile_sam.py).

Offline tool. Input: the upstream ``mobile_sam.pt`` (ChaoningZhang/MobileSAM)
or ``sam_vit_{b,l,h}_*.pth`` (facebookresearch/segment-anything) state dicts,
as torch tensors or plain numpy arrays. Output: the nested numpy tree that
the JAX package's converter gives, leaf for leaf and bit for bit, in its
layouts, so one ``.npz`` serves both packages (``utils/pytree_io.py`` writes
it; ``convert/from_numpy.py::load_into`` loads it, conv kernels to OIHW).

Layout conversions: torch Linear (out, in) -> (in, out); conv OIHW -> HWIO;
ConvTranspose2d IOHW -> HWIO. BatchNorms (TinyViT Conv2d_BN) are folded into
the (scale, bias) affine of the encoder's conv + BN:
    scale = gamma / sqrt(var + eps),  bias = beta - mean * scale.
A linear's bias that the checkpoint lacks is left out (the loader then
drops it from the module).

Usage:
    python -m dlimgedit_tpu_torch.convert.mobile_sam mobile_sam.pt \
        models/segmentation/mobile_sam.npz [mobile_sam|vit_b|vit_l|vit_h]
"""

from __future__ import annotations

import sys
from typing import Any, Dict

import numpy as np

BN_EPS = 1e-5


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _lin(sd, prefix):
    p = {"w": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        p["b"] = _np(sd[f"{prefix}.bias"])
    return p


def _conv(sd, prefix, bias=True):
    p = {"w": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}
    if bias and f"{prefix}.bias" in sd:
        p["b"] = _np(sd[f"{prefix}.bias"])
    return p


def _conv_t(sd, prefix):
    return {"w": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 0, 1),
            "b": _np(sd[f"{prefix}.bias"])}


def _ln(sd, prefix):
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def _conv_bn(sd, prefix):
    """TinyViT Conv2d_BN ('c' conv + 'bn' BatchNorm2d) -> folded affine."""
    w = _np(sd[f"{prefix}.c.weight"]).transpose(2, 3, 1, 0)
    gamma = _np(sd[f"{prefix}.bn.weight"])
    beta = _np(sd[f"{prefix}.bn.bias"])
    mean = _np(sd[f"{prefix}.bn.running_mean"])
    var = _np(sd[f"{prefix}.bn.running_var"])
    scale = gamma / np.sqrt(var + BN_EPS)
    return {"w": w, "scale": scale, "bias": beta - mean * scale}


# ---------------------------------------------------------------------------
# TinyViT encoder (MobileSAM image_encoder, tiny_vit_sam.py layout)
# ---------------------------------------------------------------------------

def convert_tiny_vit(sd, prefix="image_encoder.",
                     depths=(2, 2, 6, 2)) -> Dict[str, Any]:
    e = prefix
    params: Dict[str, Any] = {
        "patch_embed": {
            "conv1": _conv_bn(sd, f"{e}patch_embed.seq.0"),
            "conv2": _conv_bn(sd, f"{e}patch_embed.seq.2"),
        },
        "stages": [],
    }
    for i in range(4):
        blocks = []
        for j in range(depths[i]):
            b = f"{e}layers.{i}.blocks.{j}"
            if i == 0:  # MBConv blocks
                blocks.append({
                    "conv1": _conv_bn(sd, f"{b}.conv1"),
                    "conv2": _conv_bn(sd, f"{b}.conv2"),
                    "conv3": _conv_bn(sd, f"{b}.conv3"),
                })
            else:  # TinyViT attention blocks
                blocks.append({
                    "attn": {
                        "norm": _ln(sd, f"{b}.attn.norm"),
                        "qkv": _lin(sd, f"{b}.attn.qkv"),
                        "proj": _lin(sd, f"{b}.attn.proj"),
                        "attention_biases": _np(sd[f"{b}.attn.attention_biases"]),
                    },
                    "local_conv": _conv_bn(sd, f"{b}.local_conv"),
                    "mlp": {
                        "norm": _ln(sd, f"{b}.mlp.norm"),
                        "fc1": _lin(sd, f"{b}.mlp.fc1"),
                        "fc2": _lin(sd, f"{b}.mlp.fc2"),
                    },
                })
        stage: Dict[str, Any] = {"blocks": blocks}
        if i < 3:
            d = f"{e}layers.{i}.downsample"
            stage["downsample"] = {
                "conv1": _conv_bn(sd, f"{d}.conv1"),
                "conv2": _conv_bn(sd, f"{d}.conv2"),
                "conv3": _conv_bn(sd, f"{d}.conv3"),
            }
        params["stages"].append(stage)
    params["neck"] = {
        "conv1": _conv(sd, f"{e}neck.0", bias=False),
        "ln1": _ln(sd, f"{e}neck.1"),
        "conv2": _conv(sd, f"{e}neck.2", bias=False),
        "ln2": _ln(sd, f"{e}neck.3"),
    }
    return params


# ---------------------------------------------------------------------------
# SAM ViT encoder (original segment-anything image_encoder layout)
# ---------------------------------------------------------------------------

def convert_sam_vit(sd, prefix="image_encoder.", depth=12) -> Dict[str, Any]:
    e = prefix
    blocks = []
    for i in range(depth):
        b = f"{e}blocks.{i}"
        blk = {
            "norm1": _ln(sd, f"{b}.norm1"),
            "qkv": _lin(sd, f"{b}.attn.qkv"),
            "proj": _lin(sd, f"{b}.attn.proj"),
            "norm2": _ln(sd, f"{b}.norm2"),
            "mlp": {"lin1": _lin(sd, f"{b}.mlp.lin1"),
                    "lin2": _lin(sd, f"{b}.mlp.lin2")},
        }
        if f"{b}.attn.rel_pos_h" in sd:
            blk["rel_pos_h"] = _np(sd[f"{b}.attn.rel_pos_h"])
            blk["rel_pos_w"] = _np(sd[f"{b}.attn.rel_pos_w"])
        blocks.append(blk)
    params = {
        "patch_embed": {
            "w": _np(sd[f"{e}patch_embed.proj.weight"]).transpose(2, 3, 1, 0),
            "b": _np(sd[f"{e}patch_embed.proj.bias"]),
        },
        "blocks": blocks,
        "neck": {
            "conv1": _conv(sd, f"{e}neck.0", bias=False),
            "ln1": _ln(sd, f"{e}neck.1"),
            "conv2": _conv(sd, f"{e}neck.2", bias=False),
            "ln2": _ln(sd, f"{e}neck.3"),
        },
    }
    if f"{e}pos_embed" in sd:
        params["pos_embed"] = _np(sd[f"{e}pos_embed"])
    return params


# ---------------------------------------------------------------------------
# Prompt encoder + mask decoder (original segment-anything layout)
# ---------------------------------------------------------------------------

def convert_prompt_encoder_official(sd, prefix="prompt_encoder.") -> Dict:
    p = prefix
    return {
        "pe_gaussian": _np(
            sd[f"{p}pe_layer.positional_encoding_gaussian_matrix"]),
        "point_embeddings": np.stack(
            [_np(sd[f"{p}point_embeddings.{i}.weight"])[0] for i in range(4)]),
        "not_a_point_embed": _np(sd[f"{p}not_a_point_embed.weight"]),
        "no_mask_embed": _np(sd[f"{p}no_mask_embed.weight"]),
        "mask_downscaling": {
            "conv1": _conv(sd, f"{p}mask_downscaling.0"),
            "ln1": _ln(sd, f"{p}mask_downscaling.1"),
            "conv2": _conv(sd, f"{p}mask_downscaling.3"),
            "ln2": _ln(sd, f"{p}mask_downscaling.4"),
            "conv3": _conv(sd, f"{p}mask_downscaling.6"),
        },
    }


def _attn_official(sd, prefix):
    return {
        "q": _lin(sd, f"{prefix}.q_proj"),
        "k": _lin(sd, f"{prefix}.k_proj"),
        "v": _lin(sd, f"{prefix}.v_proj"),
        "out": _lin(sd, f"{prefix}.out_proj"),
    }


def _mlp_chain_official(sd, prefix, n_layers=3):
    return {"layers": [_lin(sd, f"{prefix}.layers.{j}")
                       for j in range(n_layers)]}


def convert_mask_decoder_official(sd, prefix="mask_decoder.", depth=2,
                                  num_mask_tokens=4) -> Dict:
    p = prefix
    blocks = []
    for i in range(depth):
        b = f"{p}transformer.layers.{i}"
        blocks.append({
            "self_attn": _attn_official(sd, f"{b}.self_attn"),
            "norm1": _ln(sd, f"{b}.norm1"),
            "cross_attn_t2i": _attn_official(sd, f"{b}.cross_attn_token_to_image"),
            "norm2": _ln(sd, f"{b}.norm2"),
            "mlp": {"lin1": _lin(sd, f"{b}.mlp.lin1"),
                    "lin2": _lin(sd, f"{b}.mlp.lin2")},
            "norm3": _ln(sd, f"{b}.norm3"),
            "norm4": _ln(sd, f"{b}.norm4"),
            "cross_attn_i2t": _attn_official(sd, f"{b}.cross_attn_image_to_token"),
        })
    return {
        "iou_token": _np(sd[f"{p}iou_token.weight"]),
        "mask_tokens": _np(sd[f"{p}mask_tokens.weight"]),
        "transformer": {
            "blocks": blocks,
            "final_attn": _attn_official(
                sd, f"{p}transformer.final_attn_token_to_image"),
            "norm_final": _ln(sd, f"{p}transformer.norm_final_attn"),
        },
        "upscale": {
            "conv1": _conv_t(sd, f"{p}output_upscaling.0"),
            "ln": _ln(sd, f"{p}output_upscaling.1"),
            "conv2": _conv_t(sd, f"{p}output_upscaling.3"),
        },
        "hypernet_mlps": [
            _mlp_chain_official(sd, f"{p}output_hypernetworks_mlps.{i}")
            for i in range(num_mask_tokens)],
        "iou_head": _mlp_chain_official(sd, f"{p}iou_prediction_head"),
    }


def convert_checkpoint(sd, variant: str = "mobile_sam") -> Dict[str, Any]:
    """Full official checkpoint (state dict) -> the SAM parameter tree."""
    depth = {"mobile_sam": 0, "vit_b": 12, "vit_l": 24, "vit_h": 32}[variant]
    if variant == "mobile_sam":
        encoder = convert_tiny_vit(sd)
    else:
        encoder = convert_sam_vit(sd, depth=depth)
    return {
        "encoder": encoder,
        "prompt_encoder": convert_prompt_encoder_official(sd),
        "decoder": convert_mask_decoder_official(sd),
    }


def load_state_dict(src: str):
    """A checkpoint file -> its state dict on the CPU. Tensors-only load
    first (no pickle code runs: the safe default, and torch>=2.6's); a
    checkpoint that pickles a whole nn.Module needs the full unpickler,
    taken only as an explicit, warned fallback."""
    import torch

    try:
        sd = torch.load(src, map_location="cpu", weights_only=True)
    except Exception:
        print(f"note: {src} is not a plain state dict; falling back to the "
              f"full unpickler (only convert checkpoints you trust)",
              file=sys.stderr)
        sd = torch.load(src, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return sd


def main(argv=None):
    argv = argv or sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 1
    src, dst = argv[0], argv[1]
    variant = argv[2] if len(argv) > 2 else "mobile_sam"
    params = convert_checkpoint(load_state_dict(src), variant)
    from ..utils.pytree_io import save_pytree

    save_pytree(dst, params)
    print(f"wrote {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
