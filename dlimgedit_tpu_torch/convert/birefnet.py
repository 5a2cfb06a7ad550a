"""BiRefNet checkpoint conversion, the full model (backbone + decoder)
(counterpart of dlimgedit_tpu/convert/birefnet.py).

Offline tool. Maps upstream BiRefNet checkpoints (ZhengPeng7/BiRefNet) onto
the BiRefNet parameter tree, leaf for leaf and bit for bit the tree that the
JAX package's converter gives, in its layouts, so one ``.npz`` serves both
packages:

  bb.*                                  -> backbone (standard Swin-v1)
  squeeze_module.0.*                    -> squeeze (BasicDecBlk)
  decoder.ipt_blk{1..5}.*               -> decoder.ipt_blk{1..5} (SimpleConvs)
  decoder.decoder_block{1..4}.*         -> decoder.dec{1..4} (BasicDecBlk)
  decoder.lateral_block{2..4}.conv      -> decoder.lat{2..4}
  decoder.gdt_convs_{2,3,4}.*           -> decoder.gdt{2,3,4} (BN folded)
  decoder.gdt_convs_attn_{2,3,4}.0      -> decoder.gdt_attn{2,3,4}
  decoder.conv_out1.0                   -> decoder.head

All eval-mode BatchNorms are folded into the preceding conv (w' = w*s,
b' = (b - mean)*s + beta with s = gamma/sqrt(var + eps), eps=1e-5).
Training-only heads (conv_ms_spvn_*, gdt_convs_pred_*) are dropped, and a
plain conv's bias that the checkpoint lacks is left out (the loader then
drops it from the module). Conversion is shape-driven: it works for any
backbone width.

Usage:
    python -m dlimgedit_tpu_torch.convert.birefnet BiRefNet.pth \
        models/segmentation/birefnet_general.npz
"""

from __future__ import annotations

import sys
from typing import Any, Dict

import numpy as np


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _lin(sd, prefix):
    p = {"w": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        p["b"] = _np(sd[f"{prefix}.bias"])
    return p


def _ln(sd, prefix):
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def convert_swin_backbone(sd, prefix="bb.", depths=None) -> Dict[str, Any]:
    """Standard torch Swin-v1 state dict -> the Swin backbone's tree.
    `depths` defaults to probing the state dict (shape-driven)."""
    p = prefix
    if depths is None:
        depths = []
        for i in range(4):
            j = 0
            while f"{p}layers.{i}.blocks.{j}.norm1.weight" in sd:
                j += 1
            depths.append(j)
        depths = tuple(depths)
    params: Dict[str, Any] = {
        "patch_embed": {
            "w": _np(sd[f"{p}patch_embed.proj.weight"]).transpose(2, 3, 1, 0),
            "b": _np(sd[f"{p}patch_embed.proj.bias"]),
            "norm": _ln(sd, f"{p}patch_embed.norm"),
        },
        "stages": [],
    }
    for i in range(len(depths)):
        blocks = []
        for j in range(depths[i]):
            b = f"{p}layers.{i}.blocks.{j}"
            blocks.append({
                "norm1": _ln(sd, f"{b}.norm1"),
                "qkv": _lin(sd, f"{b}.attn.qkv"),
                "proj": _lin(sd, f"{b}.attn.proj"),
                "rel_bias": _np(sd[f"{b}.attn.relative_position_bias_table"]),
                "norm2": _ln(sd, f"{b}.norm2"),
                "mlp": {"lin1": _lin(sd, f"{b}.mlp.fc1"),
                        "lin2": _lin(sd, f"{b}.mlp.fc2")},
            })
        stage: Dict[str, Any] = {"blocks": blocks}
        # BiRefNet taps per-stage outputs through `norm{i}` layers when
        # present; otherwise identity norms.
        norm_key = f"{p}norm{i}"
        if f"{norm_key}.weight" in sd:
            stage["out_norm"] = _ln(sd, norm_key)
        else:
            dim = blocks[0]["norm1"]["scale"].shape[0]
            stage["out_norm"] = {"scale": np.ones(dim, np.float32),
                                 "bias": np.zeros(dim, np.float32)}
        if i < len(depths) - 1:
            d = f"{p}layers.{i}.downsample"
            stage["downsample"] = {
                "norm": _ln(sd, f"{d}.norm"),
                "reduction": {"w": _np(sd[f"{d}.reduction.weight"]).T},
            }
        params["stages"].append(stage)
    return params


# ---------------------------------------------------------------------------
# Decoder conversion (BN folding)
# ---------------------------------------------------------------------------

def _conv_hwio(sd, prefix) -> Dict[str, np.ndarray]:
    """Plain torch Conv2d -> {w (HWIO), b?}."""
    p = {"w": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}
    if f"{prefix}.bias" in sd:
        p["b"] = _np(sd[f"{prefix}.bias"])
    return p


def _conv_bn_fold(sd, conv_prefix, bn_prefix, eps=1e-5) -> Dict[str, np.ndarray]:
    """conv (+optional bias) followed by eval-mode BatchNorm2d -> {w, b}."""
    w = _np(sd[f"{conv_prefix}.weight"]).transpose(2, 3, 1, 0)
    b = (_np(sd[f"{conv_prefix}.bias"])
         if f"{conv_prefix}.bias" in sd else np.zeros(w.shape[-1], np.float32))
    if f"{bn_prefix}.weight" not in sd:  # bn was nn.Identity
        return {"w": w, "b": b}
    gamma = _np(sd[f"{bn_prefix}.weight"])
    beta = _np(sd[f"{bn_prefix}.bias"])
    mean = _np(sd[f"{bn_prefix}.running_mean"])
    var = _np(sd[f"{bn_prefix}.running_var"])
    s = gamma / np.sqrt(var + eps)
    return {"w": w * s, "b": (b - mean) * s + beta}


def _deform_module(sd, prefix) -> Dict[str, Any]:
    """_ASPPModuleDeformable: atrous_conv (DeformableConv2d) + bn + relu."""
    a = f"{prefix}.atrous_conv"
    return {
        "offset": _conv_hwio(sd, f"{a}.offset_conv"),
        "modulator": _conv_hwio(sd, f"{a}.modulator_conv"),
        "conv": _conv_bn_fold(sd, f"{a}.regular_conv", f"{prefix}.bn"),
    }


def _aspp(sd, prefix) -> Dict[str, Any]:
    deforms = []
    i = 0
    while f"{prefix}.aspp_deforms.{i}.atrous_conv.regular_conv.weight" in sd:
        deforms.append(_deform_module(sd, f"{prefix}.aspp_deforms.{i}"))
        i += 1
    return {
        "aspp1": _deform_module(sd, f"{prefix}.aspp1"),
        "deforms": deforms,
        "gap": _conv_bn_fold(sd, f"{prefix}.global_avg_pool.1",
                             f"{prefix}.global_avg_pool.2"),
        "proj": _conv_bn_fold(sd, f"{prefix}.conv1", f"{prefix}.bn1"),
    }


def _dec_blk(sd, prefix) -> Dict[str, Any]:
    return {
        "conv_in": _conv_bn_fold(sd, f"{prefix}.conv_in", f"{prefix}.bn_in"),
        "aspp": _aspp(sd, f"{prefix}.dec_att"),
        "conv_out": _conv_bn_fold(sd, f"{prefix}.conv_out",
                                  f"{prefix}.bn_out"),
    }


def _simple_convs(sd, prefix) -> Dict[str, Any]:
    return {"conv1": _conv_hwio(sd, f"{prefix}.conv1"),
            "conv_out": _conv_hwio(sd, f"{prefix}.conv_out")}


def convert_decoder(sd) -> Dict[str, Any]:
    d = "decoder"
    dec: Dict[str, Any] = {}
    for i in range(1, 6):
        dec[f"ipt_blk{i}"] = _simple_convs(sd, f"{d}.ipt_blk{i}")
    for i in range(1, 5):
        dec[f"dec{i}"] = _dec_blk(sd, f"{d}.decoder_block{i}")
    for i in range(2, 5):
        dec[f"lat{i}"] = _conv_hwio(sd, f"{d}.lateral_block{i}.conv")
        dec[f"gdt{i}"] = _conv_bn_fold(sd, f"{d}.gdt_convs_{i}.0",
                                       f"{d}.gdt_convs_{i}.1")
        dec[f"gdt_attn{i}"] = _conv_hwio(sd, f"{d}.gdt_convs_attn_{i}.0")
    dec["head"] = _conv_hwio(sd, f"{d}.conv_out1.0")
    return dec


def convert_checkpoint(sd) -> Dict[str, Any]:
    """Full BiRefNet state dict -> the BiRefNet parameter tree."""
    return {
        "backbone": convert_swin_backbone(sd),
        "squeeze": _dec_blk(sd, "squeeze_module.0"),
        "decoder": convert_decoder(sd),
    }


def main(argv=None):
    argv = argv or sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 1
    from ..utils.pytree_io import save_pytree
    from .mobile_sam import load_state_dict

    params = convert_checkpoint(load_state_dict(argv[0]))
    save_pytree(argv[1], params)
    print(f"wrote {argv[1]} (full BiRefNet: backbone + decoder)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
