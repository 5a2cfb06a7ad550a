"""Official-layout state dicts built from a SAM parameter tree: the inverse
of the converters' layouts (dlimgedit_tpu_torch/convert/mobile_sam.py and
hf_sam.py). Imports neither jax nor the JAX package: chip_smoke.py builds
its full-width MobileSAM checkpoint with it, and the CPU tests build their
narrow ViT and HF checkpoints from JAX's init trees.

The tree is the nested numpy tree of both packages (Linear (in, out), conv
HWIO; ``convert/from_numpy.py::numpy_from_params`` gives it for a port
model). A TinyViT conv + BN affine (``scale``, ``bias``) becomes a conv and
a BatchNorm with seeded running statistics, gamma = scale * sqrt(var +
eps) and beta = bias + mean * scale, so the converter's fold gives the
affine back within float32 rounding; every other leaf converts back
exactly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

BN_EPS = 1e-5


def _oihw(w):  # HWIO -> OIHW
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def _iohw(w):  # (kh, kw, I, O) -> ConvTranspose2d's (I, O, kh, kw)
    return np.ascontiguousarray(np.asarray(w).transpose(2, 3, 0, 1))


class _Writer:
    def __init__(self, seed: int):
        self.sd: Dict[str, np.ndarray] = {}
        self.rng = np.random.default_rng(seed)

    def put(self, key, value):
        self.sd[key] = np.ascontiguousarray(np.asarray(value, np.float32))

    def lin(self, prefix, p):
        self.put(f"{prefix}.weight", np.asarray(p["w"]).T)
        if "b" in p:
            self.put(f"{prefix}.bias", p["b"])

    def conv(self, prefix, p):
        self.put(f"{prefix}.weight", _oihw(p["w"]))
        if "b" in p:
            self.put(f"{prefix}.bias", p["b"])

    def conv_t(self, prefix, p):
        self.put(f"{prefix}.weight", _iohw(p["w"]))
        self.put(f"{prefix}.bias", p["b"])

    def ln(self, prefix, p):
        self.put(f"{prefix}.weight", p["scale"])
        self.put(f"{prefix}.bias", p["bias"])

    def conv_bn(self, prefix, p):
        scale = np.asarray(p["scale"], np.float32)
        n = scale.shape[0]
        mean = (0.1 * self.rng.standard_normal(n)).astype(np.float32)
        var = (0.5 + self.rng.random(n)).astype(np.float32)
        self.put(f"{prefix}.c.weight", _oihw(p["w"]))
        self.put(f"{prefix}.bn.weight", scale * np.sqrt(var + np.float32(BN_EPS)))
        self.put(f"{prefix}.bn.bias", np.asarray(p["bias"]) + mean * scale)
        self.put(f"{prefix}.bn.running_mean", mean)
        self.put(f"{prefix}.bn.running_var", var)


def _tiny_vit(w: _Writer, enc, e="image_encoder."):
    w.conv_bn(f"{e}patch_embed.seq.0", enc["patch_embed"]["conv1"])
    w.conv_bn(f"{e}patch_embed.seq.2", enc["patch_embed"]["conv2"])
    for i, stage in enumerate(enc["stages"]):
        for j, blk in enumerate(stage["blocks"]):
            b = f"{e}layers.{i}.blocks.{j}"
            if i == 0:
                for c in ("conv1", "conv2", "conv3"):
                    w.conv_bn(f"{b}.{c}", blk[c])
                continue
            w.ln(f"{b}.attn.norm", blk["attn"]["norm"])
            w.lin(f"{b}.attn.qkv", blk["attn"]["qkv"])
            w.lin(f"{b}.attn.proj", blk["attn"]["proj"])
            w.put(f"{b}.attn.attention_biases", blk["attn"]["attention_biases"])
            w.conv_bn(f"{b}.local_conv", blk["local_conv"])
            w.ln(f"{b}.mlp.norm", blk["mlp"]["norm"])
            w.lin(f"{b}.mlp.fc1", blk["mlp"]["fc1"])
            w.lin(f"{b}.mlp.fc2", blk["mlp"]["fc2"])
        if "downsample" in stage:
            for c in ("conv1", "conv2", "conv3"):
                w.conv_bn(f"{e}layers.{i}.downsample.{c}", stage["downsample"][c])
    _neck(w, enc["neck"], f"{e}neck.", ("0", "1", "2", "3"))


def _neck(w: _Writer, neck, prefix, names):
    w.conv(f"{prefix}{names[0]}", neck["conv1"])
    w.ln(f"{prefix}{names[1]}", neck["ln1"])
    w.conv(f"{prefix}{names[2]}", neck["conv2"])
    w.ln(f"{prefix}{names[3]}", neck["ln2"])


def _sam_vit(w: _Writer, enc, e="image_encoder."):
    for i, blk in enumerate(enc["blocks"]):
        b = f"{e}blocks.{i}"
        w.ln(f"{b}.norm1", blk["norm1"])
        w.lin(f"{b}.attn.qkv", blk["qkv"])
        w.lin(f"{b}.attn.proj", blk["proj"])
        w.ln(f"{b}.norm2", blk["norm2"])
        w.lin(f"{b}.mlp.lin1", blk["mlp"]["lin1"])
        w.lin(f"{b}.mlp.lin2", blk["mlp"]["lin2"])
        if "rel_pos_h" in blk:
            w.put(f"{b}.attn.rel_pos_h", blk["rel_pos_h"])
            w.put(f"{b}.attn.rel_pos_w", blk["rel_pos_w"])
    w.conv(f"{e}patch_embed.proj", enc["patch_embed"])
    _neck(w, enc["neck"], f"{e}neck.", ("0", "1", "2", "3"))
    if "pos_embed" in enc:
        w.put(f"{e}pos_embed", enc["pos_embed"])


def _attn(w: _Writer, prefix, p):
    for name, key in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                      ("out", "out_proj")):
        w.lin(f"{prefix}.{key}", p[name])


def official_sam_state_dict(tree, variant: str = "mobile_sam",
                            seed: int = 0) -> Dict[str, np.ndarray]:
    """A SAM tree -> the upstream checkpoint's state dict (MobileSAM's
    ``mobile_sam.pt`` or segment-anything's ``sam_vit_*.pth`` layout), as
    float32 numpy arrays; the BatchNorms' statistics come from ``seed``."""
    w = _Writer(seed)
    if variant == "mobile_sam":
        _tiny_vit(w, tree["encoder"])
    else:
        _sam_vit(w, tree["encoder"])
    pe, p = tree["prompt_encoder"], "prompt_encoder."
    w.put(f"{p}pe_layer.positional_encoding_gaussian_matrix", pe["pe_gaussian"])
    for i in range(4):
        w.put(f"{p}point_embeddings.{i}.weight", pe["point_embeddings"][i][None])
    w.put(f"{p}not_a_point_embed.weight", pe["not_a_point_embed"])
    w.put(f"{p}no_mask_embed.weight", pe["no_mask_embed"])
    md = pe["mask_downscaling"]
    w.conv(f"{p}mask_downscaling.0", md["conv1"])
    w.ln(f"{p}mask_downscaling.1", md["ln1"])
    w.conv(f"{p}mask_downscaling.3", md["conv2"])
    w.ln(f"{p}mask_downscaling.4", md["ln2"])
    w.conv(f"{p}mask_downscaling.6", md["conv3"])
    dec, m = tree["decoder"], "mask_decoder."
    for i, blk in enumerate(dec["transformer"]["blocks"]):
        b = f"{m}transformer.layers.{i}"
        _attn(w, f"{b}.self_attn", blk["self_attn"])
        _attn(w, f"{b}.cross_attn_token_to_image", blk["cross_attn_t2i"])
        _attn(w, f"{b}.cross_attn_image_to_token", blk["cross_attn_i2t"])
        for n in ("norm1", "norm2", "norm3", "norm4"):
            w.ln(f"{b}.{n}", blk[n])
        w.lin(f"{b}.mlp.lin1", blk["mlp"]["lin1"])
        w.lin(f"{b}.mlp.lin2", blk["mlp"]["lin2"])
    _attn(w, f"{m}transformer.final_attn_token_to_image",
          dec["transformer"]["final_attn"])
    w.ln(f"{m}transformer.norm_final_attn", dec["transformer"]["norm_final"])
    w.put(f"{m}iou_token.weight", dec["iou_token"])
    w.put(f"{m}mask_tokens.weight", dec["mask_tokens"])
    w.conv_t(f"{m}output_upscaling.0", dec["upscale"]["conv1"])
    w.ln(f"{m}output_upscaling.1", dec["upscale"]["ln"])
    w.conv_t(f"{m}output_upscaling.3", dec["upscale"]["conv2"])
    for i, mlp in enumerate(dec["hypernet_mlps"]):
        for j, layer in enumerate(mlp["layers"]):
            w.lin(f"{m}output_hypernetworks_mlps.{i}.layers.{j}", layer)
    for j, layer in enumerate(dec["iou_head"]["layers"]):
        w.lin(f"{m}iou_prediction_head.layers.{j}", layer)
    return w.sd


def _feed_forward(w: _Writer, prefix, p):
    layers = p["layers"]
    w.lin(f"{prefix}.proj_in", layers[0])
    for j, layer in enumerate(layers[1:-1]):
        w.lin(f"{prefix}.layers.{j}", layer)
    w.lin(f"{prefix}.proj_out", layers[-1])


def hf_sam_state_dict(tree) -> Dict[str, np.ndarray]:
    """A SAM tree with a ViT encoder -> a ``transformers`` SamModel's state
    dict (the names hf_sam.py reads), as float32 numpy arrays."""
    w = _Writer(0)
    enc, ve = tree["encoder"], "vision_encoder"
    for i, blk in enumerate(enc["blocks"]):
        b = f"{ve}.layers.{i}"
        w.ln(f"{b}.layer_norm1", blk["norm1"])
        w.lin(f"{b}.attn.qkv", blk["qkv"])
        w.lin(f"{b}.attn.proj", blk["proj"])
        w.ln(f"{b}.layer_norm2", blk["norm2"])
        w.lin(f"{b}.mlp.lin1", blk["mlp"]["lin1"])
        w.lin(f"{b}.mlp.lin2", blk["mlp"]["lin2"])
        if "rel_pos_h" in blk:
            w.put(f"{b}.attn.rel_pos_h", blk["rel_pos_h"])
            w.put(f"{b}.attn.rel_pos_w", blk["rel_pos_w"])
    w.conv(f"{ve}.patch_embed.projection", enc["patch_embed"])
    _neck(w, enc["neck"], f"{ve}.neck.",
          ("conv1", "layer_norm1", "conv2", "layer_norm2"))
    if "pos_embed" in enc:
        w.put(f"{ve}.pos_embed", enc["pos_embed"])
    pe, p = tree["prompt_encoder"], "prompt_encoder"
    w.put("shared_image_embedding.positional_embedding", pe["pe_gaussian"])
    for i in range(4):
        w.put(f"{p}.point_embed.{i}.weight", pe["point_embeddings"][i][None])
    w.put(f"{p}.not_a_point_embed.weight", pe["not_a_point_embed"])
    w.put(f"{p}.no_mask_embed.weight", pe["no_mask_embed"])
    md = pe["mask_downscaling"]
    w.conv(f"{p}.mask_embed.conv1", md["conv1"])
    w.ln(f"{p}.mask_embed.layer_norm1", md["ln1"])
    w.conv(f"{p}.mask_embed.conv2", md["conv2"])
    w.ln(f"{p}.mask_embed.layer_norm2", md["ln2"])
    w.conv(f"{p}.mask_embed.conv3", md["conv3"])
    dec, m = tree["decoder"], "mask_decoder"
    for i, blk in enumerate(dec["transformer"]["blocks"]):
        b = f"{m}.transformer.layers.{i}"
        _attn(w, f"{b}.self_attn", blk["self_attn"])
        _attn(w, f"{b}.cross_attn_token_to_image", blk["cross_attn_t2i"])
        _attn(w, f"{b}.cross_attn_image_to_token", blk["cross_attn_i2t"])
        for k in range(1, 5):
            w.ln(f"{b}.layer_norm{k}", blk[f"norm{k}"])
        w.lin(f"{b}.mlp.lin1", blk["mlp"]["lin1"])
        w.lin(f"{b}.mlp.lin2", blk["mlp"]["lin2"])
    _attn(w, f"{m}.transformer.final_attn_token_to_image",
          dec["transformer"]["final_attn"])
    w.ln(f"{m}.transformer.layer_norm_final_attn",
         dec["transformer"]["norm_final"])
    w.put(f"{m}.iou_token.weight", dec["iou_token"])
    w.put(f"{m}.mask_tokens.weight", dec["mask_tokens"])
    w.conv_t(f"{m}.upscale_conv1", dec["upscale"]["conv1"])
    w.ln(f"{m}.upscale_layer_norm", dec["upscale"]["ln"])
    w.conv_t(f"{m}.upscale_conv2", dec["upscale"]["conv2"])
    for i, mlp in enumerate(dec["hypernet_mlps"]):
        _feed_forward(w, f"{m}.output_hypernetworks_mlps.{i}", mlp)
    _feed_forward(w, f"{m}.iou_prediction_head", dec["iou_head"])
    return w.sd


def as_tensors(sd):
    """The same state dict as torch tensors (a checkpoint's form)."""
    import torch

    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
