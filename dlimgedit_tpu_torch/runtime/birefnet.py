"""BiRefNet runtime: dichotomous foreground segmentation, `segment_objects`
(counterpart of dlimgedit_tpu/runtime/birefnet.py).

Kind escalation (an image side above 1536 px takes the high-resolution
model), the canvas resampled to the model's resolution and ImageNet
normalised on the device, the forward, floor(sigmoid * 255) to uint8, and
a box-filter resize back to the image's extent on the host. One
executable per ("birefnet", kind, bucket) key: a CUDA graph on the card
(``Environment.executable``). Over a mesh (Options.scaleout_devices) the
forward runs on canvas-row bands (parallel/spatial.py) and the executable
is eager: it crosses devices.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..convert.from_numpy import load_into
from ..errors import ModelNotFoundError
from ..image.resize import resize_mask
from ..models.birefnet import BiRefNet, BiRefNetConfig, birefnet_apply, init_birefnet
from ..models.swin import SwinConfig
from ..ops.postprocess import sigmoid_to_u8
from ..ops.preprocess import pack_and_put_canvas, pick_bucket, resolve_h2d_chunks
from ..ops.resample import apply_resample, resample_matrix
from ..types import Channels, Image, ImageView

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

BIREFNET_BUNDLES = {
    # Preference order with fallback, as the reference's
    # select_birefnet_model.
    "general": ("birefnet_general.npz", "birefnet_hr.npz"),
    "high_res": ("birefnet_hr.npz", "birefnet_general.npz"),
}
BIREFNET_RESOLUTION = {"general": 1024, "high_res": 2048}


class BiRefNetBundle:
    """A loaded BiRefNet: config and model, cast to the compute dtype and
    resident on the device."""

    def __init__(self, cfg: BiRefNetConfig, model: BiRefNet,
                 compute_dtype: torch.dtype, resolution: int):
        self.cfg = cfg
        self.resolution = resolution
        self.compute_dtype = compute_dtype
        self.model = model.eval().requires_grad_(False)


def slim_config(resolution: int, int8_gather: bool) -> BiRefNetConfig:
    """The narrow Swin and slim decoder of ``DLIMG_BIREFNET_TEST_SLIM=1``:
    random-weights pipeline tests on the CPU, never a served model."""
    return BiRefNetConfig(
        img_size=resolution, deform_int8_gather=int8_gather,
        swin_cfg=SwinConfig(embed_dim=16, depths=(1, 1, 1, 1),
                            num_heads=(2, 2, 2, 2), window=4),
        dec_inter_channels=8, aspp_channelster=12, gdt_channels=4,
        aspp_kernel_sizes=(1, 3))


def load_birefnet(env, kind: str) -> BiRefNetBundle:
    """The first bundle of ``BIREFNET_BUNDLES[kind]`` found (sha256 pin
    checked), else seeded random weights with ``allow_random_weights``,
    else ``ModelNotFoundError``. ``DLIMG_BIREFNET_RESOLUTION`` overrides
    the kind's resolution."""
    resolution = int(os.environ.get("DLIMG_BIREFNET_RESOLUTION",
                                    BIREFNET_RESOLUTION[kind]))
    int8 = env.options.birefnet_int8_deform
    cfg = BiRefNetConfig(img_size=resolution, deform_int8_gather=int8)
    for name in BIREFNET_BUNDLES[kind]:
        path = env.model_directory / "segmentation" / name
        if path.exists():
            model = load_into(BiRefNet(cfg), env._verified_load(path))
            break
    else:
        if not env.options.allow_random_weights:
            raise ModelNotFoundError(
                f"Could not find any BiRefNet model in {env.model_directory}")
        if os.environ.get("DLIMG_BIREFNET_TEST_SLIM") == "1":
            cfg = slim_config(resolution, int8)
        model = init_birefnet(torch.Generator().manual_seed(0), cfg)
    # The JAX package's cast_tree: every float leaf to the compute dtype.
    model = model.to(device=env.device, dtype=env.compute_dtype)
    return BiRefNetBundle(cfg, model, env.compute_dtype, resolution)


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device):
    """ImageNet's mean and std on `device`, made once (by a graphed
    executable's warm-up, never its capture)."""
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def birefnet_input(bundle: BiRefNetBundle, bucket: int, canvas: torch.Tensor,
                   sizes: torch.Tensor) -> torch.Tensor:
    """canvas (bucket, bucket, 3) uint8, valid region [:h, :w]; sizes (h,
    w) int32 on the device -> (1, S, S, 3) pixels at the model's
    resolution S (antialiased bilinear), ImageNet-normalised, in the
    compute dtype."""
    S = bundle.cfg.img_size
    dev = canvas.device
    img = canvas.float() / 255.0
    R = resample_matrix(S, bucket, S, sizes[0], antialias=True, device=dev)
    C = resample_matrix(S, bucket, S, sizes[1], antialias=True, device=dev)
    x = apply_resample(R, C, img)
    mean, std = _imagenet_stats(dev)
    return ((x - mean) / std)[None].to(bundle.compute_dtype)


def _build_birefnet_fn(bundle: BiRefNetBundle, bucket: int, mesh=None):
    """(canvas, sizes) -> the (S, S) uint8 mask at the model's resolution.
    With ``mesh`` the resize and normalise run on the first device and the
    forward's rows over the mesh; the logits come back whole."""

    def run(canvas, sizes):
        x = birefnet_input(bundle, bucket, canvas, sizes)
        if mesh is not None:
            from ..parallel.spatial import birefnet_apply_spatial

            logits = birefnet_apply_spatial(bundle.model, x, bundle.cfg, mesh)
        else:
            logits = birefnet_apply(bundle.model, x, bundle.cfg)
        return sigmoid_to_u8(logits[0, :, :, 0])  # logits (1, S, S, 1)

    return run


def _to_host(mask: torch.Tensor) -> np.ndarray:
    return mask.cpu().numpy()


def birefnet_segment(env, view: ImageView) -> Image:
    """`segment_objects`: the foreground mask at the image's extent."""
    extent = view.extent
    kind = ("high_res" if extent.width > 1536 or extent.height > 1536
            else "general")
    bundle = env.birefnet_model(kind)
    bucket = pick_bucket(extent)
    run = env.executable(("birefnet", kind, bucket),
                         lambda: _build_birefnet_fn(bundle, bucket, env.mesh),
                         _to_host, graphed=env.mesh is None)
    with run.lock:  # the static canvas is the graph's input
        canvas = pack_and_put_canvas(
            view, bucket, env.device, pool=env.canvas_pool,
            n_chunks=resolve_h2d_chunks(env.options.h2d_overlap_chunks),
            out=run.input_buffer(0))
        mask_model = run(canvas, env.sizes_on_device((extent.height,
                                                      extent.width)))
    out = resize_mask(ImageView.from_array(mask_model, Channels.mask), extent)
    return Image(extent, Channels.mask, out)
