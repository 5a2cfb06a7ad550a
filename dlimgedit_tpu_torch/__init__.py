"""dlimgedit_tpu_torch — the PyTorch / CUDA port of dlimgedit_tpu.

Interactive segmentation with MobileSAM (TinyViT-5M encoder) or SAM ViT-B,
-L, -H (``Options.sam_variant``), each with the SAM prompt encoder and mask
decoder, and dichotomous foreground segmentation with BiRefNet
(``segment_objects``), on an NVIDIA GPU, with the same public vocabulary
as the JAX package. The SAM encoders' LayerNorms and attention run as
hand-written CUDA kernels (``csrc/``), built with nvcc at first use.

Quick start::

    import dlimgedit_tpu_torch as dl

    env = dl.Environment(dl.Options(model_directory="models"))  # cuda:0
    seg = dl.Segmentation.process(img, env)      # embed once (on the GPU)
    mask = seg.compute_mask(dl.Point(320, 210))  # cheap interactive queries
    masks = seg.compute_masks(dl.Point(320, 210))  # 3 candidates + accuracy
    every = seg.generate_masks()                 # segment everything
    fg = dl.segment_objects(img, env)            # remove background

The port imports neither jax nor dlimgedit_tpu. The encoders may be
quantised to int8 (``Options.quantize_encoder``, ``quantize_activations``).
Batches of frames run through ``parallel.batch`` (``encode_frames``,
``segment_frames``), on one device or over a (dp, tp) mesh; ``parallel``
also shards one image's ViT over an ('sp',) mesh and joins processes on
``torch.distributed``; ``train`` fine-tunes, distils and checkpoints, on
one device or over a mesh. ``scaleout_devices`` 0 or N encodes the ViTs
sequence-parallel over 2 or more CUDA devices, and runs MobileSAM and
BiRefNet on canvas-row bands over them, and serves as 1 where the backend
has fewer. ``convert`` turns upstream MobileSAM, SAM, HF SAM and BiRefNet
checkpoints into the weight bundles both packages load
(``python -m dlimgedit_tpu_torch.convert.mobile_sam src.pt dst.npz``);
``native_bridge`` is the marshalling layer a C ABI host calls.
"""

from .errors import DlimgError, ModelNotFoundError, UnsupportedImageError
from .runtime.amg import generate_masks_image
from .runtime.environment import Environment, is_supported
from .runtime.segmentation import Mask, Segmentation, segment_objects
from .types import (
    Backend,
    Channels,
    Extent,
    Image,
    ImageView,
    Options,
    Point,
    Region,
    channel_count,
)

__version__ = "0.1.0"

__all__ = [
    "Backend", "Channels", "DlimgError", "Environment", "Extent", "Image",
    "ImageView", "Mask", "ModelNotFoundError", "Options", "Point", "Region",
    "Segmentation", "UnsupportedImageError", "channel_count",
    "generate_masks_image", "is_supported", "segment_objects",
    "__version__",
]
