"""dlimgedit_tpu_torch — the PyTorch / CUDA port of dlimgedit_tpu.

Interactive segmentation with MobileSAM (TinyViT-5M encoder + SAM prompt
encoder and mask decoder) on an NVIDIA GPU, with the same public
vocabulary as the JAX package. The encoder's LayerNorm and LeViT window
attention run as hand-written CUDA kernels (``csrc/``), built with nvcc at
first use.

Quick start::

    import dlimgedit_tpu_torch as dl

    env = dl.Environment(dl.Options(model_directory="models"))  # cuda:0
    seg = dl.Segmentation.process(img, env)      # embed once (on the GPU)
    mask = seg.compute_mask(dl.Point(320, 210))  # cheap interactive queries
    masks = seg.compute_masks(dl.Point(320, 210))  # 3 candidates + accuracy

The port imports neither jax nor dlimgedit_tpu. ViT-B/L/H, automatic mask
generation, BiRefNet, quantisation and the parallel tiers come with later
slices and raise ``DlimgError`` here.
"""

from .errors import DlimgError, ModelNotFoundError, UnsupportedImageError
from .runtime.environment import Environment, is_supported
from .runtime.segmentation import (
    Mask,
    Segmentation,
    generate_masks_image,
    segment_objects,
)
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
