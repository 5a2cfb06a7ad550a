"""Canvas-row (spatial) sharding of BiRefNet and the TinyViT encoder
(counterpart of dlimgedit_tpu/parallel/spatial.py): not ported yet.

The JAX package states one sharding annotation and XLA derives a halo
exchange for every convolution, shifted Swin window, deformable gather and
resize. PyTorch needs a hand-written sharded rule for each of those layer
types, which is a slice of its own (ROADMAP.md A3b). Until then these
names raise."""

from __future__ import annotations

from ..errors import CANVAS_ROWS, not_in_this_slice

__all__ = ["birefnet_apply_spatial", "make_spatial_mesh",
           "segment_image_spatial"]


def make_spatial_mesh(*args, **kwargs):
    raise not_in_this_slice("make_spatial_mesh", CANVAS_ROWS)


def birefnet_apply_spatial(*args, **kwargs):
    raise not_in_this_slice("birefnet_apply_spatial", CANVAS_ROWS)


def segment_image_spatial(*args, **kwargs):
    raise not_in_this_slice("segment_image_spatial", CANVAS_ROWS)
