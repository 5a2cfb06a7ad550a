"""Segment everything: every object mask of an image in one device program.

Usage:
    python -m dlimgedit_tpu_torch.examples.generate_masks photo.png out_dir/

The upstream-SAM automatic mask generator is a host loop (per-point
predictor calls + numpy filtering + torch NMS; seconds per image).  Here
the point grid, the grid^2 x 3 candidate decodes, the IoU/stability
filters, the greedy box NMS (a CUDA kernel, csrc/greedy_nms.cu) and the
top-K mask rendering all run as ONE CUDA graph against the cached image
embedding: one launch, one fetch. The reference library has no
counterpart feature.
"""

import os
import sys

import dlimgedit_tpu_torch as dl


def main(argv=None, options=None, grid=32, max_masks=32):
    """`argv`/`options`/`grid` are injectable so the test suite executes
    this example end-to-end with a tiny random-weight config."""
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0]
    out_dir = argv[1] if len(argv) > 1 else "masks"

    if options is None:
        options = dl.Options(backend=dl.Backend.gpu, model_directory="models")
    env = dl.Environment(options)

    img = dl.Image.load(path)
    seg = dl.Segmentation.process(img, env)  # embed once

    masks = seg.generate_masks(grid=grid, max_masks=max_masks)
    os.makedirs(out_dir, exist_ok=True)
    for i, m in enumerate(masks):
        dl.Image.save(m.image.view(), os.path.join(out_dir, f"mask_{i:03d}.png"))
    print(f"generated {len(masks)} masks "
          f"(best predicted IoU {masks[0].accuracy:.3f})"
          if masks else "generated 0 masks")


if __name__ == "__main__":
    main()
