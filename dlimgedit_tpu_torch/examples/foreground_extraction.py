"""Dichotomous foreground segmentation (BiRefNet): one-shot full-image mask.

Usage:
    python -m dlimgedit_tpu_torch.examples.foreground_extraction photo.png cutout.png
"""

import sys

import numpy as np

import dlimgedit_tpu_torch as dl


def main(argv=None, options=None):
    """`argv`/`options` are injectable so the test suite can execute this
    example end-to-end with a tiny random-weight config
    (test_torch_examples.py); run as a script it uses real models from
    ./models on the GPU."""
    argv = sys.argv[1:] if argv is None else argv
    src, dst = argv[0], argv[1]
    if options is None:
        options = dl.Options(backend=dl.Backend.gpu, model_directory="models")
    env = dl.Environment(options)

    img = dl.Image.load(src)
    mask = dl.segment_objects(img, env)  # >1536px inputs auto-select high-res

    # Compose an RGBA cutout: image + mask as alpha.
    rgb = img.pixels[:, :, :3] if img.pixels.shape[2] >= 3 else \
        np.repeat(img.pixels, 3, axis=2)
    rgba = np.dstack([rgb, mask.pixels[:, :, 0]])
    dl.Image.save(dl.ImageView.from_array(rgba, dl.Channels.rgba), dst)
    print(f"wrote {dst}")


if __name__ == "__main__":
    main()
