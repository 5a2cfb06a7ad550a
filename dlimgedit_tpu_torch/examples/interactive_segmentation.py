"""Interactive segmentation: embed once, query many masks.

Usage:
    python -m dlimgedit_tpu_torch.examples.interactive_segmentation photo.png 320 210 out_mask.png

Equivalent C++ (header dlimgedit_tpu_torch/native/include/dlimgedit/dlimgedit.hpp):
    auto env = dlimg::Environment({dlimg::Backend::gpu, "models"});
    auto seg = dlimg::Segmentation::process(img, env);
    auto mask = seg.compute_mask(dlimg::Point{320, 210});
"""

import sys

import dlimgedit_tpu_torch as dl


def main(argv=None, options=None):
    """`argv`/`options` are injectable so the test suite can execute this
    example end-to-end with a tiny random-weight config
    (test_torch_examples.py); run as a script it uses real models from
    ./models on the GPU."""
    argv = sys.argv[1:] if argv is None else argv
    path, x, y = argv[0], int(argv[1]), int(argv[2])
    out = argv[3] if len(argv) > 3 else "mask.png"

    if options is None:
        options = dl.Options(backend=dl.Backend.gpu, model_directory="models")
    env = dl.Environment(options)

    img = dl.Image.load(path)
    seg = dl.Segmentation.process(img, env)   # expensive once; cached on device

    # Single best mask for a point.
    mask = seg.compute_mask(dl.Point(x, y))
    dl.Image.save(mask.view(), out)
    print(f"wrote {out} ({mask.extent.width}x{mask.extent.height})")

    # Three ranked candidates (ambiguous prompts).
    for i, m in enumerate(seg.compute_masks(dl.Point(x, y))):
        print(f"candidate {i}: predicted IoU {m.accuracy:.3f}")

    # Box prompt; optionally keep only the largest object in the box.
    h, w = img.extent.height, img.extent.width
    box = dl.Region(dl.Point(w // 4, h // 4), dl.Point(3 * w // 4, 3 * h // 4))
    seg.compute_mask(box, largest_component=True)

    # Many prompts in one device round trip.
    prompts = [dl.Point(x + dx, y) for dx in (-20, 0, 20)]
    batch = seg.compute_mask_batch(prompts)
    print(f"batched {len(batch)} prompts in one dispatch")


if __name__ == "__main__":
    main()
