"""Automatic mask generation on the port's Python-free serving route, on
the CPU: ``serve_amg_<variant>_<bucket>`` programs (``aot_export --amg
grid:max_masks``) run by the C library's ``generate_masks`` with
DLIMG_PJRT_BUNDLE set.

A MobileSAM bundle (sam_image_size 64, float32, canvas bucket 256, JAX's
seed-0 ``init_sam`` tree from a model directory), once with ``--amg
12:16`` (432 candidates: the runtime's pre-NMS pool ``_prenms_pool`` is
324, the JAX exporter's ``min(3G, max(256, 4K))`` would be 256) and once
with ``--amg 4:8`` (the JAX package's own serving case, 48 candidates):

- ``test_serving`` in a fresh process with no interpreter:
  ``generate_masks`` twice at permissive thresholds (the check's
  ``AMG_THRESHOLDS``) with its count, masks and accuracies byte-equal to
  the port's ``Segmentation.generate_masks`` at the bundle's grid and K;
  no P1 launch on the CPU (the plain loop runs).
- The winners hold against the JAX package's Python ``generate_masks``
  by the North star's tie rule (a flipped pixel only where JAX's logit is
  within 1e-4 of zero; accuracies within 2e-5), JAX as its own tests run
  it.
- ``test_serving_programs`` holds ``serve_amg`` (its samples at NMS 0.7,
  where the NMS suppresses) against the exporter's outputs;
  ``test_bundle_parse`` reads the amg row and its pool.
- Refusals: ``generate_masks`` with a bundle exported without ``--amg``
  and a malformed ``--amg``. The int8 options beside ``--amg`` (ROADMAP
  A8 (5)) export their quant row and a ``serve_amg`` that holds against
  the exporter's outputs.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

import dlimgedit_tpu as jdl
from dlimgedit_tpu_torch import native_build
from dlimgedit_tpu_torch.errors import DlimgError
from dlimgedit_tpu_torch.runtime import amg as pramg
from dlimgedit_tpu_torch.tools import aot_export, serving_check

from test_torch_amg import _assert_mask_matches, _jax_winner_logits
from test_torch_native_bridge import IMAGE_SIZE, model_dir  # noqa: F401

torch.set_num_threads(2)

SIZE = 256  # a 256 x 192 image and a 125 x 93 one: both in bucket 256
POINTS, BOXES = 2, 1
AMGS = {"12:16": (12, 16), "4:8": (4, 8)}


@pytest.fixture(scope="module")
def build():
    return native_build.build_serving()


@pytest.fixture(scope="module", params=list(AMGS))
def served(request, tmp_path_factory, model_dir, build):  # noqa: F811
    grid, k = AMGS[request.param]
    work = tmp_path_factory.mktemp(f"amg-{grid}")
    bundle, check = work / "bundle", work / "check"
    env = aot_export.export_serving(serving_check.bundle_args(
        bundle, SIZE, "cpu", IMAGE_SIZE, "float32", str(model_dir),
        amg=request.param))
    serving_check.write_goldens(env, check, SIZE, POINTS, BOXES)
    masks = serving_check.write_amg_goldens(env, check, grid, k)
    run = serving_check.run_test_serving(build, bundle, check, work, "cpu")
    return {"work": work, "bundle": bundle, "check": check, "env": env,
            "grid": grid, "k": k, "masks": masks, "stdout": run.stdout}


def test_the_c_host_generates_the_python_apis_masks(served):
    out, k = served["stdout"], served["k"]
    (w, h), _ = serving_check.image_sizes(SIZE)
    n = len(served["masks"])
    assert n == k  # NMS 1.0 keeps every candidate the decoder rated above 0
    for call in (1, 2):
        assert (f"generate_masks (call {call}) vs the Python API: {n} of {n} "
                f"masks, 0/{n * w * h} pixels differ, 0/{n} accuracies "
                f"differ in bits") in out
    # The CPU runs P1's plain loop: nothing is launched.
    assert (f"launches per generate_masks {w}x{h}: K1 0 K2 0 K3 0 K4 0 K5 0 "
            f"P1 0") in out
    assert "Py_IsInitialized: 0 (libpython linked, never started)" in out
    assert not (served["work"] / serving_check.MARKER).exists()


def test_the_served_winners_hold_against_jax_by_the_tie_rule(
        served, model_dir):  # noqa: F811
    grid, k = served["grid"], served["k"]
    (w, h), _ = serving_check.image_sizes(SIZE)
    px = np.frombuffer((served["check"] / "image.raw").read_bytes(),
                       np.uint8).reshape(h, w, 4)
    je = jdl.Environment(jdl.Options(
        backend=jdl.Backend.cpu, model_directory=str(model_dir),
        sam_image_size=IMAGE_SIZE, compute_dtype="float32"))
    js = jdl.Segmentation.process(
        jdl.Image(jdl.Extent(w, h), jdl.Channels.rgba, px), je)
    iou, stab, nms = serving_check.AMG_THRESHOLDS
    want = js.generate_masks(grid=grid, max_masks=k, iou_thresh=iou,
                             stability_thresh=stab, nms_thresh=nms)
    got = served["masks"]
    assert len(got) == len(want)
    np.testing.assert_allclose([g.accuracy for g in got],
                               [m.accuracy for m in want], atol=2e-5, rtol=0)
    logits = _jax_winner_logits(je, js, grid, [m.accuracy for m in want])
    for i, (g, m) in enumerate(zip(got, want)):
        _assert_mask_matches(g.image.pixels, np.asarray(m.image.pixels),
                             lambda i=i: logits[i])


def test_serve_amg_equals_the_exporters_outputs_with_the_runtimes_pool(
        served, build):
    grid, k = served["grid"], served["k"]
    r = serving_check.run_test_programs(build, served["bundle"],
                                        served["work"], "cpu")
    name = f"serve_amg_mobile_sam_{SIZE}"
    assert f"{name}: PASS" in r.stdout
    for i, size in enumerate((k * SIZE * SIZE // 8, 4 * k, 4 * k, 4 * k)):
        assert f"{name} out{i}: 0/{size} bytes differ" in r.stdout
    pool = pramg._prenms_pool(grid * grid, k)
    assert pool == {12: 324, 4: 48}[grid]
    assert (f"serving.txt: amg grid {grid}, max_masks {k}, pre-NMS pool "
            f"{pool}\n") in r.stdout
    # The Python executable that wrote the outputs is generate_masks' own.
    assert ("amg", "mobile_sam", SIZE, grid, k, pool, False) in \
        served["env"].executables
    txt = (served["bundle"] / "serving.txt").read_text()
    assert f"amg\t{grid}:{k}\n" in txt
    # The samples' NMS (0.7) suppresses: fewer winners than K.
    scores = np.load(served["bundle"] / f"{name}.out1.npy")
    assert 0 < int((scores > 0).sum()) < k


def test_dlimg_info_reports_the_amg_row(served, build):
    env = serving_check.fresh_env(served["work"],
                                  DLIMG_PJRT_BUNDLE=str(served["bundle"]))
    r = subprocess.run([str(build.executable("dlimg")), "info"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    grid, k = served["grid"], served["k"]
    pool = pramg._prenms_pool(grid * grid, k)
    assert f"bundle amg: grid {grid}, {k} masks, pre-NMS pool {pool}" \
        in r.stdout
    assert "bundle birefnet: none (segment_objects is refused)" in r.stdout


def test_max_masks_is_clamped_to_the_candidates(
        tmp_path, model_dir):  # noqa: F811
    """K above the grid's 3 * grid^2 candidates is clamped, as
    generate_masks clamps it."""
    aot_export.export_serving(serving_check.bundle_args(
        tmp_path, SIZE, "cpu", IMAGE_SIZE, "float32", str(model_dir),
        amg="2:99"))
    assert "amg\t2:12\n" in (tmp_path / "serving.txt").read_text()
    scores = np.load(tmp_path / f"serve_amg_mobile_sam_{SIZE}.out1.npy")
    assert scores.shape == (12,)


def test_a_bundle_without_amg_refuses_generate_masks(served, build,
                                                     tmp_path):
    bundle = tmp_path / "bundle"
    shutil.copytree(served["bundle"], bundle)
    txt = bundle / "serving.txt"
    txt.write_text("".join(line for line in txt.read_text().splitlines(True)
                           if not line.startswith("amg\t")))
    with pytest.raises(RuntimeError) as e:
        serving_check.run_test_serving(build, bundle, served["check"],
                                       tmp_path, "cpu")
    assert "generate_masks: the serving bundle was exported without --amg" \
        in str(e.value)


@pytest.mark.parametrize("amg", ["12", "12:0", "x:8", "4:8:2"])
def test_a_malformed_amg_raises(tmp_path, amg):
    args = aot_export.parse_args(["--out", str(tmp_path), "--backend", "cpu",
                                  "--amg", amg])
    with pytest.raises(DlimgError, match="grid:max_masks, two positive"):
        aot_export.export_serving(args)
    assert not (tmp_path / "serving.txt").exists()


# The int8 options beside --amg (ROADMAP A8 (5), served since format 5):
# serving.txt's quant row as the JAX exporter spells it.
_INT8_ROWS = {"--quantize": "w8", "--quantize-activations": "w8,a8",
              "--int8-deform": "deform8"}


@pytest.mark.parametrize("flag", ["--quantize", "--quantize-activations",
                                  "--int8-deform"])
def test_the_int8_options_still_name_a8_5(tmp_path, model_dir, build,  # noqa: F811
                                          flag):
    """Each int8 option with --amg 4:8 exports A8 (5)'s bundle: its quant
    row in the JAX exporter's spelling, and serve_amg on the int8 encoder's
    embedding held against the exporter's outputs."""
    args = aot_export.parse_args([
        "--out", str(tmp_path / "bundle"), "--backend", "cpu",
        "--sam-image-size", str(IMAGE_SIZE), "--buckets", "256",
        "--compute-dtype", "float32", "--models", str(model_dir),
        "--amg", "4:8", flag])
    aot_export.export_serving(args)
    rows = dict(ln.split("\t", 1) for ln in
                (tmp_path / "bundle" / "serving.txt").read_text().splitlines())
    assert rows["quant"] == _INT8_ROWS[flag] and rows["amg"] == "4:8"
    r = subprocess.run(
        [str(build.executable("test_serving_programs")), "cpu",
         str(tmp_path / "bundle"), "serve_embed_mobile_sam_256",
         "serve_amg_mobile_sam_256"], env=serving_check.fresh_env(tmp_path),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-2000:]
    assert "serve_amg_mobile_sam_256: PASS" in r.stdout
