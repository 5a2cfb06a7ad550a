"""``serve_decode_batch<N>`` on the port's Python-free route, and the
bundle format's new rows and refusals, on the CPU.

A MobileSAM bundle (sam_image_size 64, float32, canvas buckets 256 and
512, JAX's seed-0 ``init_sam`` tree from a model directory) exported with
``--batch-sizes 2,4``:

- ``test_serving`` in a fresh process with no interpreter: requests of 3
  prompts (one program of 4, one slot padded with the (-1, -1) labels)
  and of 5 (4, then 2 with one padded), and the two-thread leg with a
  batch each round; every mask byte-equal to ``compute_mask``'s for its
  prompt and every accuracy bit-equal to the Python API's batch.
- ``test_serving_programs``: every program, the batch programs included,
  against the exporter's outputs; ``test_bundle_parse`` reads serving.txt
  (the encoder, its route, the batch sizes).
- The C library takes the batch programs where the bundle has them: a
  bundle without ``serve_decode_batch4`` fails the request of 3.
- Refusals: a batch size that is not a positive integer, a gpu bundle
  with the kernel route off (by the exporter and by the reader), and a
  bundle of the previous format.

Both sides of a byte comparison run at two CPU threads (see
test_torch_serving_vit.py).
"""

import dataclasses
import shutil
import subprocess

import pytest

from dlimgedit_tpu_torch import native_build
from dlimgedit_tpu_torch.errors import DlimgError
from dlimgedit_tpu_torch.tools import aot_export, serving_check

from test_torch_native_bridge import IMAGE_SIZE, model_dir  # noqa: F401

SIZE = 400  # a 400 x 300 image (bucket 512) and a 195 x 146 one (256)
POINTS, BOXES = 3, 2
PROGRAMS = sorted(f"serve_{p}_mobile_sam_{b}" for b in (256, 512)
                  for p in ("embed", "decode", "decode3", "decode_batch2",
                            "decode_batch4"))


@pytest.fixture(scope="module")
def build():
    return native_build.build_serving()


@pytest.fixture(scope="module")
def served(tmp_path_factory, model_dir, build):  # noqa: F811
    work = tmp_path_factory.mktemp("serving-batch")
    bundle, check = work / "bundle", work / "check"
    env = aot_export.export_serving(serving_check.bundle_args(
        bundle, SIZE, "cpu", IMAGE_SIZE, "float32", str(model_dir),
        batch_sizes="4,2"))
    goldens = serving_check.write_goldens(env, check, SIZE, POINTS, BOXES)
    run = serving_check.run_test_serving(build, bundle, check, work, "cpu")
    return {"work": work, "bundle": bundle, "check": check, "env": env,
            "goldens": goldens, "stdout": run.stdout}


def test_batch_requests_equal_compute_mask_without_python(served):
    out = served["stdout"]
    n = POINTS + BOXES
    (w, h), _ = serving_check.image_sizes(SIZE)
    for k in (3, n):
        assert (f"compute_mask_batch of {k} vs the Python API: 0/{k * w * h} "
                f"pixels differ, 0/{k} accuracies differ in bits") in out
    assert (f"concurrent process of 2 images x 8 rounds vs the Python API: "
            f"0/{2 * 8 * w * h} pixels differ; batches of {n}: 0 pixels and "
            f"accuracies differ") in out
    assert f"launches per process {w}x{h}: K1 0 K2 0 K3 0 K4 0 K5 0" in out
    assert "Py_IsInitialized: 0 (libpython linked, never started)" in out
    assert not (served["work"] / serving_check.MARKER).exists()


def test_every_program_with_the_batch_programs_equals_python(served, build):
    assert serving_check.programs(served["bundle"]) == PROGRAMS
    r = serving_check.run_test_programs(build, served["bundle"],
                                        served["work"], "cpu")
    for name in PROGRAMS:
        assert f"{name}: PASS" in r.stdout
    n = len(PROGRAMS)
    assert (f"programs byte-equal to the exporter's outputs: {n} of {n} "
            f"given, the bundle has {n}") in r.stdout
    assert f"bundle parse OK: {n} programs" in r.stdout
    assert ("serving.txt: variant mobile_sam, encoder tinyvit, kernel route "
            "off, batch sizes [2,4]\n") in r.stdout
    txt = (served["bundle"] / "serving.txt").read_text()
    assert "format\tdlimgedit_tpu_torch-serving-5\n" in txt
    assert "batch\t2,4\n" in txt


def test_the_batch_programs_serve_the_batch(served, build, tmp_path):
    """Without serve_decode_batch4 the request of 3 fails, naming it: the
    C library took the batch program, not the per-prompt loop."""
    bundle = tmp_path / "bundle"
    shutil.copytree(served["bundle"], bundle)
    for f in bundle.glob("serve_decode_batch4_mobile_sam_512.*"):
        f.unlink()
    with pytest.raises(RuntimeError) as e:
        serving_check.run_test_serving(build, bundle, served["check"],
                                       tmp_path, "cpu")
    assert "serve_decode_batch4_mobile_sam_512" in str(e.value)
    assert "compute_mask_batch" in str(e.value)


def test_dlimg_info_reports_the_variant_and_the_batch_sizes(served, build):
    env = serving_check.fresh_env(served["work"],
                                  DLIMG_PJRT_BUNDLE=str(served["bundle"]))
    r = subprocess.run([str(build.executable("dlimg")), "info"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert ("bundle variant: mobile_sam (encoder tinyvit, kernel route off)"
            in r.stdout)
    assert "bundle batch sizes: 2,4" in r.stdout
    assert not (served["work"] / serving_check.MARKER).exists()


@pytest.mark.parametrize("sizes", ["0", "x", "2,-1", "1.5"])
def test_a_batch_size_that_is_no_positive_integer_raises(tmp_path, sizes):
    args = aot_export.parse_args(["--out", str(tmp_path), "--backend", "cpu",
                                  "--batch-sizes", sizes])
    with pytest.raises(DlimgError, match="positive integer"):
        aot_export.export_serving(args)
    assert not (tmp_path / "serving.txt").exists()


def test_the_exporter_refuses_a_gpu_bundle_with_the_route_off(served,
                                                              tmp_path):
    """A gpu bundle runs the encoder's kernels: an environment whose
    config has them off (a CPU one here) is refused."""
    args = aot_export.parse_args(["--out", str(tmp_path), "--backend", "gpu",
                                  "--sam-image-size", str(IMAGE_SIZE),
                                  "--buckets", "256"])
    with pytest.raises(DlimgError, match="kernel route off"):
        aot_export.export_serving(args, env=served["env"])
    assert not (tmp_path / "serving.txt").exists()


@pytest.mark.parametrize("edit", ["format_2", "gpu_route_off"])
def test_the_reader_refuses_an_old_format_and_a_gpu_bundle_route_off(
        served, build, tmp_path, edit):
    bundle = tmp_path / "bundle"
    shutil.copytree(served["bundle"], bundle)
    txt = bundle / "serving.txt"
    if edit == "format_2":
        txt.write_text(txt.read_text().replace("serving-5", "serving-4"))
        why = ("names the bundle format 'dlimgedit_tpu_torch-serving-4', not "
               "the port's dlimgedit_tpu_torch-serving-5")
    else:
        txt.write_text(txt.read_text().replace("backend\tcpu", "backend\tgpu"))
        why = "a gpu bundle must have the encoder's kernel route on"
    p = subprocess.run([str(build.executable("test_bundle_parse")),
                        str(bundle)], capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 1 and why in p.stderr, p.stderr
    device = "gpu" if edit == "gpu_route_off" else "cpu"
    r = subprocess.run([str(build.executable("test_serving_programs")),
                        device, str(bundle), "serve_embed_mobile_sam_256"],
                       env=serving_check.fresh_env(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1 and why in r.stderr, r.stderr
    env = serving_check.fresh_env(tmp_path, DLIMG_PJRT_BUNDLE=str(bundle))
    r = subprocess.run([str(build.executable("dlimg")), "info"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert why in r.stdout


@pytest.mark.parametrize("config", ["tinyvit_flags_apart",
                                    "vit_fused_window_blocks"])
def test_the_exporter_refuses_a_route_it_cannot_serve(tmp_path, config):
    """TinyViT's K1 and K2 run together (one kernel_route row), and a ViT's
    windows run partitioned: a bundle configured otherwise is refused."""
    variant = "mobile_sam" if config.startswith("tinyvit") else "vit_b"
    args = aot_export.parse_args(["--out", str(tmp_path), "--backend", "cpu",
                                  "--variant", variant, "--sam-image-size",
                                  str(IMAGE_SIZE), "--buckets", "256"])
    env = aot_export.make_environment(args)
    bundle = env.sam_model(variant)
    if variant == "mobile_sam":
        bundle.cfg = dataclasses.replace(bundle.cfg, encoder_tiny=(
            dataclasses.replace(bundle.cfg.encoder_tiny, use_fused_norm=True)))
        match = "use_flash_attention and use_fused_norm differ"
    else:
        bundle.cfg = dataclasses.replace(bundle.cfg, encoder_vit=(
            dataclasses.replace(bundle.cfg.encoder_vit,
                                fused_window_blocks=True)))
        match = "fused_window_blocks"
    with pytest.raises(DlimgError, match=match):
        aot_export.export_serving(args, env=env)
    assert not (tmp_path / "serving.txt").exists()
