"""BiRefNet ``segment_objects`` on the port's Python-free serving route, on
the CPU: ``serve_birefnet_<kind>_<bucket>`` programs (``aot_export
--birefnet kind:bucket,...``) run by the C library's ``segment_objects``
with DLIMG_PJRT_BUNDLE set.

One slim BiRefNet at resolution 64 in both packages: JAX's seed-0
``init_birefnet`` tree with nonzero offsets (the deformable convs sample
off the grid), Swin depths (2, 2, 1, 1) so that the first two stages run
shifted windows (their masks are weights of the bundle), served as the
``general`` and the ``high_res`` model, float32. The bundle: MobileSAM at
64 (JAX's seed-0 tree) in bucket 256, ``--birefnet general:256,
high_res:2048``.

- ``test_serving`` in a fresh process with no interpreter:
  ``segment_objects`` of a 256 x 192 image (``general``, bucket 256) and
  of a 2000 x 1500 one (above 1536 px: ``high_res``, bucket 2048; the
  general kind has no bucket that holds it) within one grey level a pixel
  of the port's Python API (the C host resizes with the native box
  filter, the Python API with numpy), and an image over every bucket
  refused; no kernel launch (BiRefNet runs none of the port's kernels).
- The served masks hold within one grey level against the JAX package's
  ``segment_objects``.
- ``test_serving_programs``: each BiRefNet program's (S, S) mask
  byte-equal to the Python executable's; ``test_bundle_parse`` reads the
  configuration rows, and refuses a birefnet row without them.
- The exporter refuses a malformed ``--birefnet``.
"""

import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlimgedit_tpu as jdl
from dlimgedit_tpu.models import birefnet as jbn
from dlimgedit_tpu.models.swin import SwinConfig as JSwinConfig
from dlimgedit_tpu.runtime import birefnet as jrbn
from dlimgedit_tpu_torch import native_build
from dlimgedit_tpu_torch.errors import DlimgError
from dlimgedit_tpu_torch.models import birefnet as bn
from dlimgedit_tpu_torch.models.swin import SwinConfig
from dlimgedit_tpu_torch.runtime import birefnet as prbn
from dlimgedit_tpu_torch.tools import aot_export, serving_check

from _torch_train_util import _nonzero, load, np_tree
from test_torch_native_bridge import IMAGE_SIZE, model_dir  # noqa: F401

torch.set_num_threads(2)

SIZE = 256  # the SAM images and the general BiRefNet image: bucket 256
RESOLUTION = 64
SPECS = "general:256,high_res:2048"
KINDS = ("general", "high_res")
PROGRAMS = ("serve_birefnet_general_256", "serve_birefnet_high_res_2048")


def _configs():
    kw = dict(img_size=RESOLUTION, dec_inter_channels=8, aspp_channelster=12,
              gdt_channels=4, aspp_kernel_sizes=(1, 3))
    sw = dict(embed_dim=16, depths=(2, 2, 1, 1), num_heads=(2, 2, 2, 2),
              window=4)
    return (jbn.BiRefNetConfig(swin_cfg=JSwinConfig(**sw), **kw),
            bn.BiRefNetConfig(swin_cfg=SwinConfig(**sw), **kw))


@pytest.fixture(scope="module")
def envs(model_dir):  # noqa: F811
    """(JAX's, the port's) environment, each holding the slim BiRefNet as
    both kinds."""
    jcfg, cfg = _configs()
    tree = _nonzero(np_tree(jbn.init_birefnet(jax.random.PRNGKey(0), jcfg)),
                    seed=3)
    model = load(bn.BiRefNet(cfg), tree)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    je = jdl.Environment(jdl.Options(
        backend=jdl.Backend.cpu, model_directory=str(model_dir),
        sam_image_size=IMAGE_SIZE, compute_dtype="float32"))
    pe = aot_export.make_environment(serving_check.bundle_args(
        model_dir, SIZE, "cpu", IMAGE_SIZE, "float32", str(model_dir)))
    for kind in KINDS:
        jb = jrbn.BiRefNetBundle(jcfg, jtree, je.put_target, jnp.float32,
                                 RESOLUTION)
        assert je._birefnet_models[kind].get_or_create(lambda: jb) is jb
        pb = prbn.BiRefNetBundle(cfg, model, torch.float32, RESOLUTION)
        assert pe._birefnet_models[kind].get_or_create(lambda: pb) is pb
    return je, pe


@pytest.fixture(scope="module")
def build():
    return native_build.build_serving()


@pytest.fixture(scope="module")
def served(tmp_path_factory, envs, model_dir, build):  # noqa: F811
    je, pe = envs
    work = tmp_path_factory.mktemp("serving-birefnet")
    bundle, check = work / "bundle", work / "check"
    aot_export.export_serving(serving_check.bundle_args(
        bundle, SIZE, "cpu", IMAGE_SIZE, "float32", str(model_dir),
        birefnet=SPECS), env=pe)
    serving_check.write_goldens(pe, check, SIZE, 1, 0)
    images = serving_check.write_birefnet_goldens(pe, check, SIZE,
                                                  [256, 2048])
    run = serving_check.run_test_serving(build, bundle, check, work, "cpu")
    return {"work": work, "bundle": bundle, "check": check, "je": je,
            "images": images, "stdout": run.stdout}


def test_the_c_host_segments_within_one_level_of_the_python_api(served):
    out = served["stdout"]
    sizes = serving_check.birefnet_images(SIZE, [256, 2048])
    assert [m.shape[::-1] for _, m in served["images"]] == sizes[:2]
    for (w, h), kind in zip(sizes[:2], KINDS):
        line = next(l for l in out.splitlines()
                    if l.startswith(f"segment_objects {w}x{h} ({kind}) vs "
                                    f"the Python API: "))
        assert line.endswith(("by at most 0", "by at most 1")), line
        assert f"launches per segment_objects {w}x{h}: K1 0 K2 0 K3 0 K4 0 " \
            f"K5 0 P1 0" in out
    ow, oh = sizes[2]
    assert (f"segment_objects {ow}x{oh}: refused (segment_objects: image "
            f"{ow}x{oh} exceeds every BiRefNet bucket") in out
    assert "Py_IsInitialized: 0 (libpython linked, never started)" in out
    assert not (served["work"] / serving_check.MARKER).exists()


def test_the_served_masks_hold_against_jax(served):
    for i, (px, want_port) in enumerate(served["images"]):
        h, w = want_port.shape
        got = np.frombuffer((served["work"] / f"served_birefnet{i}.raw")
                            .read_bytes(), np.uint8).reshape(h, w)
        want = np.asarray(jdl.segment_objects(
            jdl.Image(jdl.Extent(w, h), jdl.Channels.rgb, px),
            served["je"]).pixels).reshape(h, w)
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1, (i, int(diff.max()), int((diff > 1).sum()))
        # The masks are no constant: the model segments something.
        assert int(want.max()) - int(want.min()) > 16


def test_each_birefnet_program_equals_the_python_executable(served, build):
    r = serving_check.run_test_programs(build, served["bundle"],
                                        served["work"], "cpu")
    for name in PROGRAMS:
        assert f"{name}: PASS" in r.stdout
        assert (f"{name} out0: 0/{RESOLUTION * RESOLUTION} bytes differ"
                in r.stdout)
    assert ("serving.txt: birefnet general:256:64,high_res:2048:64, "
            "embed_dim 16, depths [2,2,1,1], num_heads [2,2,2,2], window 4, "
            "patch_size 4, layer_norm_eps 1e-05, decoder channels [8,12,4], "
            "aspp kernel sizes [1,3], mul_scl_ipt cat, cxt_num 3\n"
            in r.stdout)
    # Each kind's weights and index tables once, under its prefix: the
    # rel-pos index, the shift masks of the two shifted stages (16 x 16 and
    # 8 x 8 at 64; 8 x 8 and 4 x 4 in the half-resolution pass), the
    # align-corners matrices.
    weights = {p.name[:-4] for p in (served["bundle"] / "weights").iterdir()}
    for kind in KINDS:
        tables = {w[len(f"birefnet.{kind}.tables."):] for w in weights
                  if w.startswith(f"birefnet.{kind}.tables.")}
        assert {"rel_pos_index", "shift_mask.16x16", "shift_mask.8x8",
                "shift_mask.4x4", "ac.32x64", "ac.64x16"} <= tables
        assert f"birefnet.{kind}.backbone.patch_embed.w" in weights


def test_dlimg_info_reports_the_birefnet_row(served, build):
    env = serving_check.fresh_env(served["work"],
                                  DLIMG_PJRT_BUNDLE=str(served["bundle"]))
    r = subprocess.run([str(build.executable("dlimg")), "info"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "bundle birefnet: general:256:64,high_res:2048:64" in r.stdout
    assert "bundle amg: none (generate_masks is refused)" in r.stdout


@pytest.mark.parametrize("row", ["birefnet_num_heads", "birefnet_cxt_num",
                                 "birefnet_aspp_kernel_sizes"])
def test_the_reader_refuses_a_birefnet_row_without_its_configuration(
        served, build, tmp_path, row):
    bundle = tmp_path / "bundle"
    shutil.copytree(served["bundle"], bundle)
    txt = bundle / "serving.txt"
    txt.write_text("".join(line for line in txt.read_text().splitlines(True)
                           if not line.startswith(row + "\t")))
    p = subprocess.run([str(build.executable("test_bundle_parse")),
                        str(bundle)], capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 1
    assert "has a birefnet row but lacks the BiRefNet's configuration rows" \
        in p.stderr


def test_a_bundle_without_birefnet_refuses_segment_objects(served, build,
                                                           tmp_path):
    bundle = tmp_path / "bundle"
    shutil.copytree(served["bundle"], bundle)
    txt = bundle / "serving.txt"
    txt.write_text("".join(line for line in txt.read_text().splitlines(True)
                           if not line.startswith("birefnet")))
    with pytest.raises(RuntimeError) as e:
        serving_check.run_test_serving(build, bundle, served["check"],
                                       tmp_path, "cpu")
    assert "segment_objects: the serving bundle has no BiRefNet program" \
        in str(e.value)


@pytest.mark.parametrize("spec", ["medium:256", "general:300", "general",
                                  "high_res:x"])
def test_a_malformed_birefnet_raises(tmp_path, spec):
    args = aot_export.parse_args(["--out", str(tmp_path), "--backend", "cpu",
                                  "--birefnet", spec])
    with pytest.raises(DlimgError, match="each entry is kind:bucket"):
        aot_export.export_serving(args)
    assert not (tmp_path / "serving.txt").exists()


@pytest.mark.parametrize("edit", [("birefnet_depths\t2,2,1,1",
                                   "birefnet_depths\t1,2,1,1"),
                                  ("birefnet_decoder_channels\t8,12,4",
                                   "birefnet_decoder_channels\t8,12,5")],
                         ids=["depths", "decoder_channels"])
def test_a_program_refuses_rows_its_weights_do_not_match(served, build,
                                                         tmp_path, edit):
    bundle = tmp_path / "bundle"
    shutil.copytree(served["bundle"], bundle)
    txt = bundle / "serving.txt"
    assert edit[0] in txt.read_text()
    txt.write_text(txt.read_text().replace(*edit))
    r = subprocess.run([str(build.executable("test_serving_programs")), "cpu",
                        str(bundle), PROGRAMS[0]],
                       env=serving_check.fresh_env(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1
    assert "the weights do not match serving.txt's birefnet_embed_dim" \
        in r.stdout
