"""int8 on the port's Python-free serving route, on the CPU: bundles
written by ``aot_export --quantize`` (w8: int8 encoder weights,
dequantised per call), ``--quantize-activations`` (w8a8: the s8 x s8
linears, P2 and P3 around ``_int_mm``) and ``--int8-deform`` (BiRefNet's
deformable convs gather from an int8 corner stack), served by the C
library with DLIMG_PJRT_BUNDLE set.

- MobileSAM at sam_image_size 64 (JAX's seed-0 ``init_sam`` tree from a
  model directory), float32, canvas bucket 256, ``--batch-sizes 4``, in
  w8 and in w8a8: ``test_serving`` in a fresh process with no interpreter
  (points and a box, three masks, ``compute_mask_batch`` through the
  batch program, the small image, the two-thread leg), every mask
  byte-equal and every accuracy bit-equal to the port's Python API under
  the same ``Options``; on the CPU P2 and P3 launch nothing and the
  C++ dispatch takes 40 s8 products a ``process`` in w8a8 (no float
  product of an int8 linear) and 40 dequantised ones in w8.
  ``test_serving_programs`` holds every program against the exporter's
  outputs; ``test_bundle_parse`` reads the int8 rows.
- A slim ViT-B (tests/test_torch_serving_vit.py's hd-64 geometry: depth
  2, the kernel route on) in w8a8, the same way: 8 s8 products a
  ``process``.
- The slim BiRefNet of tests/test_torch_serving_birefnet.py with
  ``--int8-deform``: ``segment_objects`` within 1 quantum of the port's
  under ``birefnet_int8_deform``, its (S, S) program byte-equal.
- Against JAX: JAX's ``Environment(quantize_activations=True)`` on the
  same ``.npz``. The route's bytes are the port's (above); the port's
  activation quanta equal JAX's up to the first linear where any differs,
  and there each difference is a rounding tie (tests/test_torch_quant.py's
  rule); continuing from JAX's quanta, the port's tie flips stay under
  1e-3 of the quanta and its masks equal JAX's except where JAX's logit
  is within 1e-4 of zero.
- The exporter's rows: format 5, JAX's ``quant`` spelling, ``w_q`` /
  ``w_q8`` int8 (in, out) and ``w_scale`` float32, also in a bf16
  bundle (whose programs hold against their outputs too).
- ``dlimg info`` names the bundle's quant modes.
- Refusals: an unknown quant mode, a8 without w8, a format-4 bundle, and a
  quant row that does not match the weights (w8 over float weights, a8
  over ``w_q`` ones, w8 alone over ``w_q8`` ones).

Both sides of a byte comparison run at two CPU threads.
"""

import dataclasses
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

import dlimgedit_tpu as jdl
import dlimgedit_tpu_torch as pdl
from dlimgedit_tpu.models import birefnet as jbn
from dlimgedit_tpu.models import sam as jax_sam
from dlimgedit_tpu.models import vit_sam as jax_vit
from dlimgedit_tpu.ops import quant as jq
from dlimgedit_tpu_torch import native_build
from dlimgedit_tpu_torch.convert.from_numpy import params_from_numpy
from dlimgedit_tpu_torch.models import birefnet as bn
from dlimgedit_tpu_torch.models import sam, vit_sam
from dlimgedit_tpu_torch.ops import quant as pq
from dlimgedit_tpu_torch.runtime import birefnet as prbn
from dlimgedit_tpu_torch.runtime.environment import Environment, SamModelBundle
from dlimgedit_tpu_torch.types import Point, Region
from dlimgedit_tpu_torch.tools import aot_export, serving_check

from _torch_train_util import _nonzero, load, np_tree
from test_torch_native_bridge import IMAGE_SIZE, model_dir  # noqa: F401
from test_torch_quant import MAX_FLIP_SHARE, TIE, _FollowJax, _Recorder
from test_torch_segmentation import _assert_mask_matches, _jax_logits
from test_torch_serving_birefnet import _configs as _birefnet_configs
from test_torch_vit_sam import _jax_tree, _narrow, _randomise

torch.set_num_threads(2)

SIZE = 256  # a 256 x 192 image and a 125 x 93 one: both in bucket 256
POINTS, BOXES = 2, 1
MODES = {"w8": dict(quantize=True), "w8a8": dict(quantize_activations=True)}
QUANT_ROWS = {"w8": "w8", "w8a8": "w8,a8"}
# The quantised linears a MobileSAM `process` runs (10 blocks x 4) and a
# slim ViT's (2 blocks x 4).
MOBILE_SAM_LINEARS, VIT_LINEARS = 40, 8


@pytest.fixture(scope="module")
def build():
    return native_build.build_serving()


@pytest.fixture(scope="module", params=list(MODES))
def served(request, tmp_path_factory, model_dir, build):  # noqa: F811
    """A MobileSAM bundle in one int8 mode, the Python API's results on it
    and test_serving's run in a fresh process."""
    mode = request.param
    work = tmp_path_factory.mktemp(f"int8-{mode}")
    bundle, check = work / "bundle", work / "check"
    env = aot_export.export_serving(serving_check.bundle_args(
        bundle, SIZE, "cpu", IMAGE_SIZE, "float32", str(model_dir),
        batch_sizes="4", **MODES[mode]))
    goldens = serving_check.write_goldens(env, check, SIZE, POINTS, BOXES)
    run = serving_check.run_test_serving(build, bundle, check, work, "cpu")
    return {"mode": mode, "work": work, "bundle": bundle, "check": check,
            "env": env, "goldens": goldens, "stdout": run.stdout}


def _assert_served(out, work, s8: int, dequantised: int) -> None:
    """test_serving's lines of a MobileSAM or ViT bundle: every mask and
    accuracy the Python API's, nothing launched, the int8 dispatch."""
    n = POINTS + BOXES
    (w, h), (sw, sh) = serving_check.image_sizes(SIZE)
    for i in range(n):
        kind = "point" if i < POINTS else "box"
        assert f"{kind} mask {i} vs the Python API: 0/{w * h} pixels differ" \
            in out
    assert (f"compute_masks vs the Python API: 0/{3 * w * h} pixels differ, "
            f"0/3 accuracies differ in bits") in out
    assert (f"compute_mask_batch of {n} vs the Python API: 0/{n * w * h} "
            f"pixels differ, 0/{n} accuracies differ in bits") in out
    assert f"small image ({sw}x{sh}) mask vs the Python API: 0/{sw * sh}" in out
    assert (f"concurrent process of 2 images x 8 rounds vs the Python API: "
            f"0/{2 * 8 * w * h} pixels differ; batches of {n}: 0 pixels and "
            f"accuracies differ") in out
    # On the CPU the plain versions of P2 and P3 run: nothing is launched;
    # the dispatch of each int8 linear is counted, on capture and replay.
    for what in (f"{w}x{h}", f"{sw}x{sh}", f"{w}x{h} (replay)"):
        assert (f"launches per process {what}: K1 0 K2 0 K3 0 K4 0 K5 0 P1 0 "
                f"P2 0 P3 0") in out
        assert (f"int8 linears per process {what}: s8 {s8} dequantised "
                f"{dequantised}") in out
    assert "Py_IsInitialized: 0 (libpython linked, never started)" in out
    assert not (work / serving_check.MARKER).exists()


def test_the_c_host_serves_the_int8_encoder_like_the_python_api(served):
    s8 = MOBILE_SAM_LINEARS if served["mode"] == "w8a8" else 0
    _assert_served(served["stdout"], served["work"], s8,
                   MOBILE_SAM_LINEARS - s8)


def test_every_int8_program_equals_the_exporters_python_outputs(served, build):
    r = serving_check.run_test_programs(build, served["bundle"],
                                        served["work"], "cpu")
    names = serving_check.programs(served["bundle"])
    assert names == sorted(f"serve_{p}_mobile_sam_256" for p in (
        "embed", "decode", "decode3", "decode_batch4"))
    for name in names:
        assert f"{name}: PASS" in r.stdout
    assert f"serving.txt: quant {QUANT_ROWS[served['mode']]}\n" in r.stdout
    assert (f"bundle parse OK: 4 programs" in r.stdout and
            f"{MOBILE_SAM_LINEARS} int8 weight rows" in r.stdout)
    assert "the host's float32 flags after the programs: put back" in r.stdout


def test_the_exporter_writes_format_5_and_jaxs_quant_row(served):
    bundle = served["bundle"]
    rows = dict(ln.split("\t", 1) for ln in
                (bundle / "serving.txt").read_text().splitlines())
    assert rows["format"] == "dlimgedit_tpu_torch-serving-5"
    assert rows["quant"] == QUANT_ROWS[served["mode"]]
    key = "w_q8" if served["mode"] == "w8a8" else "w_q"
    model = served["env"].sam_model("mobile_sam").model
    qkv = model.encoder.stages[1].blocks[0].attn.qkv
    stored = np.load(bundle / "weights"
                     / f"encoder.stages.1.blocks.0.attn.qkv.{key}.npy")
    assert stored.dtype == np.int8 and stored.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(stored, getattr(qkv, key).numpy())
    scale = np.load(bundle / "weights"
                    / "encoder.stages.1.blocks.0.attn.qkv.w_scale.npy")
    assert scale.dtype == np.float32 and scale.shape == (stored.shape[1],)
    spec = (bundle / "serve_embed_mobile_sam_256.spec.txt").read_text()
    assert f"inw int8 {stored.shape[0]},{stored.shape[1]} " \
           f"encoder.stages.1.blocks.0.attn.qkv.{key}\n" in spec
    assert not any(r.endswith(".qkv.w") for r in spec.splitlines())


def test_dlimg_info_reports_the_quant_modes(served, build):
    env = serving_check.fresh_env(served["work"],
                                  DLIMG_PJRT_BUNDLE=str(served["bundle"]))
    r = subprocess.run([str(build.executable("dlimg")), "info"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    encoder = ("int8 weights and activations" if served["mode"] == "w8a8"
               else "int8 weights")
    assert (f"bundle quant: {QUANT_ROWS[served['mode']]} (encoder {encoder}, "
            f"BiRefNet gathers float)") in r.stdout
    assert "backend cpu: supported" in r.stdout
    assert not (served["work"] / serving_check.MARKER).exists()


def test_a_bf16_int8_bundle_keeps_w_scale_float32(tmp_path, model_dir,  # noqa: F811
                                                  build):
    """bf16 as on the card: the scales stay float32 (cast_tree), the
    activations are quantised from bf16, and every program holds against
    the exporter's outputs."""
    bundle = tmp_path / "bundle"
    aot_export.export_serving(aot_export.parse_args([
        "--out", str(bundle), "--backend", "cpu", "--sam-image-size",
        str(IMAGE_SIZE), "--buckets", "256", "--models", str(model_dir),
        "--quantize-activations"]))
    spec = (bundle / "serve_embed_mobile_sam_256.spec.txt").read_text()
    scales = [r for r in spec.splitlines() if r.endswith(".w_scale")]
    assert len(scales) == MOBILE_SAM_LINEARS
    assert all(r.startswith("inw float32 ") for r in scales)
    assert sum(r.startswith("inw int8 ") for r in spec.splitlines()) == \
        MOBILE_SAM_LINEARS
    assert any(r.startswith("inw bfloat16 ") and r.endswith(".qkv.b")
               for r in spec.splitlines())
    r = serving_check.run_test_programs(build, bundle, tmp_path, "cpu")
    for name in ("serve_embed_mobile_sam_256", "serve_decode_mobile_sam_256",
                 "serve_decode3_mobile_sam_256"):
        assert f"{name}: PASS" in r.stdout
    assert "serving.txt: quant w8,a8\n" in r.stdout


def _jax_prompt(p):
    if isinstance(p, Region):
        return jdl.Region(jdl.Point(p.top_left.x, p.top_left.y),
                          jdl.Point(p.bottom_right.x, p.bottom_right.y))
    return jdl.Point(p.x, p.y)


class _Own:
    """The port's P2 wrapper, patched to record its own quanta (the
    route's, whose masks test_serving holds to the port's bytes)."""

    def __init__(self):
        self.calls = []
        self._orig = pq.quantize_rows_int8

    def __call__(self, x):
        q, s = self._orig(x)
        self.calls.append(q.numpy().copy())
        return q, s


def test_the_route_matches_jax_up_to_tie_flips(served, model_dir,  # noqa: F811
                                               monkeypatch):
    """w8 has no activation quanta: the served masks are JAX's but where
    its logit is within 1e-4 of zero. w8a8 by test_torch_quant.py's rule
    (the module docstring)."""
    g, env = served["goldens"], served["env"]
    (w, h), _ = serving_check.image_sizes(SIZE)
    px = np.frombuffer((served["check"] / "image.raw").read_bytes(),
                       np.uint8).reshape(h, w, 4)
    je = jdl.Environment(jdl.Options(
        backend=jdl.Backend.cpu, model_directory=str(model_dir),
        sam_image_size=IMAGE_SIZE, compute_dtype="float32",
        quantize_encoder=True,
        quantize_activations=served["mode"] == "w8a8"))
    if served["mode"] == "w8":
        js = jdl.Segmentation.process(
            jdl.Image(jdl.Extent(w, h), jdl.Channels.rgba, px), je)
        for p, mine in zip(g["prompts"], g["masks"]):
            jp = _jax_prompt(p)
            _assert_mask_matches(
                mine.reshape(h, w, 1),
                np.asarray(js.compute_mask(jp).pixels).reshape(h, w, 1),
                lambda jp=jp: _jax_logits(je, js, jp)[0])
        return
    recorder = _Recorder()
    monkeypatch.setattr(jq, "quantize_activations_int8", recorder)
    js = jdl.Segmentation.process(
        jdl.Image(jdl.Extent(w, h), jdl.Channels.rgba, px), je)
    jax.effects_barrier()
    monkeypatch.undo()
    assert len(recorder.calls) == MOBILE_SAM_LINEARS
    img = pdl.Image(pdl.Extent(w, h), pdl.Channels.rgba, px.copy())
    # The route's quanta (the port's own) equal JAX's up to the first
    # linear where any differs, and there only at rounding ties.
    own = _Own()
    monkeypatch.setattr(pq, "quantize_rows_int8", own)
    seg = pdl.Segmentation.process(img, env)
    monkeypatch.undo()
    for p, want in zip(g["prompts"], g["masks"]):
        np.testing.assert_array_equal(seg.compute_mask(p).pixels.reshape(h, w),
                                      want)
    first = next((i for i, (q, (_, jq_x, _)) in enumerate(
        zip(own.calls, recorder.calls)) if (q != jq_x.reshape(q.shape)).any()),
        None)
    if first is not None:
        jx, jq_x, jsc = recorder.calls[first]
        q = own.calls[first]
        diff = q != jq_x.reshape(q.shape)
        t = (jx.reshape(q.shape) / jsc.reshape(-1, 1))[diff]
        assert np.abs(np.abs(t - np.floor(t)) - 0.5).max() <= TIE
        assert np.abs(q[diff].astype(int)
                      - jq_x.reshape(q.shape)[diff]).max() == 1
    # Continuing from JAX's quanta, the flips are rare ties and the masks
    # are JAX's but where its logit is within 1e-4 of zero.
    follow = _FollowJax(recorder.calls)
    monkeypatch.setattr(pq, "quantize_rows_int8", follow)
    ps = pdl.Segmentation.process(img, env)
    monkeypatch.undo()
    assert follow.calls == MOBILE_SAM_LINEARS
    assert follow.flips <= MAX_FLIP_SHARE * follow.quanta
    for p in g["prompts"]:
        jp = _jax_prompt(p)
        _assert_mask_matches(
            ps.compute_mask(p).pixels.reshape(h, w, 1),
            np.asarray(js.compute_mask(jp).pixels).reshape(h, w, 1),
            lambda jp=jp: _jax_logits(je, js, jp)[0])


def _vit_env(embed: int = 128, image_size: int = 256) -> Environment:
    """The port's Environment holding a slim vit_b bundle in w8a8, its
    encoder's kernel route on (JAX's seed-1 tree, nonzero rel-pos tables,
    pos_embed and qkv bias, as tests/test_torch_serving_vit.py builds)."""
    enc = dataclasses.replace(_narrow(vit_sam, embed, image_size),
                              use_flash_attention=True)
    cfg = dataclasses.replace(sam.make_config("vit_b", image_size),
                              encoder_vit=enc)
    jcfg = dataclasses.replace(jax_sam.make_config("vit_b", image_size),
                               encoder_vit=_narrow(jax_vit, embed, image_size))
    tree = _jax_tree(jcfg, seed=1)
    _randomise(tree["encoder"], 13)
    model = sam.Sam(cfg)
    model.load_state_dict(params_from_numpy(tree), strict=True)
    pe = pdl.Environment(pdl.Options(
        backend=pdl.Backend.cpu, allow_random_weights=True,
        compute_dtype="float32", sam_variant="vit_b",
        sam_image_size=image_size, model_directory="no-such-directory",
        quantize_encoder=True, quantize_activations=True))
    pb = SamModelBundle(cfg, model, torch.float32, quantize_activations=True)
    assert pe._sam_models["vit_b"].get_or_create(lambda: pb) is pb
    return pe


def test_a_slim_vit_serves_w8a8_like_the_python_api(tmp_path, build):
    pe = _vit_env()
    bundle, check = tmp_path / "bundle", tmp_path / "check"
    aot_export.export_serving(serving_check.bundle_args(
        bundle, SIZE, "cpu", 256, "float32", variant="vit_b", batch_sizes="4",
        quantize_activations=True), env=pe)
    serving_check.write_goldens(pe, check, SIZE, POINTS, BOXES)
    run = serving_check.run_test_serving(build, bundle, check, tmp_path, "cpu")
    _assert_served(run.stdout, tmp_path, VIT_LINEARS, 0)
    r = serving_check.run_test_programs(build, bundle, tmp_path, "cpu")
    for name in serving_check.programs(bundle):
        assert f"{name}: PASS" in r.stdout
    assert "serving.txt: quant w8,a8\n" in r.stdout
    assert f"{VIT_LINEARS} int8 weight rows" in r.stdout


def test_a_slim_birefnet_serves_int8_deform_within_one_quantum(
        tmp_path, model_dir, build):  # noqa: F811
    jcfg, cfg = _birefnet_configs()
    cfg = dataclasses.replace(cfg, deform_int8_gather=True)
    tree = _nonzero(np_tree(jbn.init_birefnet(jax.random.PRNGKey(0), jcfg)),
                    seed=3)
    model = load(bn.BiRefNet(cfg), tree)
    args = serving_check.bundle_args(
        tmp_path / "bundle", SIZE, "cpu", IMAGE_SIZE, "float32",
        str(model_dir), birefnet="general:256", int8_deform=True)
    pe = aot_export.make_environment(args)
    pb = prbn.BiRefNetBundle(cfg, model, torch.float32, cfg.img_size)
    assert pe._birefnet_models["general"].get_or_create(lambda: pb) is pb
    aot_export.export_serving(args, env=pe)
    assert "quant\tdeform8\n" in (tmp_path / "bundle" / "serving.txt"
                                  ).read_text()
    check = tmp_path / "check"
    serving_check.write_goldens(pe, check, SIZE, 1, 0)
    images = serving_check.write_birefnet_goldens(pe, check, SIZE, [256])
    run = serving_check.run_test_serving(build, tmp_path / "bundle", check,
                                         tmp_path, "cpu")
    (w, h), = [m.shape[::-1] for _, m in images]
    line = next(ln for ln in run.stdout.splitlines() if ln.startswith(
        f"segment_objects {w}x{h} (general) vs the Python API"))
    assert int(line.rsplit(" ", 1)[1]) <= 1, line
    assert (f"launches per segment_objects {w}x{h}: K1 0 K2 0 K3 0 K4 0 K5 0 "
            f"P1 0 P2 0 P3 0") in run.stdout
    r = serving_check.run_test_programs(build, tmp_path / "bundle", tmp_path,
                                        "cpu")
    assert "serve_birefnet_general_256: PASS" in r.stdout
    assert "serving.txt: quant deform8\n" in r.stdout
    # The served program gathers from the int8 stack: the float gathers
    # give other bytes on the same sample.
    float_model = load(bn.BiRefNet(dataclasses.replace(
        cfg, deform_int8_gather=False)), tree)
    canvas = torch.from_numpy(np.load(tmp_path / "bundle" /
                                      "serve_birefnet_general_256.in0.npy"))
    sizes = torch.from_numpy(np.load(tmp_path / "bundle" /
                                     "serve_birefnet_general_256.in1.npy"))
    fb = prbn.BiRefNetBundle(dataclasses.replace(cfg, deform_int8_gather=False),
                             float_model, torch.float32, cfg.img_size)
    with torch.inference_mode():
        plain = prbn._build_birefnet_fn(fb, 256)(canvas, sizes)
    served = np.load(tmp_path / "bundle" / "serve_birefnet_general_256.out0.npy")
    assert not np.array_equal(plain.numpy(), served)


def _refused(build, bundle, tmp_path, why):
    p = subprocess.run([str(build.executable("test_bundle_parse")),
                        str(bundle)], capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 1 and why in p.stderr, p.stderr
    r = subprocess.run([str(build.executable("test_serving_programs")), "cpu",
                        str(bundle), "serve_embed_mobile_sam_256"],
                       env=serving_check.fresh_env(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1 and why in r.stdout + r.stderr, r.stdout[-2000:]


# Each refusal on each mode's bundle: the quant row edited to (the row,
# the words of the refusal); "mismatch" swaps the modes' rows (a8 over w_q
# weights, w8 alone over w_q8 ones).
N = MOBILE_SAM_LINEARS
_EDITS = {
    "unknown_mode": {m: (f"{r},w4", "quant row names an unknown mode 'w4'")
                     for m, r in QUANT_ROWS.items()},
    "a8_without_w8": {m: ("a8", "quant row names a8 without w8")
                      for m in QUANT_ROWS},
    "mismatch": {"w8": ("w8,a8", "serving.txt's quant row (w8,a8) does not "
                        f"match the weights: 0 w_q8, {N} w_q"),
                 "w8a8": ("w8", "serving.txt's quant row (w8) does not match "
                          f"the weights: {N} w_q8, 0 w_q")},
}


@pytest.mark.parametrize("edit", ["unknown_mode", "a8_without_w8", "format_4",
                                  "mismatch", "w8_over_float"])
def test_the_reader_refuses_what_the_route_cannot_serve(served, build,
                                                        tmp_path, edit):
    bundle = tmp_path / "bundle"
    shutil.copytree(served["bundle"], bundle)
    txt = bundle / "serving.txt"
    text = txt.read_text()
    row = f"quant\t{QUANT_ROWS[served['mode']]}\n"
    assert row in text
    if edit in _EDITS:
        new, why = _EDITS[edit][served["mode"]]
        text = text.replace(row, f"quant\t{new}\n")
    elif edit == "format_4":
        text = text.replace("serving-5", "serving-4")
        why = ("names the bundle format 'dlimgedit_tpu_torch-serving-4', not "
               "the port's dlimgedit_tpu_torch-serving-5 (an older export is "
               "not read)")
    else:  # a float bundle's weights under the mode's row
        float_bundle = served["work"].parent / "float-bundle"
        if not float_bundle.exists():
            aot_export.export_serving(aot_export.parse_args([
                "--out", str(float_bundle), "--backend", "cpu",
                "--sam-image-size", str(IMAGE_SIZE), "--buckets", "256",
                "--compute-dtype", "float32"]))
        shutil.rmtree(bundle)
        shutil.copytree(float_bundle, bundle)
        text = txt.read_text() + row
        why = (f"serving.txt's quant row ({QUANT_ROWS[served['mode']]}) does "
               f"not match the weights: 0 w_q8, 0 w_q and {N} float weights")
    txt.write_text(text)
    _refused(build, bundle, tmp_path, why)
