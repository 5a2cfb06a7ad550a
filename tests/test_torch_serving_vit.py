"""The port's Python-free serving route with a SAM ViT encoder, on the CPU.

Narrow ``vit_b`` bundles (depth 2: one windowed block of 14 and one global
block; 2 heads), built as tests/test_torch_vit_sam.py builds its injected
bundles: JAX's seed-1 ``init_sam`` tree with nonzero rel-pos tables,
``pos_embed`` and qkv bias, loaded into both packages, float32.

- Geometries: embed 128 at image size 256 (hd 64; the windows take K5's
  route with the pad-query skip, the 16-grid pads to 28) and embed 160 at
  384 (hd 80; the global block's 576 tokens take K4's route).
- Each with the encoder's kernel route on (``use_flash_attention``: the
  C++ wrappers of K1 / K3 / K4 / K5, whose CPU branches are the kernels'
  plain versions) and off (the dense path), and with ``--batch-sizes 2,4``.
- The bundle is exported through ``export_serving(args, env=...)`` and
  served by ``test_serving`` in a fresh process with no interpreter (no
  marker, ``Py_IsInitialized`` 0): point and box masks, three masks,
  ``compute_mask_batch`` of 3 prompts (one program of 4, a padded slot)
  and of 5 (4, then 2), and the two-thread leg with batches, every mask
  byte-equal and every accuracy bit-equal to the port's Python API; no
  kernel launches on the CPU.
- The same masks hold against the JAX package's Python API by the North
  star's tie rule (a flipped pixel only where JAX's logit is within 1e-4
  of zero, accuracies within 1e-4), JAX's Pallas kernels in interpret mode
  where the route is on.
- ``test_serving_programs`` holds every program, the batch programs
  included, against the exporter's outputs; ``test_bundle_parse`` reads
  the ViT's rows of serving.txt.

Both sides of a byte comparison run at two CPU threads (the C++ process
at this process's count). A fresh C++ process used to differ at two
threads now and then (ROADMAP C6: the process's first call of MKL's
vector math, the prompt encoder's sine, took another path on the worker
thread); the serving backend now makes that call itself, and
``test_a_fresh_cpp_process_repeats_the_python_bytes_at_two_threads``
holds 24 fresh processes to the exporter's bytes.
"""

import dataclasses
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlimgedit_tpu as jdl
import dlimgedit_tpu_torch as pdl
from dlimgedit_tpu.models import sam as jax_sam
from dlimgedit_tpu.models import vit_sam as jax_vit
from dlimgedit_tpu.runtime.environment import SamModelBundle as JaxBundle
from dlimgedit_tpu_torch import native_build
from dlimgedit_tpu_torch.convert.from_numpy import params_from_numpy
from dlimgedit_tpu_torch.models import sam, vit_sam
from dlimgedit_tpu_torch.runtime.environment import SamModelBundle
from dlimgedit_tpu_torch.tools import aot_export, serving_check
from dlimgedit_tpu_torch.types import Point, Region

from test_torch_vit_sam import (
    _assert_mask_matches,
    _jax_logits,
    _jax_tree,
    _narrow,
    _randomise,
)

torch.set_num_threads(2)

SIZE = 256  # a 256 x 192 image and a 125 x 93 one: both in bucket 256
POINTS, BOXES = 3, 2
BATCH_SIZES = "2,4"
NEAR_ZERO = 1e-4
# geometry -> (embed width, image size)
GEOMETRIES = {"hd64_img256": (128, 256), "hd80_img384": (160, 384)}
CASES = [(g, r) for g in GEOMETRIES for r in ("route_on", "route_off")]
# Fresh C++ processes held to the exporter's bytes at two threads: at the
# parent of the C6 repair about one in ten differed (ROADMAP C6).
REPEATS = 24


def _opts(mod, image_size: int):
    return mod.Options(backend=mod.Backend.cpu, allow_random_weights=True,
                       compute_dtype="float32", sam_variant="vit_b",
                       sam_image_size=image_size,
                       model_directory="no-such-directory")


def injected_envs(geometry: str, route: bool):
    """JAX and port Environments holding one narrow vit_b bundle, its
    encoder's kernel route on or off."""
    embed, image_size = GEOMETRIES[geometry]
    jenc = dataclasses.replace(_narrow(jax_vit, embed, image_size),
                               use_flash_attention=route,
                               flash_interpret=route)
    penc = dataclasses.replace(_narrow(vit_sam, embed, image_size),
                               use_flash_attention=route)
    jcfg = dataclasses.replace(jax_sam.make_config("vit_b", image_size),
                               encoder_vit=jenc)
    tree = _jax_tree(jcfg, seed=1)
    _randomise(tree["encoder"], 13)
    je = jdl.Environment(_opts(jdl, image_size))
    jb = JaxBundle(jcfg, jax.tree_util.tree_map(jnp.asarray, tree), je.device,
                   jnp.float32)
    assert je._sam_models["vit_b"].get_or_create(lambda: jb) is jb
    cfg = dataclasses.replace(sam.make_config("vit_b", image_size),
                              encoder_vit=penc)
    model = sam.Sam(cfg)
    model.load_state_dict(params_from_numpy(tree), strict=True)
    pe = pdl.Environment(_opts(pdl, image_size))
    pb = SamModelBundle(cfg, model, torch.float32)
    assert pe._sam_models["vit_b"].get_or_create(lambda: pb) is pb
    return je, pe


@pytest.fixture(scope="module")
def build():
    return native_build.build_serving()


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def served(request, tmp_path_factory, build):
    """A bundle, the Python API's results on it, and test_serving's run in
    a fresh process."""
    geometry, route = request.param
    je, pe = injected_envs(geometry, route == "route_on")
    work = tmp_path_factory.mktemp(f"vit-{geometry}-{route}")
    bundle, check = work / "bundle", work / "check"
    image_size = GEOMETRIES[geometry][1]
    aot_export.export_serving(serving_check.bundle_args(
        bundle, SIZE, "cpu", image_size, "float32", variant="vit_b",
        batch_sizes=BATCH_SIZES), env=pe)
    goldens = serving_check.write_goldens(pe, check, SIZE, POINTS, BOXES)
    run = serving_check.run_test_serving(build, bundle, check, work, "cpu")
    return {"work": work, "bundle": bundle, "check": check, "je": je,
            "goldens": goldens, "stdout": run.stdout, "route": route,
            "geometry": geometry}


def _jax_prompt(p):
    if isinstance(p, Region):
        return jdl.Region(jdl.Point(p.top_left.x, p.top_left.y),
                          jdl.Point(p.bottom_right.x, p.bottom_right.y))
    return jdl.Point(p.x, p.y)


def test_a_c_host_serves_the_vit_like_the_python_api(served):
    out = served["stdout"]
    n = POINTS + BOXES
    (w, h), (sw, sh) = serving_check.image_sizes(SIZE)
    for i in range(n):
        kind = "point" if i < POINTS else "box"
        assert f"{kind} mask {i} vs the Python API: 0/{w * h} pixels differ" \
            in out
    assert (f"compute_masks vs the Python API: 0/{3 * w * h} pixels differ, "
            f"0/3 accuracies differ in bits") in out
    for k in (3, n):
        assert (f"compute_mask_batch of {k} vs the Python API: 0/{k * w * h} "
                f"pixels differ, 0/{k} accuracies differ in bits") in out
    assert f"small image ({sw}x{sh}) mask vs the Python API: 0/{sw * sh}" in out
    assert (f"concurrent process of 2 images x 8 rounds vs the Python API: "
            f"0/{2 * 8 * w * h} pixels differ; batches of {n}: 0 pixels and "
            f"accuracies differ") in out
    # The CPU takes the kernels' plain versions: nothing is launched.
    assert f"launches per process {w}x{h}: K1 0 K2 0 K3 0 K4 0 K5 0" in out
    assert "Py_IsInitialized: 0 (libpython linked, never started)" in out
    assert not (served["work"] / serving_check.MARKER).exists()


def test_the_served_vit_masks_hold_against_jax_by_the_tie_rule(served):
    g, je = served["goldens"], served["je"]
    (w, h), (sw, sh) = serving_check.image_sizes(SIZE)
    px = np.frombuffer((served["check"] / "image.raw").read_bytes(),
                       np.uint8).reshape(h, w, 4)
    js = jdl.Segmentation.process(
        jdl.Image(jdl.Extent(w, h), jdl.Channels.rgba, px), je)
    jbatch = js.compute_mask_batch([_jax_prompt(p) for p in g["prompts"]])
    for i, p in enumerate(g["prompts"]):
        jp = _jax_prompt(p)
        want = np.asarray(js.compute_mask(jp).pixels).reshape(h, w, 1)
        _assert_mask_matches(g["masks"][i].reshape(h, w, 1), want,
                             lambda jp=jp: _jax_logits(je, js, jp)[0])
        assert abs(g["batch"][i].accuracy - jbatch[i].accuracy) <= NEAR_ZERO
    first = next(p for p in g["prompts"] if isinstance(p, Point))
    jthree = js.compute_masks(_jax_prompt(first))
    for t, (mine, theirs) in enumerate(zip(g["three"], jthree)):
        _assert_mask_matches(
            mine.image.pixels.reshape(h, w, 1),
            np.asarray(theirs.image.pixels).reshape(h, w, 1),
            lambda t=t: _jax_logits(je, js, _jax_prompt(first),
                                    multimask=True)[t])
        assert abs(mine.accuracy - theirs.accuracy) <= NEAR_ZERO
    spx = np.frombuffer((served["check"] / "image_small.raw").read_bytes(),
                        np.uint8).reshape(sh, sw, 3)
    jss = jdl.Segmentation.process(
        jdl.Image(jdl.Extent(sw, sh), jdl.Channels.rgb, spx), je)
    sp = _jax_prompt(g["small_point"])
    _assert_mask_matches(
        g["small"].reshape(sh, sw, 1),
        np.asarray(jss.compute_mask(sp).pixels).reshape(sh, sw, 1),
        lambda: _jax_logits(je, jss, sp)[0])


def test_every_vit_program_equals_the_exporters_python_outputs(served, build):
    r = serving_check.run_test_programs(build, served["bundle"],
                                        served["work"], "cpu")
    names = serving_check.programs(served["bundle"])
    assert names == sorted(
        [f"serve_{p}_vit_b_256" for p in ("embed", "decode", "decode3")]
        + [f"serve_decode_batch{n}_vit_b_256" for n in (2, 4)])
    for name in names:
        assert f"{name}: PASS" in r.stdout
    assert (f"programs byte-equal to the exporter's outputs: {len(names)} of "
            f"{len(names)} given, the bundle has {len(names)}") in r.stdout
    assert f"bundle parse OK: {len(names)} programs" in r.stdout
    embed, image_size = GEOMETRIES[served["geometry"]]
    assert (f"serving.txt: variant vit_b, encoder vit, kernel route "
            f"{served['route'][len('route_'):]}, batch sizes [2,4], "
            f"num_heads 2, window_size 14, global_attn_indexes [1], "
            f"patch_size 16, layer_norm_eps 1e-06") in r.stdout
    # The rel-pos gather index of each block is a weight of the bundle,
    # stored once.
    weights = {p.name for p in (served["bundle"] / "weights").iterdir()}
    assert {"encoder.blocks.0.rel_pos_idx.npy",
            "encoder.blocks.1.rel_pos_idx.npy"} <= weights
    txt = (served["bundle"] / "serving.txt").read_text()
    assert f"image_size\t{image_size}\n" in txt


def test_the_cpp_takes_the_route_serving_txt_names(tmp_path, build):
    """At hd 80 the kernel route (the bias folded by a scale that is no
    power of two) and the dense path round differently: the two routes'
    embeddings differ in bits, within float32's summation-order tolerance.
    The C++ reads the route from serving.txt: the kernel route's bundle
    with its route rows set to 0 no longer gives its embedding. (At hd 64,
    scale 1/8, the two routes agree to the bit.)"""
    image_size = GEOMETRIES["hd80_img384"][1]
    outs = {}
    for route in (True, False):
        _, pe = injected_envs("hd80_img384", route)
        out = tmp_path / f"route_{int(route)}"
        aot_export.export_serving(serving_check.bundle_args(
            out, SIZE, "cpu", image_size, "float32", variant="vit_b"),
            env=pe)
        outs[route] = np.load(out / "serve_embed_vit_b_256.out0.npy")
    on, off = outs[True], outs[False]
    assert on.shape == off.shape and (on != off).any()
    np.testing.assert_allclose(on, off, atol=1e-4, rtol=1e-4)
    embed = "serve_embed_vit_b_256"
    bundle = tmp_path / "route_1"
    r = subprocess.run([str(build.executable("test_serving_programs")),
                        "cpu", str(bundle), embed],
                       env=serving_check.fresh_env(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and f"{embed}: PASS" in r.stdout, r.stdout
    txt = bundle / "serving.txt"
    txt.write_text(txt.read_text().replace("kernel_route\t1",
                                           "kernel_route\t0"))
    r = subprocess.run([str(build.executable("test_serving_programs")),
                        "cpu", str(bundle), embed],
                       env=serving_check.fresh_env(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1 and f"{embed}: FAIL" in r.stdout, r.stdout


def test_dlimg_info_reports_the_vit_bundle(served, build):
    env = serving_check.fresh_env(served["work"],
                                  DLIMG_PJRT_BUNDLE=str(served["bundle"]))
    r = subprocess.run([str(build.executable("dlimg")), "info"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    route = served["route"][len("route_"):]
    assert f"bundle variant: vit_b (encoder vit, kernel route {route})" \
        in r.stdout
    assert "bundle batch sizes: 2,4" in r.stdout
    assert not (served["work"] / serving_check.MARKER).exists()


@pytest.mark.parametrize("served", [CASES[0]], indirect=True,
                         ids=["-".join(CASES[0])])
def test_a_fresh_cpp_process_repeats_the_python_bytes_at_two_threads(
        served, build):
    """ROADMAP C6: in a fresh process the first decode program (its
    dense positional encoding's sine is the process's first call of MKL's
    vector math) must give the exporter's bytes every time, at two
    threads. Each run starts a new process and runs serve_decode3 first."""
    name = "serve_decode3_vit_b_256"
    differing = []
    for run in range(REPEATS):
        r = subprocess.run([str(build.executable("test_serving_programs")),
                            "cpu", str(served["bundle"]), name],
                           env=serving_check.fresh_env(served["work"]),
                           capture_output=True, text=True, timeout=300)
        assert r.returncode in (0, 1), r.stderr
        if r.returncode or f"{name} out1: 0/12 bytes differ" not in r.stdout:
            differing.append(run)
    assert torch.get_num_threads() == 2
    assert not differing, f"runs {differing} of {REPEATS} differ"
