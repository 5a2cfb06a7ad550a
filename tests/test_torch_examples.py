"""The port's examples (dlimgedit_tpu_torch/examples/) EXECUTED on the CPU and
held against the JAX package's (examples/, run as tests/test_examples.py
runs them), in float32 at sizes 64 / 128 / 144.

  * every ``dlimgedit_tpu_torch`` name an example imports exists;
  * interactive_segmentation, generate_masks and foreground_extraction run
    in both packages on ONE weight bundle (JAX's seed-0 ``init_sam`` tree at
    64, written to a model directory as tests/test_torch_native_bridge.py
    writes it; JAX's slim BiRefNet tree with nonzero offsets as both
    environments' ``general`` model) and the same seeded PNG: mask files
    equal byte for byte, a flipped pixel allowed only where JAX's logit is
    within 1e-4 of zero; printed accuracies within 1e-4; the cutout's RGB
    equal and its alpha within 1 quantum. generate_masks also runs with
    the IoU and stability filters off in both packages (random weights
    pass neither), so that masks are written and held;
  * latency_scaleout and distill_encoder get tests/test_examples.py's tiny
    configurations and JAX's trees, carried across: the sp embedding
    within atol 2e-5 (tests/test_torch_sp.py), the spatial logits within
    atol 5e-5 / rtol 1e-5 (tests/test_torch_spatial.py), the teacher's
    embeddings within atol 2e-5 / rtol 1e-4 (tests/test_torch_distill.py)
    of the JAX example's;
  * streaming_frames, finetune_decoder (and its resume) and
    multihost_train on explicit CPU device lists, with the JAX test's
    printed strings; the fine-tune's exported .npz served by JAX's
    Environment and the port's, masks held as above; multihost_train also
    as two processes joined by a gloo group (each rank prints the same
    losses);
  * without a CUDA device the examples' defaults raise: nothing falls
    back to the CPU.
"""

import ast
import importlib
import importlib.util
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlimgedit_tpu as jdl
import dlimgedit_tpu_torch as pdl
from dlimgedit_tpu.models import sam as jsam
from dlimgedit_tpu.models import vit_sam as jvit
from dlimgedit_tpu.runtime import birefnet as jrbn
from dlimgedit_tpu.utils.pytree_io import save_pytree
from dlimgedit_tpu_torch.models import sam as psam
from dlimgedit_tpu_torch.models import vit_sam as pvit
from dlimgedit_tpu_torch.runtime import birefnet as prbn

from _torch_train_util import load, slim_birefnet
from test_torch_amg import _jax_winner_logits
from test_torch_segmentation import _jax_logits

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
JAX_EXAMPLES = ROOT / "examples"
PORT_EXAMPLES = sorted(p for p in (ROOT / "dlimgedit_tpu_torch" / "examples")
                       .glob("*.py") if p.name != "__init__.py")
CPU = torch.device("cpu")
IMAGE_SIZE = 64
H, W = 48, 72
NEAR_ZERO = 1e-4
AMG_OFF = dict(iou_thresh=0.0, stability_thresh=0.0)


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", JAX_EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_example(name):
    return importlib.import_module(f"dlimgedit_tpu_torch.examples.{name}")


def test_every_example_is_ported():
    assert [p.name for p in PORT_EXAMPLES] == sorted(
        p.name for p in JAX_EXAMPLES.glob("*.py"))


@pytest.mark.parametrize("path", PORT_EXAMPLES, ids=lambda p: p.name)
def test_example_imports_resolve(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module.startswith("dlimgedit_tpu")):
            assert node.module.startswith("dlimgedit_tpu_torch"), node.module
            mod = importlib.import_module(node.module)
            for alias in node.names:
                assert hasattr(mod, alias.name), (
                    f"{path.name}: {node.module}.{alias.name} no longer exists")
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.startswith("dlimgedit_tpu"):
                    assert alias.name.startswith("dlimgedit_tpu_torch")
                    importlib.import_module(alias.name)


# --------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    (d / "segmentation").mkdir()
    params = jsam.init_sam(jax.random.PRNGKey(0),
                           jsam.make_config("mobile_sam", IMAGE_SIZE))
    save_pytree(d / "segmentation" / "mobile_sam.npz",
                jax.tree_util.tree_map(np.asarray, params))
    return d


@pytest.fixture(scope="module")
def png(tmp_path_factory):
    rng = np.random.default_rng(7)
    p = tmp_path_factory.mktemp("img") / "in.png"
    pdl.Image.save(pdl.Image(pdl.Extent(W, H), pdl.Channels.rgba,
                             rng.integers(0, 256, (H, W, 4), dtype=np.uint8)), p)
    return p


def _options(mod, model_dir):
    return mod.Options(backend=mod.Backend.cpu, allow_random_weights=True,
                       compute_dtype="float32", sam_image_size=IMAGE_SIZE,
                       model_directory=str(model_dir))


@pytest.fixture(scope="module")
def jax_seg(model_dir, png):
    """A JAX environment and segmentation of the PNG, for JAX's logits."""
    je = jdl.Environment(_options(jdl, model_dir))
    return je, jdl.Segmentation.process(jdl.Image.load(png), je)


@pytest.fixture
def shared_birefnet(monkeypatch):
    """JAX's slim seed-0 BiRefNet tree (nonzero offsets) as the ``general``
    model of every environment of both packages."""
    jcfg, jparams, cfg, model = slim_birefnet()
    jtree = jax.tree_util.tree_map(jnp.asarray, jparams)
    monkeypatch.setattr(jrbn, "load_birefnet", lambda env, kind: (
        jrbn.BiRefNetBundle(jcfg, jtree, env.put_target, jnp.float32, 64)))
    monkeypatch.setattr(
        "dlimgedit_tpu_torch.runtime.environment.load_birefnet",
        lambda env, kind: prbn.BiRefNetBundle(cfg, model, torch.float32, 64))


def _assert_png_matches(got: Path, want: Path, logits_fn):
    if got.read_bytes() == want.read_bytes():
        return
    g, w = pdl.Image.load(got).pixels, pdl.Image.load(want).pixels
    assert g.shape == w.shape and g.dtype == np.uint8
    flips = g.reshape(w.shape[:2]) != w.reshape(w.shape[:2])
    near = np.abs(logits_fn()[flips]) <= NEAR_ZERO
    assert near.all(), (
        f"{got.name}: {int(flips.sum())} pixels flipped, {int((~near).sum())} "
        f"of them where JAX's logit is not within {NEAR_ZERO} of zero")


def _floats(pattern, text):
    return [float(v) for v in re.findall(pattern, text)]


def test_interactive_segmentation_matches_jax(tmp_path, capsys, model_dir,
                                              png, jax_seg):
    out = {}
    for name, mod, dl in (("jax", _jax_example, jdl), ("port", _port_example,
                                                       pdl)):
        out[name] = tmp_path / f"{name}.png"
        mod("interactive_segmentation").main(
            argv=[str(png), "30", "20", str(out[name])],
            options=_options(dl, model_dir))
        out[name + "_text"] = capsys.readouterr().out
    je, js = jax_seg
    _assert_png_matches(out["port"], out["jax"], lambda: _jax_logits(
        je, js, jdl.Point(30, 20))[0])
    text, jtext = out["port_text"], out["jax_text"]
    assert f"({W}x{H})" in text and "batched 3 prompts" in text
    got = _floats(r"candidate \d: predicted IoU (\S+)", text)
    want = _floats(r"candidate \d: predicted IoU (\S+)", jtext)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("filters", ["script", "off"])
def test_generate_masks_matches_jax(tmp_path, capsys, model_dir, png, jax_seg,
                                    monkeypatch, filters):
    """grid 4, 4 masks (tests/test_examples.py's call); "off" runs both
    packages' generate_masks with the IoU and stability filters off."""
    if filters == "off":
        for seg_cls in (jdl.Segmentation, pdl.Segmentation):
            real = seg_cls.generate_masks
            monkeypatch.setattr(seg_cls, "generate_masks",
                                lambda self, real=real, **kw: real(
                                    self, **kw, **AMG_OFF))
    dirs, texts = {}, {}
    for name, mod, dl in (("jax", _jax_example, jdl), ("port", _port_example,
                                                       pdl)):
        dirs[name] = tmp_path / name
        mod("generate_masks").main(argv=[str(png), str(dirs[name])],
                                   options=_options(dl, model_dir),
                                   grid=4, max_masks=4)
        texts[name] = capsys.readouterr().out
    files = {k: sorted(d.glob("mask_*.png")) for k, d in dirs.items()}
    n = len(files["jax"])
    assert [f.name for f in files["port"]] == [f.name for f in files["jax"]]
    assert f"generated {n} masks" in texts["port"]
    if filters == "off":
        assert n >= 1
    got = _floats(r"best predicted IoU (\S+)\)", texts["port"])
    want = _floats(r"best predicted IoU (\S+)\)", texts["jax"])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if not n:
        return
    je, js = jax_seg
    accuracies = [m.accuracy for m in js.generate_masks(grid=4, max_masks=4)]
    logits = []
    for i, (g, w) in enumerate(zip(files["port"], files["jax"])):
        def winner(i=i):
            if not logits:
                logits.append(_jax_winner_logits(je, js, 4, accuracies))
            return logits[0][i]
        _assert_png_matches(g, w, winner)


def test_foreground_extraction_matches_jax(tmp_path, model_dir, png,
                                           shared_birefnet):
    out = {}
    for name, mod, dl in (("jax", _jax_example, jdl), ("port", _port_example,
                                                       pdl)):
        out[name] = tmp_path / f"{name}.png"
        mod("foreground_extraction").main(argv=[str(png), str(out[name])],
                                          options=_options(dl, model_dir))
    got, want = (pdl.Image.load(out[k]) for k in ("port", "jax"))
    assert got.channels == pdl.Channels.rgba
    assert (got.extent.width, got.extent.height) == (W, H)
    g, w = got.pixels.astype(np.int32), want.pixels.astype(np.int32)
    np.testing.assert_array_equal(g[..., :3], w[..., :3])
    assert np.abs(g[..., 3] - w[..., 3]).max() <= 1
    assert len(np.unique(g[..., 3])) > 2  # a grey-level mask, not a constant


def test_serving_examples_raise_without_a_gpu(tmp_path, png, monkeypatch):
    """Run as scripts (no options) with a ./models directory: the GPU
    backend raises."""
    (tmp_path / "models").mkdir()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("interactive_segmentation", "generate_masks",
                 "foreground_extraction"):
        argv = [str(png), "1", "1", str(tmp_path / "m.png")]
        with pytest.raises(pdl.DlimgError, match="no CUDA device"):
            _port_example(name).main(
                argv=argv if name == "interactive_segmentation"
                else argv[:1] + argv[3:])


@pytest.mark.parametrize("name,kw", [
    ("streaming_frames", {}), ("latency_scaleout", {}),
    ("distill_encoder", {}), ("finetune_decoder", {"argv": ["ckpts"]}),
    ("multihost_train", {"argv": ["ckpts"]})])
def test_mesh_examples_raise_without_a_gpu(name, kw, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((ValueError, pdl.DlimgError),
                       match="devices visible|no CUDA device"):
        _port_example(name).main(**kw)


# ------------------------------------------------- carried-across parity


def _vit_cfgs(image_size):
    kw = dict(img_size=image_size, patch_size=16, embed_dim=64, depth=2,
              num_heads=2, window_size=4, global_attn_indexes=(1,))
    return (jsam.SamConfig(variant="vit_b", image_size=image_size,
                           encoder_vit=jvit.SamViTConfig(**kw)),
            psam.SamConfig(variant="vit_b", image_size=image_size,
                           encoder_vit=pvit.SamViTConfig(**kw)))


def test_latency_scaleout_matches_jax(capsys):
    jcfg, cfg = _vit_cfgs(144)  # grid 9: both layout paddings execute
    jparams = jsam.init_sam(jax.random.PRNGKey(0), jcfg)
    jmod, mod = _jax_example("latency_scaleout"), _port_example("latency_scaleout")
    want = np.asarray(jmod.main(devices=jax.devices("cpu")[:4], cfg=jcfg,
                                params=jparams))
    got = mod.main(devices=[CPU] * 4, cfg=cfg,
                   params=load(psam.Sam(cfg), jparams))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)

    bjcfg, bjparams, bcfg, bmodel = slim_birefnet()
    want = np.asarray(jmod.main_birefnet(
        devices=jax.devices("cpu")[:4], bcfg=bjcfg,
        bparams=jax.tree_util.tree_map(jnp.asarray, bjparams)))
    got = mod.main_birefnet(devices=[CPU] * 4, bcfg=bcfg, bparams=bmodel)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-5)
    text = capsys.readouterr().out
    assert text.count("sp mesh: {'sp': 4}") == 2
    assert "max|sp - single|" in text and "max|spatial - single|" in text


def _recording(mod, monkeypatch, name):
    seen = []
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: seen.append(
        real(*a, **k)) or seen[-1])
    return seen


def test_distill_encoder_matches_jax(capsys, monkeypatch):
    jcfg, cfg = _vit_cfgs(64)
    jteacher = jsam.init_sam(jax.random.PRNGKey(0), jcfg)
    jmod, mod = _jax_example("distill_encoder"), _port_example("distill_encoder")
    want = _recording(jmod, monkeypatch, "teacher_embeddings")
    got = _recording(mod, monkeypatch, "teacher_embeddings")
    jmod.main(devices=jax.devices("cpu")[:4], teacher_cfg=jcfg,
              teacher=jteacher, n_steps=2)
    capsys.readouterr()
    mod.main(devices=[CPU] * 4, teacher_cfg=cfg,
             teacher=load(psam.Sam(cfg), jteacher), n_steps=2)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=2e-5, rtol=1e-4)
    text = capsys.readouterr().out
    assert "mesh: {'dp': 2, 'tp': 2}" in text
    assert "step 1: mse" in text and "grafted student serves" in text
    mse = _floats(r"step \d: mse (\S+)", text)
    assert mse[1] < mse[0]


# ------------------------------------------------------ the mesh examples


def test_streaming_frames_runs(capsys):
    _port_example("streaming_frames").main(image_size=64, devices=[CPU] * 8)
    text = capsys.readouterr().out
    assert "mesh: {'dp': 4, 'tp': 2} over 8 devices" in text
    assert "embeddings: (8, 4, 4, 256)" in text
    assert "masks: (6," in text


def test_finetune_decoder_runs_resumes_and_serves_both_packages(
        tmp_path, capsys, png):
    mod = _port_example("finetune_decoder")
    models = tmp_path / "models"
    bundle = models / "segmentation" / "mobile_sam.npz"
    mod.main(argv=[str(tmp_path / "ckpts")], bundle_out=str(bundle),
             n_steps=2, devices=[CPU] * 8)
    assert bundle.exists()
    text = capsys.readouterr().out
    assert "step 1: loss" in text and "exported serving bundle" in text
    # Resume path: a second run restores from the checkpoint just written.
    mod.main(argv=[str(tmp_path / "ckpts")], bundle_out=str(bundle),
             n_steps=1, devices=[CPU] * 8)
    assert "resumed from step 2" in capsys.readouterr().out

    je = jdl.Environment(_options(jdl, models))
    pe = pdl.Environment(_options(pdl, models))
    js = jdl.Segmentation.process(jdl.Image.load(png), je)
    ps = pdl.Segmentation.process(pdl.Image.load(png), pe)
    for prompt, jprompt in ((pdl.Point(30, 20), jdl.Point(30, 20)),
                            (pdl.Region(pdl.Point(5, 6), pdl.Point(60, 40)),
                             jdl.Region(jdl.Point(5, 6), jdl.Point(60, 40)))):
        got = ps.compute_mask(prompt).pixels
        want = js.compute_mask(jprompt).pixels
        flips = got[..., 0] != want[..., 0]
        if flips.any():
            near = np.abs(_jax_logits(je, js, jprompt)[0][flips]) <= NEAR_ZERO
            assert near.all(), f"{int((~near).sum())} pixels flipped"


def test_multihost_train_runs(tmp_path, capsys):
    ckpt = tmp_path / "mh_ckpts"
    _port_example("multihost_train").main(argv=[str(ckpt)], n_steps=2,
                                          devices=[CPU] * 8)
    text = capsys.readouterr().out
    assert "rank 0: mesh {'dp': 4, 'tp': 2} over 8 devices / 1 processes" in text
    assert "step 1: loss" in text and "collective checkpoint" in text
    assert (ckpt / "step_2").exists()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_multihost_train_two_gloo_processes(tmp_path):
    """Two ranks of 4 CPU devices each: dp crosses the processes (one
    all-reduce a step), so both print the same global losses."""
    port = _free_port()
    code = ("import sys, torch\n"
            "from dlimgedit_tpu_torch.examples.multihost_train import main\n"
            "main(sys.argv[1:], n_steps=2, devices=[torch.device('cpu')] * 4)\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(tmp_path / "ckpt"), "--coordinator",
         f"localhost:{port}", "--num-processes", "2", "--process-id", str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost_train workers timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-4000:]
        assert (f"rank {pid}: mesh {{'dp': 4, 'tp': 2}} over 8 devices / 2 "
                f"processes") in out, out[-4000:]
        assert f"rank {pid}: collective checkpoint at step 2" in out
    losses = [_floats(r"rank \d step \d: loss (\S+)", out) for out in outs]
    assert len(losses[0]) == 2 and losses[0] == losses[1], losses
    assert (tmp_path / "ckpt" / "step_2").exists()
