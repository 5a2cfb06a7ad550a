"""The port's ``dlimg-serve`` and ``dlimg`` on the Python-free serving route
(DLIMG_PJRT_BUNDLE), on the CPU, in float32: the port's counterpart of
tests/test_serve.py's bundle-mode tests and tests/test_cli.py's
``dlimg info``.

One bundle of the port's exporter: MobileSAM at sam_image_size 64 (JAX's
seed-0 tree) in canvas bucket 256, ``--batch-sizes 2``, ``--amg 4:8`` and
``--birefnet general:256`` with a slim BiRefNet (nonzero offsets, shifted
windows) injected into the exporting environment, which is also the
reference: the port's Python API. The daemon runs with ``--threads 3
--batch-window-ms 300`` in a fresh process whose interpreter, if one
started, would leave a marker file; PNGs go in and out through the port's
own codec.

- ``/v1/info`` and the startup line say ``pytorch-bundle``.
- A PNG session; point and box clicks whose PNGs decode to the Python
  API's masks byte for byte; ``all=1`` with 3 masks and their accuracies.
- Three concurrent clicks ride ``serve_decode_batch2`` (3 prompts over
  batches of 2: a padded second call): ``largest_batch >= 2``, each mask
  equal to the direct call's.
- ``/auto-masks`` equal to ``generate_masks``, ``/v1/segment`` equal to a
  one-shot ``process`` and click, ``/v1/remove-bg`` within 1 quantum of
  ``segment_objects``.
- ``dlimg segment``, ``remove-bg`` and ``segment-all`` write the same masks;
  ``dlimg info`` reports the bundle's rows, and ``backend gpu: unavailable``
  for a directory that is no bundle.
"""

import base64
import io
import json
import signal
import subprocess
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dlimgedit_tpu_torch import (Channels, Extent, Image, Point, Region,
                                 Segmentation, native_build, segment_objects)
from dlimgedit_tpu_torch.models import birefnet as bn
from dlimgedit_tpu_torch.models.birefnet import seed_nonzero_init
from dlimgedit_tpu_torch.runtime import birefnet as prbn
from dlimgedit_tpu_torch.tools import aot_export, serving_check

from test_torch_native_bridge import IMAGE_SIZE, model_dir  # noqa: F401
from test_torch_serving_birefnet import RESOLUTION, _configs

torch.set_num_threads(2)

SIZE = 256
W, H = 256, 192  # canvas bucket 256
GRID, SLOTS = 4, 8
THRESHOLDS = dict(iou=0.0, stability=0.0, nms=1.0)
POINT, BOX = (100, 80), (40, 30, 200, 150)
BURST = ((100, 80), (30, 150), (220, 20))


def _image() -> np.ndarray:
    rgb = np.random.default_rng(22).integers(0, 256, (H, W, 3), dtype=np.uint8)
    rgb[40:150, 60:190] = (200, 40, 40)
    return rgb


def _png(arr) -> bytes:
    from PIL import Image as PILImage

    buf = io.BytesIO()
    PILImage.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _decode(data: bytes) -> np.ndarray:
    from PIL import Image as PILImage

    return np.asarray(PILImage.open(io.BytesIO(data)))


def _prompt(v):
    return Region(Point(*v[:2]), Point(*v[2:])) if len(v) == 4 else Point(*v)


@pytest.fixture(scope="module")
def build():
    if native_build.compiler() is None:
        pytest.skip("no C++ compiler installed")
    return native_build.build_serving()


@pytest.fixture(scope="module")
def served(tmp_path_factory, model_dir, build):  # noqa: F811
    """The bundle, its exporting environment (the reference) and the
    direct calls' results on the session image."""
    work = tmp_path_factory.mktemp("serve-bundle")
    args = serving_check.bundle_args(
        work / "bundle", SIZE, "cpu", IMAGE_SIZE, "float32", str(model_dir),
        batch_sizes="2", amg=f"{GRID}:{SLOTS}", birefnet=f"general:{SIZE}")
    env = aot_export.make_environment(args)
    cfg = _configs()[1]
    torch.manual_seed(0)
    model = bn.BiRefNet(cfg)
    seed_nonzero_init(model, seed=3)
    b = prbn.BiRefNetBundle(cfg, model, torch.float32, RESOLUTION)
    assert env._birefnet_models["general"].get_or_create(lambda: b) is b
    aot_export.export_serving(args, env=env)
    rgb = _image()
    img = Image(Extent(W, H), Channels.rgb, rgb)
    seg = Segmentation.process(img, env)
    return {"work": work, "bundle": work / "bundle", "env": env, "rgb": rgb,
            "seg": seg, "objects": segment_objects(img, env).pixels.reshape(
                H, W)}


def _mask(seg, v) -> np.ndarray:
    return seg.compute_mask(_prompt(v)).pixels.reshape(H, W)


@pytest.fixture(scope="module")
def daemon(served, build):
    work = served["work"]
    env = serving_check.fresh_env(work, DLIMG_PJRT_BUNDLE=str(served["bundle"]),
                                  TMPDIR=str(work))
    proc = subprocess.Popen(
        [str(build.executable("dlimg-serve")), "--port", "0", "--backend",
         "cpu", "--threads", "3", "--batch-window-ms", "300"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline, line = time.time() + 120, ""
        while time.time() < deadline and "listening on" not in line:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                raise RuntimeError("dlimg-serve exited before it listened")
        assert "listening on" in line, line
        threading.Thread(target=proc.stdout.read, daemon=True).start()
        yield f"http://127.0.0.1:{int(line.split(':')[-1].split()[0])}", line
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            assert proc.wait(timeout=30) == 0
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise


def _req(base, method, path, data=None):
    r = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(r, timeout=300) as resp:
            return resp.status, resp.read(), resp.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def _ok(base, method, path, data=None):
    st, body, ct = _req(base, method, path, data)
    assert st == 200, body
    return body, ct


def _session(base, rgb) -> str:
    body, _ = _ok(base, "POST", "/v1/sessions", _png(rgb))
    meta = json.loads(body)
    assert (meta["width"], meta["height"]) == (W, H)
    return meta["id"]


def _click(base, sid, v) -> bytes:
    q = (f"box={v[0]},{v[1]},{v[2]},{v[3]}" if len(v) == 4
         else f"point={v[0]},{v[1]}")
    body, ct = _ok(base, "POST", f"/v1/sessions/{sid}/mask?{q}")
    assert ct == "image/png"
    return body


def test_info_reports_the_bundle_mode(daemon, served):
    base, line = daemon
    assert line.rstrip().endswith("backend=cpu mode=pytorch-bundle"), line
    info = json.loads(_ok(base, "GET", "/v1/info")[0])
    assert (info["backend"], info["mode"]) == ("cpu", "pytorch-bundle")
    assert not (served["work"] / serving_check.MARKER).exists()


def test_a_png_session_answers_clicks_like_the_python_api(daemon, served):
    base, _ = daemon
    seg = served["seg"]
    sid = _session(base, served["rgb"])
    for v in (POINT, BOX):
        np.testing.assert_array_equal(_decode(_click(base, sid, v)),
                                      _mask(seg, v))
    body, _ = _ok(base, "POST", f"/v1/sessions/{sid}/mask?point="
                                f"{POINT[0]},{POINT[1]}&all=1")
    masks = json.loads(body)["masks"]
    want = seg.compute_masks(Point(*POINT))
    assert len(masks) == 3
    for s, m in zip(masks, want):
        np.testing.assert_array_equal(
            _decode(base64.b64decode(s["png_base64"])),
            m.image.pixels.reshape(H, W))
        assert abs(s["accuracy"] - m.accuracy) <= 5e-5  # printed as %.4f
    assert _req(base, "DELETE", f"/v1/sessions/{sid}")[0] == 204


def test_concurrent_clicks_ride_the_batch_program(daemon, served):
    base, _ = daemon
    seg = served["seg"]
    sid = _session(base, served["rgb"])
    before = json.loads(_ok(base, "GET", "/v1/stats")[0])
    results, errors = {}, []

    def click(v):
        try:
            results[v] = _click(base, sid, v)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=click, args=(v,)) for v in BURST]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    stats = json.loads(_ok(base, "GET", "/v1/stats")[0])
    assert stats["largest_batch"] >= 2, stats
    assert stats["batched_prompts"] - before["batched_prompts"] == len(BURST)
    for v in BURST:
        np.testing.assert_array_equal(_decode(results[v]), _mask(seg, v))
    assert _req(base, "DELETE", f"/v1/sessions/{sid}")[0] == 204


def test_auto_masks_segment_and_remove_bg(daemon, served):
    base, _ = daemon
    seg, rgb = served["seg"], served["rgb"]
    sid = _session(base, rgb)
    body, _ = _ok(base, "POST", f"/v1/sessions/{sid}/auto-masks?iou="
                                f"{THRESHOLDS['iou']}&stability="
                                f"{THRESHOLDS['stability']}&nms="
                                f"{THRESHOLDS['nms']}&max={SLOTS}")
    auto = json.loads(body)["masks"]
    want = seg.generate_masks(grid=GRID, max_masks=SLOTS,
                              iou_thresh=THRESHOLDS["iou"],
                              stability_thresh=THRESHOLDS["stability"],
                              nms_thresh=THRESHOLDS["nms"])
    assert len(auto) == len(want) >= 2
    for s, m in zip(auto, want):
        np.testing.assert_array_equal(
            _decode(base64.b64decode(s["png_base64"])),
            m.image.pixels.reshape(H, W))
    body, ct = _ok(base, "POST", f"/v1/segment?point={POINT[0]},{POINT[1]}",
                   _png(rgb))
    assert ct == "image/png"
    np.testing.assert_array_equal(_decode(body), _mask(seg, POINT))
    body, _ = _ok(base, "POST", "/v1/remove-bg", _png(rgb))
    got = _decode(body).astype(int)
    assert np.abs(got - served["objects"].astype(int)).max() <= 1
    assert len(np.unique(got)) > 2  # a grey-level mask
    assert not (served["work"] / serving_check.MARKER).exists()


CLI = {
    "segment": (["--point", f"{POINT[0]},{POINT[1]}", "-o", "seg.png"],
                ["seg.png"]),
    "remove-bg": (["-o", "bg.png"], ["bg.png"]),
    "segment-all": (["--max-masks", str(SLOTS), "--iou", "0",
                     "--stability", "0", "--nms", "1", "-o", "obj.png"],
                    [f"obj_{i}.png" for i in range(SLOTS)]),
}


@pytest.fixture(scope="module")
def cli_runs(served, build):
    """The three commands, run at once, each a fresh process."""
    work = served["work"] / "cli"
    work.mkdir()
    (work / "in.png").write_bytes(_png(served["rgb"]))
    env = serving_check.fresh_env(work, DLIMG_PJRT_BUNDLE=str(served["bundle"]),
                                  TMPDIR=str(work))
    procs = {name: subprocess.Popen(
        [str(build.executable("dlimg")), name, "in.png", "--backend", "cpu",
         *args], cwd=work, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, (args, _) in CLI.items()}
    runs = {name: (p, *p.communicate(timeout=300))
            for name, p in procs.items()}
    return work, runs


@pytest.mark.parametrize("name", list(CLI))
def test_the_cli_writes_the_python_apis_masks(cli_runs, served, name):
    work, runs = cli_runs
    proc, out, err = runs[name]
    assert proc.returncode == 0, err[-2000:]
    files = CLI[name][1]
    seg = served["seg"]
    if name == "segment":
        np.testing.assert_array_equal(_decode((work / files[0]).read_bytes()),
                                      _mask(seg, POINT))
    elif name == "remove-bg":
        got = _decode((work / files[0]).read_bytes()).astype(int)
        assert np.abs(got - served["objects"].astype(int)).max() <= 1
    else:
        want = seg.generate_masks(grid=GRID, max_masks=SLOTS, iou_thresh=0.0,
                                  stability_thresh=0.0, nms_thresh=1.0)
        assert len(want) == SLOTS
        for f, m in zip(files, want):
            np.testing.assert_array_equal(_decode((work / f).read_bytes()),
                                          m.image.pixels.reshape(H, W))
            assert f"{f} accuracy={m.accuracy:.4f}" in out
    assert not (work / serving_check.MARKER).exists()


def test_dlimg_info_reports_the_bundle(served, build, tmp_path):
    exe = str(build.executable("dlimg"))
    env = serving_check.fresh_env(tmp_path,
                                  DLIMG_PJRT_BUNDLE=str(served["bundle"]))
    r = subprocess.run([exe, "info"], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    for line in ("backend cpu: supported", "backend gpu: unavailable",
                 "runtime mode: Python-free serving bundle",
                 "bundle variant: mobile_sam", "bundle batch sizes: 2",
                 f"bundle amg: grid {GRID}, {SLOTS} masks",
                 f"bundle birefnet: general:{SIZE}:{RESOLUTION}"):
        assert line in r.stdout, r.stdout
    env["DLIMG_PJRT_BUNDLE"] = str(tmp_path / "no-bundle")
    r = subprocess.run([exe, "info"], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "backend gpu: unavailable" in r.stdout
    assert "backend cpu: unavailable" in r.stdout
    assert "bundle refused" in r.stdout
    assert not (tmp_path / serving_check.MARKER).exists()
