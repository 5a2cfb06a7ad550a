"""The port's ``dlimg-serve`` (dlimgedit_tpu_torch/native/tools/serve.cpp,
built by dlimgedit_tpu_torch/native_build.py) on the CPU, in float32, at
sam_image_size 64 on JAX's seed-0 ``init_sam`` bundle, with seeded random
slim BiRefNet weights and a 4 x 4 AMG grid.

One daemon for the module, as tests/test_serve.py runs the JAX package's:
``--threads 4 --max-sessions 2 --batch-window-ms 100``, driven over real
sockets. It covers sessions, point, box and ``all=1`` queries,
``/auto-masks``, ``/v1/segment``, ``/remove-bg``, LRU eviction,
concurrency 4 through the batch window, keep-alive and the error paths of
tests/test_serve.py. Every served mask equals the port's Python API's
byte for byte (the call the daemon makes: the batch window sends a point
or a box through ``compute_mask_batch``; at concurrency 4 the batch a
query rode in is not known, so its mask must be one of the port's batches
of 1, 2 or 4), and JAX's under tests/test_torch_native_bridge.py's tie
rule (equal except where JAX's logit is within 1e-4 of zero).
"""

import base64
import io
import json
import os
import signal
import socket
import subprocess
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

import dlimgedit_tpu as jdl
import dlimgedit_tpu_torch as pdl
from dlimgedit_tpu.models import sam as jax_sam
from dlimgedit_tpu.utils.pytree_io import save_pytree
from dlimgedit_tpu_torch import native_build

from test_torch_segmentation import _assert_mask_matches, _jax_logits

SAM_SIZE = 64
SERVE_VARS = {
    "DLIMG_ALLOW_RANDOM_WEIGHTS": "1",  # BiRefNet: seeded random slim weights
    "DLIMG_SAM_IMAGE_SIZE": str(SAM_SIZE),
    "DLIMG_COMPUTE_DTYPE": "float32",
    "DLIMG_AMG_GRID": "4",
    "DLIMG_BIREFNET_TEST_SLIM": "1",
    "DLIMG_BIREFNET_RESOLUTION": "64",
}
UNSET = ("DLIMG_SAM_VARIANT", "DLIMG_COMPILATION_CACHE",
         "DLIMG_SCALEOUT_DEVICES", "DLIMG_PJRT_BUNDLE", "PYTHONPATH")
H, W = 48, 64
POINTS = ((32, 24), (20, 20), (48, 30), (10, 40))
BOXES = ((16, 10, 50, 38), (2, 2, 30, 30))


def _image(shade: int = 0) -> np.ndarray:
    rgb = np.random.default_rng(7).integers(0, 256, (H, W, 3), dtype=np.uint8)
    rgb[10:38, 16:50] = [200, 40, 40]
    rgb[:4, :4] = shade
    return rgb


def _png_bytes(arr) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _decode_png(data) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    (d / "segmentation").mkdir()
    params = jax_sam.init_sam(jax.random.PRNGKey(0),
                              jax_sam.make_config("mobile_sam", SAM_SIZE))
    save_pytree(d / "segmentation" / "mobile_sam.npz",
                jax.tree_util.tree_map(np.asarray, params))
    return d


@pytest.fixture(scope="module")
def server(model_dir, tmp_path_factory):
    if native_build.compiler() is None:
        pytest.skip("no C++ compiler installed")
    exe = native_build.build().executable("dlimg-serve")
    env = {k: v for k, v in os.environ.items() if k not in UNSET}
    env.update(SERVE_VARS)
    env["TMPDIR"] = str(tmp_path_factory.mktemp("serve-tmp"))
    proc = subprocess.Popen(
        [str(exe), "--port", "0", "--backend", "cpu", "--models",
         str(model_dir), "--threads", "4", "--max-sessions", "2",
         "--batch-window-ms", "100"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port = _read_port(proc)
        yield f"http://127.0.0.1:{port}", proc
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _read_port(proc) -> int:
    """The bound port from the startup line; then a thread drains the
    daemon's output, which must never block on a full pipe (the embedded
    interpreter writes to it holding the GIL: tests/test_serve.py)."""
    deadline = time.time() + 120
    while time.time() < deadline:
        line = proc.stdout.readline()
        if "listening on" in line:
            threading.Thread(target=proc.stdout.read, daemon=True).start()
            return int(line.split(":")[-1].split()[0])
        if proc.poll() is not None:
            raise RuntimeError(f"dlimg-serve exited: {line}")
    raise RuntimeError("dlimg-serve never printed its port")


def _req(base, method, path, data=None, timeout=300):
    r = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(r, timeout=timeout) as resp:
            return resp.status, resp.read(), resp.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


@pytest.fixture(scope="module")
def direct(model_dir):
    """The port's Python API with the daemon's options, and JAX's."""
    penv = pdl.Environment(pdl.Options(
        backend=pdl.Backend.cpu, model_directory=str(model_dir),
        allow_random_weights=True, sam_image_size=SAM_SIZE,
        compute_dtype="float32"))
    jenv = jdl.Environment(jdl.Options(
        backend=jdl.Backend.cpu, model_directory=str(model_dir),
        sam_image_size=SAM_SIZE, compute_dtype="float32"))
    rgb = _image()
    pseg = pdl.Segmentation.process(
        pdl.ImageView(rgb, pdl.Extent(W, H), pdl.Channels.rgb), penv)
    jseg = jdl.Segmentation.process(
        jdl.ImageView(rgb, jdl.Extent(W, H), jdl.Channels.rgb), jenv)
    return penv, pseg, jenv, jseg


def _session(base, rgb=None) -> str:
    st, body, _ = _req(base, "POST", "/v1/sessions", _png_bytes(
        _image() if rgb is None else rgb))
    assert st == 200, body
    meta = json.loads(body)
    assert (meta["width"], meta["height"]) == (W, H)
    return meta["id"]


def _query(v) -> str:
    return (f"box={v[0]},{v[1]},{v[2]},{v[3]}" if len(v) == 4
            else f"point={v[0]},{v[1]}")


def _prompts(v):
    if len(v) == 4:
        return (pdl.Region(pdl.Point(*v[:2]), pdl.Point(*v[2:])),
                jdl.Region(jdl.Point(*v[:2]), jdl.Point(*v[2:])))
    return pdl.Point(*v), jdl.Point(*v)


def _batched(pseg, prompt, n: int) -> np.ndarray:
    """The prompt's mask out of the port's batch of n (the daemon's
    ``compute_mask_batch``; n - 1 copies of it ride along)."""
    return pseg.compute_mask_batch([prompt] * n)[0].image.pixels.reshape(H, W)


def _hold(mask, v, direct, sizes=(1,)) -> None:
    penv, pseg, jenv, jseg = direct
    pp, jp = _prompts(v)
    assert mask.shape == (H, W) and mask.dtype == np.uint8
    assert any(np.array_equal(mask, _batched(pseg, pp, n)) for n in sizes), v
    _assert_mask_matches(mask[..., None],
                         jseg.compute_mask(jp).pixels.reshape(H, W, 1),
                         lambda: _jax_logits(jenv, jseg, jp)[0])


def test_info_reports_the_ports_mode(server):
    base, _ = server
    st, body, _ = _req(base, "GET", "/healthz")
    assert (st, body) == (200, b"ok")
    st, body, ct = _req(base, "GET", "/v1/info")
    assert st == 200 and ct == "application/json"
    info = json.loads(body)
    assert set(info) == {"backend", "mode", "sessions", "max_sessions"}
    assert (info["backend"], info["mode"], info["max_sessions"]) == (
        "cpu", "embedded-python-pytorch", 2)


def test_point_and_box_queries_match_the_python_api(server, direct):
    base, _ = server
    sid = _session(base)
    for v in (*POINTS, *BOXES):
        st, body, ct = _req(base, "POST", f"/v1/sessions/{sid}/mask?{_query(v)}")
        assert st == 200 and ct == "image/png", body
        _hold(_decode_png(body), v, direct)
    _req(base, "DELETE", f"/v1/sessions/{sid}")


def test_all_three_masks_match_the_python_api(server, direct):
    base, _ = server
    penv, pseg, jenv, jseg = direct
    sid = _session(base)
    st, body, _ = _req(base, "POST", f"/v1/sessions/{sid}/mask?point=32,24&all=1")
    assert st == 200
    served = json.loads(body)["masks"]
    want = pseg.compute_masks(pdl.Point(32, 24))
    jwant = jseg.compute_masks(jdl.Point(32, 24))
    logits = _jax_logits(jenv, jseg, jdl.Point(32, 24), multimask=True)
    assert len(served) == 3
    for i, (s, w, jw) in enumerate(zip(served, want, jwant)):
        mask = _decode_png(base64.b64decode(s["png_base64"]))
        np.testing.assert_array_equal(mask, w.image.pixels.reshape(H, W))
        assert abs(s["accuracy"] - w.accuracy) <= 5e-5  # printed as %.4f
        _assert_mask_matches(mask[..., None],
                             jw.image.pixels.reshape(H, W, 1),
                             lambda i=i: logits[i])
    _req(base, "DELETE", f"/v1/sessions/{sid}")


def test_auto_masks_match_the_python_api(server, direct):
    base, _ = server
    pseg = direct[1]
    sid = _session(base)
    st, body, ct = _req(
        base, "POST",
        f"/v1/sessions/{sid}/auto-masks?iou=0.0&stability=0.0&nms=0.7&max=4")
    assert st == 200 and ct == "application/json", body
    served = json.loads(body)["masks"]
    want = pseg.generate_masks(grid=4, max_masks=4, iou_thresh=0.0,
                               stability_thresh=0.0, nms_thresh=0.7)
    assert 1 <= len(served) == len(want)
    for s, w in zip(served, want):
        np.testing.assert_array_equal(
            _decode_png(base64.b64decode(s["png_base64"])),
            w.image.pixels.reshape(H, W))
        assert abs(s["accuracy"] - w.accuracy) <= 5e-5
    st, _, _ = _req(base, "POST", f"/v1/sessions/{sid}/auto-masks?max=0")
    assert st == 400
    _req(base, "DELETE", f"/v1/sessions/{sid}")


def test_one_shot_segment_and_remove_bg(server, direct, monkeypatch):
    base, _ = server
    penv, pseg = direct[:2]
    monkeypatch.setenv("DLIMG_BIREFNET_RESOLUTION",
                       SERVE_VARS["DLIMG_BIREFNET_RESOLUTION"])
    monkeypatch.setenv("DLIMG_BIREFNET_TEST_SLIM", "1")
    png = _png_bytes(_image())
    st, body, ct = _req(base, "POST", "/v1/segment?point=32,24", png)
    assert st == 200 and ct == "image/png"
    np.testing.assert_array_equal(  # one-shot: process + compute_mask
        _decode_png(body), pseg.compute_mask(pdl.Point(32, 24)).pixels.reshape(H, W))
    st, body, ct = _req(base, "POST", "/v1/remove-bg", png)
    assert st == 200 and ct == "image/png", body
    want = pdl.segment_objects(
        pdl.ImageView(_image(), pdl.Extent(W, H), pdl.Channels.rgb), penv)
    mask = _decode_png(body)
    np.testing.assert_array_equal(mask, want.pixels.reshape(H, W))
    st, body, _ = _req(base, "POST", "/v1/remove-bg?cutout=1", png)
    assert st == 200
    cut = _decode_png(body)
    np.testing.assert_array_equal(cut[:, :, 3], mask)
    np.testing.assert_array_equal(cut[:, :, :3], _image())


def test_concurrency_4_rides_the_batch_window(server, direct):
    """16 queries from 4 clients on one session: each mask is the port's
    for its prompt, and the window grouped some of them."""
    base, _ = server
    sid = _session(base)
    st, body, _ = _req(base, "GET", "/v1/stats")
    before = json.loads(body)
    queries = [POINTS[i % len(POINTS)] if i % 4 else BOXES[i % 2]
               for i in range(16)]

    def ask(v):
        st, body, _ = _req(base, "POST", f"/v1/sessions/{sid}/mask?{_query(v)}")
        assert st == 200, body
        return _decode_png(body)

    with ThreadPoolExecutor(4) as pool:
        masks = list(pool.map(ask, queries))
    for v, mask in zip(queries, masks):
        _hold(mask, v, direct, sizes=(1, 2, 4))
    st, body, _ = _req(base, "GET", "/v1/stats")
    stats = json.loads(body)
    assert stats["batched_calls"] > before["batched_calls"]
    assert stats["batched_prompts"] - before["batched_prompts"] == 16
    assert stats["largest_batch"] >= 2
    _req(base, "DELETE", f"/v1/sessions/{sid}")


def test_lru_eviction(server):
    base, _ = server
    ids = [_session(base, _image(shade)) for shade in (60, 120, 180)]
    st, _, _ = _req(base, "POST", f"/v1/sessions/{ids[0]}/mask?point=5,5")
    assert st == 404  # evicted: --max-sessions 2
    for sid in ids[1:]:
        st, _, _ = _req(base, "POST", f"/v1/sessions/{sid}/mask?point=5,5")
        assert st == 200
        st, _, _ = _req(base, "DELETE", f"/v1/sessions/{sid}")
        assert st == 204
    st, _, _ = _req(base, "POST", f"/v1/sessions/{ids[1]}/mask?point=5,5")
    assert st == 404


def test_error_paths(server):
    base, _ = server
    png = _png_bytes(_image())
    st, body, _ = _req(base, "POST", "/v1/segment", png)
    assert st == 400 and b"point=" in body
    st, body, _ = _req(base, "POST", "/v1/segment?point=1,1",
                       b"not an image at all")
    assert st == 400 and "error" in json.loads(body)
    st, _, _ = _req(base, "POST", "/v1/sessions", b"")
    assert st == 400
    st, _, _ = _req(base, "GET", "/v1/nonsense")
    assert st == 404
    st, _, _ = _req(base, "GET", "/v1/sessions")
    assert st == 405
    st, _, _ = _req(base, "POST", "/v1/sessions/deadbeef/mask?point=1,1")
    assert st == 404
    sid = _session(base)
    st, _, _ = _req(base, "POST", f"/v1/sessions/{sid}/mask?box=1,2,3,4&all=1")
    assert st == 400
    _req(base, "DELETE", f"/v1/sessions/{sid}")


def test_stats_collapse_session_ids(server):
    base, _ = server
    sid = _session(base)
    assert _req(base, "POST", f"/v1/sessions/{sid}/mask?point=3,3")[0] == 200
    _req(base, "DELETE", f"/v1/sessions/{sid}")
    st, body, _ = _req(base, "GET", "/v1/stats")
    stats = json.loads(body)
    assert stats["uptime_s"] > 0
    entry = stats["endpoints"]["POST /v1/sessions/<id>/mask"]
    assert entry["count"] >= 1 and entry["p95_ms"] >= entry["p50_ms"] >= 0
    assert not any(sid in k for k in stats["endpoints"])


def _recv_response(sock, buf=b""):
    while b"\r\n\r\n" not in buf:
        buf += sock.recv(65536)
    head, rest = buf.split(b"\r\n\r\n", 1)
    length = 0
    for line in head.split(b"\r\n"):
        if line.lower().startswith(b"content-length:"):
            length = int(line.split(b":")[1])
    while len(rest) < length:
        rest += sock.recv(65536)
    return head, rest[:length], rest[length:]


def test_keep_alive_and_pipelining(server):
    import http.client

    base, _ = server
    host, port = base.split("//")[1].split(":")
    with socket.create_connection((host, int(port)), timeout=60) as sock:
        sock.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
        head, body, extra = _recv_response(sock)
        assert body == b"ok" and b"connection: keep-alive" in head.lower()
        sock.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n"
                     b"GET /v1/info HTTP/1.1\r\nHost: x\r\n\r\n")
        head, body, extra = _recv_response(sock, extra)
        assert body == b"ok"
        head, body, extra = _recv_response(sock, extra)
        assert json.loads(body)["mode"] == "embedded-python-pytorch"
        sock.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n"
                     b"Connection: close\r\n\r\n")
        head, body, extra = _recv_response(sock, extra)
        assert body == b"ok" and b"connection: close" in head.lower()
        assert sock.recv(1) == b""
    with socket.create_connection((host, int(port)), timeout=60) as sock:
        sock.sendall(b"GET /healthz HTTP/1.0\r\nHost: x\r\n\r\n")
        head, body, _ = _recv_response(sock)
        assert body == b"ok" and b"connection: close" in head.lower()
        assert sock.recv(1) == b""
    conn = http.client.HTTPConnection(f"{host}:{port}", timeout=60)
    closes = []
    for i in range(1001):  # the 1000th response on a connection says close
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        assert resp.status == 200
        resp.read()
        if (resp.getheader("Connection") or "").lower() == "close":
            closes.append(i)
    conn.close()
    assert closes == [999]
