"""The port's device-memory tool (dlimgedit_tpu_torch/tools/memory_footprint.py)
on the CPU, against the JAX package's (tools/memory_footprint.py, loaded
by spec, unedited).

  * a hermetic run (``--backend cpu``, SAM and BiRefNet at 64): one row
    per phase, automatic mask generation included, every device meter
    n/a;
  * a run with the meter stubbed: a scripted sequence of allocated,
    reserved and driver readings, peaks and graph-pool bytes (one pool id
    found in no segment), held row by row, with the resident, peak and
    reserved totals and the fallback line;
  * the analytic bytes (MobileSAM's and BiRefNet's weights, the
    embedding) equal the JAX tool's ``_pytree_bytes`` of the same
    options, in float32;
  * ``--backend gpu`` without a CUDA device raises: no fallback.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import dlimgedit_tpu as jdl
import dlimgedit_tpu_torch as pdl
from dlimgedit_tpu_torch.runtime.environment import Executable
from dlimgedit_tpu_torch.tools import memory_footprint as mf

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ARGV = ["--backend", "cpu", "--sam-image-size", "64",
        "--birefnet-resolution", "64", "--size", "64"]
PHASES = ["environment", "mobile_sam weights", "process",
          "compute_mask (a click)", "generate_masks (grid 32)",
          "BiRefNet weights", "segment_objects"]
MB = 1 << 20


@pytest.fixture
def small(monkeypatch):
    """The tool writes DLIMG_BIREFNET_RESOLUTION: put it back after."""
    monkeypatch.setenv("DLIMG_BIREFNET_RESOLUTION", "64")
    monkeypatch.setenv("DLIMG_BIREFNET_TEST_SLIM", "1")


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_memory_footprint", ROOT / "tools" / "memory_footprint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hermetic_cpu_run_prints_every_phase(small, capsys):
    fp = mf.main(ARGV)
    text = capsys.readouterr().out
    assert [r.name for r in fp.rows] == PHASES
    for name in PHASES:
        line = next(ln for ln in text.splitlines() if ln.startswith(name))
        assert line.split()[len(name.split()):][:4] == ["n/a"] * 4, line
    assert fp.device == "cpu"
    assert "resident (memory_allocated after the pipeline): n/a" in text
    assert "driver used" in text and "~500 MB" in text
    # The executables of every program the pipeline ran, graphless here.
    kinds = {key[0] for key in fp.pools}
    assert {"embed", "decode", "amg", "birefnet"} <= kinds
    assert all(n == 0 and b is None for n, b in fp.pools.values())
    assert fp.row("process").keys[0][0] == "embed"


class ScriptedMeter:
    """Readings from a script, in the order the tool takes them."""

    def __init__(self, readings, peaks, pools):
        self.readings, self.peaks, self.pools = (list(readings), list(peaks),
                                                 list(pools))
        self.resets = 0

    def read(self):
        return mf.Reading(*self.readings.pop(0))

    def reset_peak(self):
        self.resets += 1

    def peak(self):
        return self.peaks.pop(0)

    def pool_bytes(self, graphs):
        assert graphs == ("graph",)
        return self.pools.pop(0)


def test_stubbed_meter_rows_and_totals(small, capsys, monkeypatch):
    monkeypatch.setattr(Executable, "graphs", property(lambda self: ("graph",)))
    # allocated, reserved, driver in MB: a baseline, then (before, after)
    # per phase, then the final reading.
    a = [10, 10, 12, 50, 52, 60, 60, 61, 61, 65, 65, 80, 80, 90]
    readings = [(10 * MB, 20 * MB, 500 * MB)]
    for i in range(0, len(a), 2):
        readings.append((a[i] * MB, 2 * a[i] * MB, 500 * MB + a[i] * MB))
        readings.append((a[i + 1] * MB, 2 * a[i + 1] * MB,
                         500 * MB + 3 * a[i + 1] * MB))
    readings.append((90 * MB, 180 * MB, 800 * MB))
    peaks = [(a[i] + 5) * MB for i in range(0, len(a), 2)]
    pools = [4 * MB, None, 6 * MB, 8 * MB]  # embed, decode, amg, birefnet
    meter = ScriptedMeter(readings, peaks, pools)
    fp = mf.main(ARGV, meter=meter)
    text = capsys.readouterr().out
    assert meter.resets == len(PHASES) and not meter.readings
    assert not meter.peaks and not meter.pools
    for k, r in enumerate(fp.rows):
        before, after = a[2 * k], a[2 * k + 1]
        assert r.allocated == (after - before) * MB
        assert r.reserved == 2 * (after - before) * MB
        assert r.driver == (3 * after - before) * MB
        assert r.peak == 5 * MB
    assert fp.peak == (80 + 5) * MB
    assert fp.final == mf.Reading(90 * MB, 180 * MB, 800 * MB)
    assert not fp.pools_matched
    assert [b for _, b in fp.pools.values()] == pools
    assert "resident (memory_allocated after the pipeline): 90.000 MB" in text
    assert "peak (max_memory_allocated over the phases): 85.000 MB" in text
    assert "reserved (the allocator's, every graph pool included): 180.000 MB" in text
    assert re.search(r"driver used .*: 800\.000 MB", text)
    # The decode's pool id is in no segment: the reserved delta of the
    # phase that captured it stands in, and says so.
    line = next(ln for ln in text.splitlines() if ln.strip().startswith("decode/"))
    assert "pool id in no snapshot segment" in line
    assert "'compute_mask (a click)'" in line and "2.000 MB" in line
    line = next(ln for ln in text.splitlines() if ln.strip().startswith("embed/"))
    assert line.endswith("4.000 MB")
    row = next(ln for ln in text.splitlines() if ln.startswith("process"))
    assert row.split()[1:5] == ["8.000", "MB", "16.000", "MB"]


def test_analytic_bytes_equal_the_jax_tools(small):
    jtool = _jax_tool()
    fp = mf.main(ARGV)
    je = jdl.Environment(jdl.Options(
        backend=jdl.Backend.cpu, allow_random_weights=True,
        compute_dtype="float32", sam_image_size=64))
    img = jdl.Image(jdl.Extent(64, 64), jdl.Channels.rgba,
                    np.random.default_rng(0).integers(0, 256, (64, 64, 4),
                                                      dtype=np.uint8))
    seg = jdl.Segmentation.process(img, je)
    assert fp.row("mobile_sam weights").analytic == jtool._pytree_bytes(
        je.sam_model("mobile_sam").params)
    assert fp.row("process").analytic == jtool._pytree_bytes(seg.embedding)
    assert fp.row("BiRefNet weights").analytic == jtool._pytree_bytes(
        je.birefnet_model("general").params)
    # The index buffers stay out of the weights' column and are named.
    assert "index buffers" in fp.row("mobile_sam weights").note


def test_gpu_backend_raises_without_cuda(small, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(pdl.DlimgError, match="needs a CUDA device"):
        mf.main(["--sam-image-size", "64", "--size", "64"])
    with pytest.raises(pdl.DlimgError, match="needs a CUDA device"):
        mf.main([])
